// The beam model, the per-particle beam sum, the shared-memory staging and
// the window address math, shared by the LUT-likelihood kernel
// (lut_likelihood.cu, TPU kernels K1/K2/K3), the unique-window kernel
// (lut_dedup.cu, TPU kernels K4/K5) and the mega step (mega_step.cu, TPU
// kernel K6), so all evaluate one copy of the math.
//
// It is the TPU kernels' beam model: monte_carlo_localization_tpu/ops/
// pallas_lut.py beam_model (:400-418) with its Abramowitz & Stegun
// 7.1.26 erf (_erf, :62-74), which ops/pallas_mega.py beam_model
// (:177-195) repeats. Float32 throughout, IEEE division (build without
// --use_fast_math), constants folded from double on the host.
//
// What is tabled, and why. log p(obs | d) = log(numerator(obs, d)) -
// log(norm(d)). The normaliser (two erf, each a division and an exp, and
// a log) depends on nothing but the expected range d. The TPU's vector
// unit has no cheap per-lane table, so its kernel recomputes the
// normaliser for every beam term; a GPU has shared memory, so here a tiny
// kernel fills a table once per query, every block copies it into shared
// memory beside the scan, and a beam term reads it:
//   - integer LUT entries (K1/K2, K4/K5, K6): d is an entry clipped to m,
//     at most ceil(m) + 1 values, so the table holds {log norm(d),
//     1 / max(d, 1)} per entry (log_norm_kernel) and a term costs one exp
//     and one log;
//   - the sub-bin lerp (K3) makes d a fraction. Its table (the sub-bin
//     table, subbin_norm_kernel) holds, for every step of 1/kSubbinSteps
//     px in [0, m], the cubic Hermite segment of log norm that ends at
//     that node, anchored there: a term evaluates it in three FMAs and
//     computes the short term's reciprocal itself. A node's own value is
//     the analytic function's bits, so a whole-bin heading gives K1's
//     bits. Node 0 holds log norm(0) alone: the short term jumps there
//     (0 at d = 0, z_short (d + 1) past it), so the segment over (0, h]
//     ends at node 1 and reaches the limit from the right.
// Both tables are filled by the device function the analytic path calls
// (log_norm), written in explicit round-to-nearest and FMA intrinsics so
// that no compiler context can contract it differently: table and
// analytic path give the same bits at the nodes. A query whose m is past
// a table's cap (or, for the sub-bin table, not an integer) keeps the
// analytic normaliser: Model::kAnalytic and Model::kLerpedAnalytic.
//
// The beam sum. A particle's beams are spread over a group of kGroup
// lanes: 16 where the scan has at most 64 beams of a tabled model (two
// particles per warp, at most four terms per lane held in registers, a
// 4-step shuffle) and a whole warp otherwise (the beam loop unrolled over
// two accumulators so several LUT loads are in flight per lane). Sums
// accumulate in double, so the float32 result is the rounded sum of the
// float32 terms whatever the order, and the kernels agree with their
// plain versions to ~1 ulp; every kernel picks its group size by
// group_lanes and runs the same round loop (group_rounds), which keeps
// lut_dedup.cu bit-equal to lut_likelihood.cu.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace mcl {

constexpr int kWarp = 32;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kSmallGroup = 16;  // lanes per particle for scans of <= kSmallBeams
constexpr int kSmallBeams = 64;
constexpr int kTermsPerLane = kSmallBeams / kSmallGroup;
constexpr int kMaxTableEntries = 1024;  // 8 KB of shared memory
// Sub-bin table: nodes per pixel, and the cap, which serves the same m
// (<= 1023) as the integer table: 2 * 1023 + 1 nodes, 32 KB of shared
// memory. The step is sized by its error: a cubic Hermite segment of
// h = 1/2 px stays under a tenth of the per-term budget, so float32
// rounding sets the table's error, where a linear one misses the budget
// even at 1/16 px (tests/test_torch_subbin_table.py).
constexpr int kSubbinSteps = 2;
constexpr int kMaxSubbinEntries = 2 * (kMaxTableEntries - 1) + 1;

// How a kernel evaluates the beam model, a template argument so that no
// kernel carries a path it does not run: the normaliser from the integer
// table (K1/K2); analytic from the entry (a query whose m is past the
// table's cap); the sub-bin lerp of two entries (K3) with the normaliser
// from the sub-bin table; the same lerp with the analytic normaliser (m
// past the cap or not an integer).
enum class Model { kTabled, kAnalytic, kLerped, kLerpedAnalytic };

__host__ __device__ constexpr bool lerps(Model m) {
  return m == Model::kLerped || m == Model::kLerpedAnalytic;
}

__host__ __device__ constexpr bool reads_table(Model m) {
  return m == Model::kTabled || m == Model::kLerped;
}

inline Model model_of(bool subbin, bool has_table) {
  if (subbin) return has_table ? Model::kLerped : Model::kLerpedAnalytic;
  return has_table ? Model::kTabled : Model::kAnalytic;
}

// Lanes that share one particle's beams. An analytic term is the whole
// model, about four times a tabled term, so a short scan then keeps a
// warp per particle: two such terms deep per lane at 60 beams, not four.
inline int group_lanes(int r, Model model) {
  return r <= kSmallBeams && reads_table(model) ? kSmallGroup : kWarp;
}

// Layout of the host float array ``consts`` (LUTQuery._consts in
// ops/lut_query.py).
struct Params {
  float res, ox, oy, bin_scale, m;
  float gauss_coef, inv2s2, short2, z_short, z_max, z_rand, z_hit;
  float rand_term, sq2, inv_squash;
};
constexpr int kNumConsts = 15;

// erf(ax) for ax >= 0 by Abramowitz & Stegun 7.1.26, Horner in explicit
// FMAs, so every kernel and the tables' fills round it alike.
__device__ __forceinline__ float erf_as(float ax) {
  const float t = __frcp_rn(__fmaf_rn(0.3275911f, ax, 1.0f));
  float poly = __fmaf_rn(t, 1.061405429f, -1.453152027f);
  poly = __fmaf_rn(t, poly, 1.421413741f);
  poly = __fmaf_rn(t, poly, -0.284496736f);
  poly = __fmaf_rn(t, poly, 0.254829592f);
  poly = __fmul_rn(t, poly);
  return __fmaf_rn(-poly, expf(-__fmul_rn(ax, ax)), 1.0f);
}

// The beam model's normaliser at expected range d in [0, m], with the
// short-return term on (d > 0, or the limit from the right at d = 0) or
// off. Both erf arguments have a known sign there (m - d + 0.5 > 0 >
// -d - 0.5), so the model's erf((m - d + 0.5) / sq2) - erf((-d - 0.5) /
// sq2) is evaluated as erf(hi) + erf(lo) on positive arguments: the bits
// of the signed form, without its compare, select and sign multiply per
// erf.
__device__ __forceinline__ float norm_of(float d, bool shorts_on, const Params& p) {
  const float hi = erf_as(__fdiv_rn(__fadd_rn(__fsub_rn(p.m, d), 0.5f), p.sq2));
  const float lo = erf_as(__fdiv_rn(__fadd_rn(d, 0.5f), p.sq2));
  const float gauss_sum = __fmul_rn(0.5f, __fadd_rn(hi, lo));
  const float shorts = shorts_on ? __fmul_rn(p.z_short, __fadd_rn(d, 1.0f)) : 0.0f;
  return __fadd_rn(__fadd_rn(__fmaf_rn(p.z_hit, gauss_sum, shorts), p.z_max), p.z_rand);
}

// log of the normaliser at d in [0, m]: the one function behind the
// tables and the analytic path.
__device__ __forceinline__ float log_norm(float d, const Params& p) {
  return logf(norm_of(d, d > 0.0f, p));
}

// The reciprocal the short-return term multiplies by.
__device__ __forceinline__ float short_rcp(float d) {
  return __frcp_rn(fmaxf(d, 1.0f));
}

// One integer-table entry: {log_norm(d), short_rcp(d)} at d = min(entry, m).
__device__ __forceinline__ float2 norm_entry(float d, const Params& p) {
  return make_float2(log_norm(d, p), short_rcp(d));
}

// d/dd log norm(d) with the short term on, in double, from the value v =
// log norm(d) (the Gaussian's derivative is exact; the A&S erf's differs
// from it by ~1e-7 relative, far below what a Hermite segment of 1/2 px
// feels).
__device__ __forceinline__ double log_norm_slope(float d, float v, const Params& p) {
  constexpr double kRsqrtPi = 0.56418958354775628695;  // 1 / sqrt(pi)
  const double sq2 = p.sq2;
  const double u_lo = (static_cast<double>(d) + 0.5) / sq2;
  const double u_hi = (static_cast<double>(p.m) - d + 0.5) / sq2;
  const double dgauss = kRsqrtPi / sq2 * (exp(-u_lo * u_lo) - exp(-u_hi * u_hi));
  return (static_cast<double>(p.z_hit) * dgauss + p.z_short) / exp(static_cast<double>(v));
}

// Sub-bin table entry k (0 <= k <= kSubbinSteps * m): node d_k = k / steps
// and the cubic Hermite segment of log norm over (d_{k-1}, d_k], in the
// distance s = (d_k - d) * steps in [0, 1) from the node:
//   log norm(d) ~ c.x + s (c.y + s (c.z + s c.w)),  c.x = log_norm(d_k).
// It matches value and slope at both ends; its left end is the limit
// from the right (the short term on), so node 1's segment reaches d -> 0+
// and node 0, which only d = 0 itself reads, is log_norm(0) alone.
__device__ __forceinline__ float4 subbin_entry(int k, const Params& p) {
  if (k == 0) return make_float4(log_norm(0.0f, p), 0.0f, 0.0f, 0.0f);
  constexpr double h = 1.0 / kSubbinSteps;
  const float d1 = static_cast<float>(k) * static_cast<float>(h);  // exact
  const float d0 = static_cast<float>(k - 1) * static_cast<float>(h);
  const float v1 = log_norm(d1, p);
  const float v0 = logf(norm_of(d0, true, p));
  const double a1 = -h * log_norm_slope(d1, v1, p);
  const double b1 = -h * log_norm_slope(d0, v0, p);
  const double delta = static_cast<double>(v0) - v1;
  return make_float4(v1, static_cast<float>(a1),
                     static_cast<float>(3.0 * delta - 2.0 * a1 - b1),
                     static_cast<float>(b1 + a1 - 2.0 * delta));
}

// log norm(d) from the sub-bin table, d in [0, m] (m an integer):
// d * steps is exact, so a node reads its own value (s = 0) bit for bit.
__device__ __forceinline__ float subbin_log_norm(float d, const float4* sub) {
  const float u = __fmul_rn(d, static_cast<float>(kSubbinSteps));
  const float k = ceilf(u);
  const float s = __fsub_rn(k, u);
  const float4 c = sub[__float2int_rz(k)];
  return __fmaf_rn(s, __fmaf_rn(s, __fmaf_rn(s, c.w, c.z), c.y), c.x);
}

// What a block keeps in shared memory for the beam sum: per beam
// {min(obs, m), offset bits} in one 8 B word, and the query's table.
struct BeamStage {
  const float2* beams;  // [r]
  const float2* tab;    // [last + 1]: the integer table (Model::kTabled)
  const float4* sub;    // the sub-bin table (Model::kLerped)
  int last;
};

// log p(obs | d) for one beam from the raw window value x (a LUT entry,
// or its sub-bin lerp); obs is already clipped to m. The tabled model
// reads {log norm, reciprocal} at min(entry, last); the sub-bin table
// gives the normaliser and the term computes the reciprocal (only where
// the short term needs it), as the analytic models do.
template <Model kModel>
__device__ __forceinline__ float beam_logp(float x, float obs, const BeamStage& s,
                                           const Params& p) {
  const float d = fminf(x, p.m);
  constexpr bool kIntTable = kModel == Model::kTabled;
  float2 nr;
  if (kIntTable) {
    nr = s.tab[min(__float2int_rz(x), s.last)];
  } else if (kModel == Model::kLerped) {
    nr.x = subbin_log_norm(d, s.sub);
  } else {
    nr.x = log_norm(d, p);
  }
  const float z = __fsub_rn(obs, d);
  float prob = __fmul_rn(p.gauss_coef, expf(__fmul_rn(-__fmul_rn(z, z), p.inv2s2)));
  if (obs < d) {
    if (!kIntTable) nr.y = short_rcp(d);
    prob = __fmaf_rn(__fmul_rn(p.short2, __fsub_rn(d, obs)), nr.y, prob);
  }
  if (obs >= p.m) prob = __fadd_rn(prob, p.z_max);
  if (obs < p.m) prob = __fadd_rn(prob, p.rand_term);
  return __fsub_rn(logf(fmaxf(prob, 1e-35f)), nr.x);
}

// The expected range of one beam: the window entry at ``off``, or with
// the sub-bin lerp (TPU kernel K3, pallas_lut.py lerp_bins :394-398) its
// interpolation toward the +1 bin by the heading's fractional bin,
// x0 + frac * (x1 - x0) in round-to-nearest steps so nothing is fused into
// an FMA. off + 1 needs no wrap modulo T: the guard bin of
// window_entries and the row's wraparound padding put bin T at bin 0's
// place.
template <Model kModel, typename T>
__device__ __forceinline__ float window_range(const T* window, int off,
                                              float frac) {
  const float x0 = static_cast<float>(window[off]);
  if (!lerps(kModel)) return x0;
  const float x1 = static_cast<float>(window[off + 1]);
  return __fadd_rn(x0, __fmul_rn(frac, __fsub_rn(x1, x0)));
}

// Shared-memory bytes of the stage: the sub-bin table (16 B entries,
// first, so they keep their alignment) or the integer table (8 B, after
// the beams), and the beams.
__host__ __device__ inline size_t stage_bytes(int r, int table_entries,
                                              bool subbin_table = false) {
  return static_cast<size_t>(r) * sizeof(float2) +
         static_cast<size_t>(table_entries) * (subbin_table ? sizeof(float4) : sizeof(float2));
}

// Fill the stage from global memory, strided over the block; the caller
// synchronizes. ``table`` is the query's device table of ``entries``
// rows (float4 rows with ``subbin_table``), or null; ``smem`` is 16 B
// aligned.
__device__ __forceinline__ BeamStage stage_beams(
    float2* smem, const float* __restrict__ obs, const int32_t* __restrict__ offsets,
    int r, const float2* __restrict__ table, int entries, const Params& p,
    bool subbin_table = false) {
  BeamStage s{smem, nullptr, nullptr, entries - 1};
  if (table != nullptr && subbin_table) {
    float4* s_sub = reinterpret_cast<float4*>(smem);
    const float4* src = reinterpret_cast<const float4*>(table);
    for (int j = threadIdx.x; j < entries; j += blockDim.x) s_sub[j] = src[j];
    s.sub = s_sub;
    s.beams = smem + 2 * entries;
  } else if (table != nullptr) {
    float2* s_tab = smem + r;
    for (int j = threadIdx.x; j < entries; j += blockDim.x) s_tab[j] = table[j];
    s.tab = s_tab;
  }
  float2* beams = const_cast<float2*>(s.beams);
  for (int j = threadIdx.x; j < r; j += blockDim.x) {
    beams[j] = make_float2(fminf(obs[j], p.m), __int_as_float(offsets[j]));
  }
  return s;
}

// The window values of a particle's beams that this lane owns, for a
// group of kSmallGroup lanes: beams lig, lig + 16, ... (< r <= 64), read
// ahead of the arithmetic so a caller can fetch the next particle's
// while it sums this one's.
template <Model kModel, typename T>
__device__ __forceinline__ void load_ranges(const T* window, const BeamStage& s,
                                            int r, int lig, float frac,
                                            float (&x)[kTermsPerLane]) {
#pragma unroll
  for (int k = 0; k < kTermsPerLane; ++k) {
    const int j = lig + k * kSmallGroup;
    x[k] = j < r ? window_range<kModel>(window, __float_as_int(s.beams[j].y), frac)
                 : 0.0f;
  }
}

template <Model kModel>
__device__ __forceinline__ double sum_ranges(const float (&x)[kTermsPerLane],
                                             const BeamStage& s, int r, int lig,
                                             const Params& p) {
  double acc = 0.0;
#pragma unroll
  for (int k = 0; k < kTermsPerLane; ++k) {
    const int j = lig + k * kSmallGroup;
    if (j < r) acc += beam_logp<kModel>(x[k], s.beams[j].x, s, p);
  }
  return acc;
}

// This lane's share of a particle's beam sum for a whole-warp group:
// beams lane, lane + 32, ...; tabled terms over two accumulators so that
// several LUT loads are in flight, analytic terms in one plain loop (they
// are long enough to hide their own loads).
template <Model kModel, typename T>
__device__ __forceinline__ double sum_window(const T* window, const BeamStage& s,
                                             int r, int lane, float frac,
                                             const Params& p) {
  double acc0 = 0.0, acc1 = 0.0;
  int j = lane;
  if (reads_table(kModel)) {
#pragma unroll 2
    for (; j + kWarp < r; j += 2 * kWarp) {
      const float2 b0 = s.beams[j], b1 = s.beams[j + kWarp];
      const float x0 = window_range<kModel>(window, __float_as_int(b0.y), frac);
      const float x1 = window_range<kModel>(window, __float_as_int(b1.y), frac);
      acc0 += beam_logp<kModel>(x0, b0.x, s, p);
      acc1 += beam_logp<kModel>(x1, b1.x, s, p);
    }
  }
  for (; j < r; j += kWarp) {
    const float2 b = s.beams[j];
    acc0 += beam_logp<kModel>(window_range<kModel>(window, __float_as_int(b.y), frac), b.x,
                              s, p);
  }
  return acc0 + acc1;
}

// inv_squash * (sum over a group's lanes): a butterfly inside each group
// of kGroup lanes, then every lane takes its group's lane 0 (the
// butterfly leaves each lane its own rounding order). The whole warp
// calls it.
template <int kGroup>
__device__ __forceinline__ float group_total(double acc, int lane, const Params& p) {
#pragma unroll
  for (int off = kGroup / 2; off > 0; off >>= 1) {
    acc += __shfl_xor_sync(kFullMask, acc, off);
  }
  acc = __shfl_sync(kFullMask, acc, lane & ~(kGroup - 1));
  return __fmul_rn(p.inv_squash, static_cast<float>(acc));
}

// inv_squash * sum_j log p(obs_j | window[off_j]) for one particle per
// group of kGroup lanes; the whole warp calls it, a group without a
// particle passes valid = false and reads nothing. ``window`` may point
// into global or shared memory. Every lane of a group returns the group's
// sum.
template <int kGroup, Model kModel, typename T>
__device__ __forceinline__ float group_window_logp(const T* window, bool valid,
                                                   const BeamStage& s, int r,
                                                   int lane, const Params& p,
                                                   float frac = 0.0f) {
  const int rr = valid ? r : 0;
  double acc;
  if (kGroup == kSmallGroup) {
    const int lig = lane % kSmallGroup;
    float x[kTermsPerLane];
    load_ranges<kModel>(window, s, rr, lig, frac, x);
    acc = sum_ranges<kModel>(x, s, rr, lig, p);
  } else {
    acc = sum_window<kModel>(window, s, rr, lane, frac, p);
  }
  return group_total<kGroup>(acc, lane, p);
}

template <typename T>
__device__ __forceinline__ const T* shfl_window(const T* w, int src, int width) {
  return reinterpret_cast<const T*>(__shfl_sync(
      kFullMask, reinterpret_cast<unsigned long long>(w), src, width));
}

// The log weights of ``count`` particles held by the first lanes of each
// group of kGroup lanes: lane i holds particle i's window (null off the
// map; it may point into global or shared memory) and fractional bin.
// The group sums them one particle a round; lane i returns particle i's
// inv_squash * sum_j log p, or -1e4 off the map (any lane past count
// returns -1e4). The whole warp calls it. Tabled scans of <= 64 beams
// fetch round it + 1's window values before they sum round it's from
// registers.
template <int kGroup, Model kModel, typename T>
__device__ __forceinline__ float group_rounds(const T* win, float frac, int count,
                                              const BeamStage& s, int r, int lane,
                                              const Params& p) {
  const int lig = lane % kGroup;
  // the warp runs as many rounds as its fullest group has particles
  int rounds = count;
  if (kGroup < kWarp) rounds = max(rounds, __shfl_xor_sync(kFullMask, rounds, kGroup));
  float mine = -1e4f;
  if (kGroup == kSmallGroup) {
    float next[kTermsPerLane];
    const T* at = shfl_window(win, 0, kGroup);
    float fa = lerps(kModel) ? __shfl_sync(kFullMask, frac, 0, kGroup) : 0.0f;
    load_ranges<kModel>(at, s, at != nullptr ? r : 0, lig, fa, next);
    for (int it = 0; it < rounds; ++it) {
      const int rr = at != nullptr ? r : 0;
      float cur[kTermsPerLane];
#pragma unroll
      for (int k = 0; k < kTermsPerLane; ++k) cur[k] = next[k];
      const int src = min(it + 1, kGroup - 1);
      at = shfl_window(win, src, kGroup);
      if (lerps(kModel)) fa = __shfl_sync(kFullMask, frac, src, kGroup);
      load_ranges<kModel>(at, s, it + 1 < rounds && at != nullptr ? r : 0, lig, fa, next);
      const float logw = group_total<kGroup>(sum_ranges<kModel>(cur, s, rr, lig, p), lane, p);
      if (lig == it && rr > 0) mine = logw;
    }
  } else {
    for (int it = 0; it < rounds; ++it) {
      const T* at = shfl_window(win, it, kGroup);
      const float fr = lerps(kModel) ? __shfl_sync(kFullMask, frac, it, kGroup) : 0.0f;
      const float logw = group_window_logp<kGroup, kModel>(at, at != nullptr, s, r, lane, p, fr);
      if (lig == it && at != nullptr) mine = logw;
    }
  }
  return mine;
}

// Where one particle's window starts (pallas_lut.py query :855-912), the
// address math of the LUT kernels (lut_likelihood.cu, lut_dedup.cu):
//   cell = (int)((y - oy) / res) * W + (int)((x - ox) / res)  (truncating)
//   row  = row_map ? row_map[cell] : cell
//   b0   = (rint(theta * T / 2pi) + base) mod T                (half to even)
// or, with the sub-bin lerp, b0 from floor(theta * T / 2pi) and frac its
// fractional part. Returns false for a particle outside the map. The
// origin is the map's float32 origin: a batched map's own (JAX's
// origins[0][mi]), or the single map's as folded into Params.
struct Window {
  int64_t row;
  int b0;
  float frac;
};

template <bool kSubbin>
__device__ __forceinline__ bool particle_window(
    float x, float y, float theta, float ox, float oy,
    const int32_t* __restrict__ row_map, int base, int t_bins, int height,
    int width, const Params& p, Window* w) {
  const int gx = static_cast<int>((x - ox) / p.res);
  const int gy = static_cast<int>((y - oy) / p.res);
  if (gx < 0 || gx >= width || gy < 0 || gy >= height) return false;
  const int64_t cell = static_cast<int64_t>(gy) * width + gx;
  w->row = row_map ? static_cast<int64_t>(row_map[cell]) : cell;
  int b0;
  if (kSubbin) {
    const float bpos = __fmul_rn(theta, p.bin_scale);
    const float bf = floorf(bpos);
    w->frac = __fsub_rn(bpos, bf);
    b0 = static_cast<int>(bf);
  } else {
    b0 = static_cast<int>(rintf(theta * p.bin_scale));
    w->frac = 0.0f;
  }
  b0 = (b0 + base) % t_bins;  // truncating remainder, then fixed up
  if (b0 < 0) b0 += t_bins;
  w->b0 = b0;
  return true;
}

// Unpack the host's float array into Params.
inline Params params_from(const float* consts) {
  static_assert(sizeof(Params) == kNumConsts * sizeof(float),
                "Params must be kNumConsts packed floats");
  Params p;
  float* fields = reinterpret_cast<float*>(&p);
  for (int c = 0; c < kNumConsts; ++c) fields[c] = consts[c];
  return p;
}

// Whether a query's table of ``entries`` rows fits its model: the integer
// table holds 1..kMaxTableEntries rows; the sub-bin table holds
// kSubbinSteps * m + 1 rows of an integer m, at most kMaxSubbinEntries.
inline bool table_fits(bool subbin, int entries, const Params& p) {
  if (!subbin) return entries >= 1 && entries <= kMaxTableEntries;
  const float m = p.m;
  return m >= 1.0f && m == static_cast<float>(static_cast<int>(m)) &&
         entries == kSubbinSteps * static_cast<int>(m) + 1 && entries <= kMaxSubbinEntries;
}

// Blocks of one kernel instantiation that fit the device at once with
// ``smem`` bytes of dynamic shared memory and ``threads`` per block. A
// kernel past the 48 KB default is opted into all the shared memory a
// block may have on the device, never less: an opt-in sized to one
// launch would lower what another launch of the same instantiation
// needs.
template <typename Kernel>
cudaError_t resident_blocks(Kernel kernel, size_t smem, int threads, int* blocks) {
  // the last answers: a filter asks the same few questions at every
  // correction
  struct Answer {
    const void* kernel;
    int dev, threads, blocks;
    size_t smem;
  };
  constexpr int kAnswers = 8;
  static Answer answers[kAnswers] = {};
  static int next = 0;
  const void* asked = reinterpret_cast<const void*>(kernel);
  int dev = 0, sms = 0, per_sm = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  for (const Answer& a : answers) {
    if (a.kernel == asked && a.dev == dev && a.smem == smem && a.threads == threads) {
      *blocks = a.blocks;
      return cudaSuccess;
    }
  }
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  if (smem > 48 * 1024) {
    cudaFuncAttributes attr;
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return err;
    err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return err;
    const int dynamic = optin - static_cast<int>(attr.sharedSizeBytes);
    if (smem > static_cast<size_t>(dynamic)) return cudaErrorInvalidConfiguration;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dynamic);
    if (err != cudaSuccess) return err;
  }
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *blocks = per_sm * sms;
  answers[next] = Answer{asked, dev, threads, *blocks, smem};
  next = (next + 1) % kAnswers;
  return cudaSuccess;
}

}  // namespace mcl
