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
// a log) depends on nothing but the expected range d, and without the
// sub-bin lerp d is an integer LUT entry clipped to m: at most
// ceil(m) + 1 distinct values per query. The TPU's vector unit has no
// cheap per-lane table, so its kernel recomputes the normaliser for every
// beam term; a GPU has shared memory, so here one tiny kernel
// (log_norm_kernel, lut_likelihood.cu) fills a table of
// {log norm(d), 1 / max(d, 1)} once per query, every block copies it into
// shared memory beside the scan, and a beam term costs one exp and one
// log. The table is filled by the device function the analytic path
// calls (log_norm), written in explicit round-to-nearest and FMA
// intrinsics so that no compiler context can contract it differently:
// table and analytic path give the same bits. The sub-bin lerp (K3)
// makes d a fraction, which has no integer index, so K3 keeps the
// analytic normaliser of the lerped d; so does a query whose m is past
// kMaxTableEntries.
//
// The beam sum. A particle's beams are spread over a group of kGroup
// lanes: 16 where the scan has at most 64 tabled beams (two particles per
// warp, at most four terms per lane held in registers, a 4-step shuffle)
// and a whole warp otherwise (the beam loop unrolled over two accumulators
// so several LUT loads are in flight per lane). Sums accumulate in double,
// so the float32 result is the rounded sum of the float32 terms whatever
// the order, and the kernels agree with their plain versions to ~1 ulp;
// every kernel picks its group size by group_lanes and runs the same
// code, which keeps lut_dedup.cu bit-equal to lut_likelihood.cu.

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

// How a kernel evaluates the beam model, a template argument so that no
// kernel carries a path it does not run: the normaliser from the table
// (integer LUT entries); analytic from the entry (a query whose m is past
// the table's cap); analytic from the sub-bin lerp of two entries (K3).
enum class Model { kTabled, kAnalytic, kLerped };

inline Model model_of(bool subbin, bool has_table) {
  return subbin ? Model::kLerped : (has_table ? Model::kTabled : Model::kAnalytic);
}

// Lanes that share one particle's beams. An analytic term is the whole
// model, about five times a tabled term, so a short scan then keeps a
// warp per particle: two such terms deep per lane at 60 beams, not four.
inline int group_lanes(int r, Model model) {
  return r <= kSmallBeams && model == Model::kTabled ? kSmallGroup : kWarp;
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
// FMAs, so every kernel and the table's fill round it alike.
__device__ __forceinline__ float erf_as(float ax) {
  const float t = __frcp_rn(__fmaf_rn(0.3275911f, ax, 1.0f));
  float poly = __fmaf_rn(t, 1.061405429f, -1.453152027f);
  poly = __fmaf_rn(t, poly, 1.421413741f);
  poly = __fmaf_rn(t, poly, -0.284496736f);
  poly = __fmaf_rn(t, poly, 0.254829592f);
  poly = __fmul_rn(t, poly);
  return __fmaf_rn(-poly, expf(-__fmul_rn(ax, ax)), 1.0f);
}

// log of the beam model's normaliser at expected range d in [0, m]: the
// one function behind the table and the analytic path. Both erf arguments
// have a known sign there (m - d + 0.5 > 0 > -d - 0.5), so the model's
// erf((m - d + 0.5) / sq2) - erf((-d - 0.5) / sq2) is evaluated as
// erf(hi) + erf(lo) on positive arguments: the bits of the signed form,
// without its compare, select and sign multiply per erf.
__device__ __forceinline__ float log_norm(float d, const Params& p) {
  const float hi = erf_as(__fdiv_rn(__fadd_rn(__fsub_rn(p.m, d), 0.5f), p.sq2));
  const float lo = erf_as(__fdiv_rn(__fadd_rn(d, 0.5f), p.sq2));
  const float gauss_sum = __fmul_rn(0.5f, __fadd_rn(hi, lo));
  const float shorts = d > 0.0f ? __fmul_rn(p.z_short, __fadd_rn(d, 1.0f)) : 0.0f;
  const float norm =
      __fadd_rn(__fadd_rn(__fmaf_rn(p.z_hit, gauss_sum, shorts), p.z_max), p.z_rand);
  return logf(norm);
}

// The reciprocal the short-return term multiplies by.
__device__ __forceinline__ float short_rcp(float d) {
  return __frcp_rn(fmaxf(d, 1.0f));
}

// One table entry: {log_norm(d), short_rcp(d)} at d = min(entry, m).
__device__ __forceinline__ float2 norm_entry(float d, const Params& p) {
  return make_float2(log_norm(d, p), short_rcp(d));
}

// log p(obs | d) for one beam from the raw window value x (a LUT entry,
// or its sub-bin lerp); obs is already clipped to m. ``tab`` is the
// shared-memory table indexed by min(entry, last); the other models
// evaluate the normaliser (and the reciprocal only where the short term
// needs it).
template <Model kModel>
__device__ __forceinline__ float beam_logp(float x, float obs, const float2* tab,
                                           int last, const Params& p) {
  const float d = fminf(x, p.m);
  constexpr bool tabled = kModel == Model::kTabled;
  float2 nr;
  if (tabled) {
    nr = tab[min(__float2int_rz(x), last)];
  } else {
    nr.x = log_norm(d, p);
  }
  const float z = __fsub_rn(obs, d);
  float prob = __fmul_rn(p.gauss_coef, expf(__fmul_rn(-__fmul_rn(z, z), p.inv2s2)));
  if (obs < d) {
    if (!tabled) nr.y = short_rcp(d);
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
  if (kModel != Model::kLerped) return x0;
  const float x1 = static_cast<float>(window[off + 1]);
  return __fadd_rn(x0, __fmul_rn(frac, __fsub_rn(x1, x0)));
}

// What a block keeps in shared memory for the beam sum: per beam
// {min(obs, m), offset bits} in one 8 B word, then the normaliser table.
struct BeamStage {
  const float2* beams;  // [r]
  const float2* tab;    // [last + 1]; read by Model::kTabled only
  int last;
};

__host__ __device__ inline size_t stage_bytes(int r, int table_entries) {
  return (static_cast<size_t>(r) + table_entries) * sizeof(float2);
}

// Fill the stage from global memory, strided over the block; the caller
// synchronizes. ``table`` is the query's device table of ``entries``
// float2, or null.
__device__ __forceinline__ BeamStage stage_beams(
    float2* smem, const float* __restrict__ obs, const int32_t* __restrict__ offsets,
    int r, const float2* __restrict__ table, int entries, const Params& p) {
  for (int j = threadIdx.x; j < r; j += blockDim.x) {
    smem[j] = make_float2(fminf(obs[j], p.m), __int_as_float(offsets[j]));
  }
  float2* s_tab = smem + r;
  if (table != nullptr) {
    for (int j = threadIdx.x; j < entries; j += blockDim.x) s_tab[j] = table[j];
  }
  return BeamStage{smem, table != nullptr ? s_tab : nullptr, entries - 1};
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
    if (j < r) acc += beam_logp<kModel>(x[k], s.beams[j].x, s.tab, s.last, p);
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
  if (kModel == Model::kTabled) {
#pragma unroll 2
    for (; j + kWarp < r; j += 2 * kWarp) {
      const float2 b0 = s.beams[j], b1 = s.beams[j + kWarp];
      const float x0 = window_range<kModel>(window, __float_as_int(b0.y), frac);
      const float x1 = window_range<kModel>(window, __float_as_int(b1.y), frac);
      acc0 += beam_logp<kModel>(x0, b0.x, s.tab, s.last, p);
      acc1 += beam_logp<kModel>(x1, b1.x, s.tab, s.last, p);
    }
  }
  for (; j < r; j += kWarp) {
    const float2 b = s.beams[j];
    acc0 += beam_logp<kModel>(window_range<kModel>(window, __float_as_int(b.y), frac), b.x,
                              s.tab, s.last, p);
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
// into global or shared memory (the dedup kernel's staged windows go
// through this same code). Every lane of a group returns the group's sum.
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

}  // namespace mcl
