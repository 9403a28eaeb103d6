// The whole MCL correction as ONE kernel launch, for Hopper (sm_90a).
//
// Replaces the TPU kernel K6, monte_carlo_localization_tpu/ops/
// pallas_mega.py build_mega_step_fn -> kernel (:197, pl.pallas_call
// :485): systematic resample, motion on given noise, window addressing,
// the K1/K2 LUT likelihood, max-shift normalization and the pose moment
// sums, for a dense u8/u16 LUT. The TPU runs it as one sequential grid
// on one core; here the blocks run in parallel and no float atomics are
// used: every cross-block reduction goes through per-block partials that
// are combined in block order, so a run is reproducible.
//
//   phase 1, weights: mx = max(lw); w = exp(lw - mx); the inclusive prefix
//     cs of w and its total z, both in double, rounded once to float32;
//     then, in float32 as the TPU does (:243-249), g_j = n*(cs_j/z) - u0.
//   phase 2, per particle slot i: the ancestor is the j with
//     g_{j-1} < i <= g_j (g_{-1} = -u0), found by a binary search over g;
//     a slot no j covers takes the row (0, 0, 0), as the TPU's one-hot
//     gather gives (:261-270). Then the displacement-form motion
//     (:274-297) with the floor-based wrap, the dense-LUT address
//     (:305-317) and the beam sum of beam_model.cuh; -1e4 off the map.
//   phase 3: mx' = max of the new log weights; out_log_weights = lp - mx';
//     S_wx, S_wy, S_wsin, S_wcos, Z in double; out_sums = [S_wx, S_wy,
//     S_wsin, S_wcos, Z, mx', 0, 0] (the layout of :436-443).
//
// What binds it on an H100, and what the design does about it. At the
// mega path's shape (4000 particles) the arithmetic is a few
// microseconds; what cost 32 us was five grid-wide barriers over a grid
// sized for the card (660 blocks for 4000 particles), every block walking
// all 660 partials after each, and an ancestor search of 12 dependent L2
// reads per slot. So:
//   - the grid is sized by the work: blocks of 16 (<= 64 beams) or 8
//     particle groups take a contiguous chunk of particles, about three
//     blocks per SM at most (mcl_mega_plan);
//   - where n <= kSmallN every block computes the whole of phase 1 itself
//     into its own shared memory (n doubles and n floats), in one fixed
//     order so all blocks hold the same bits: no grid barrier, no partials,
//     and the ancestor search reads shared memory. The launch is then an
//     ordinary one. The repeated double scan is paced by warp shuffles
//     (one a clock per SM, two per double), so a lane sums four
//     consecutive weights itself and the butterfly runs over lane totals.
//     Larger n keeps the barrier form of phase 1 (each block scans one
//     chunk; three grid.sync(); g in global memory, read through L2),
//     launched cooperatively on a grid capped at the co-resident one. Both
//     forms compute g by the same expressions;
//   - lane i of a group does the search, the motion and the address math
//     of the group's particle i (vectorised over lanes, as in
//     lut_likelihood.cu), then the group sums each particle's beams with
//     the normaliser table of beam_model.cuh;
//   - phase 3 needs one hand-off instead of two barriers: a lane keeps
//     the moment sums of its slots in registers, relative to their running
//     max, and a block writes its max m_b and its sums relative to m_b. In the small form
//     it then takes a ticket (__threadfence + atomicAdd) and the last
//     block to arrive subtracts mx' from the n new log weights; in the
//     barrier form one grid.sync() follows and every block shifts its own
//     chunk. The partials are combined in block order, rescaled by
//     exp(m_b - mx') in double, into out_sums. The sums differ from the
//     plain version's by rounding only; out_log_weights = lp - mx' is
//     exact.
//
// Numerics: the motion and address arithmetic use explicit
// round-to-nearest intrinsics (__fadd_rn, __fmul_rn, ...), so the compiler
// contracts nothing into an FMA and the proposal is bit-equal to the
// plain PyTorch version's unfused float32 ops. The beam model is the
// shared one of K1.

#include <cooperative_groups.h>

#include <cmath>
#include <cstdint>

#include <cuda_runtime.h>

#include "beam_model.cuh"

namespace cg = cooperative_groups;

namespace {

using mcl::kFullMask;
using mcl::kWarp;
using mcl::Model;
using mcl::Params;
constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarp * kWarpsPerBlock;
constexpr int kMoments = 5;  // S_wx, S_wy, S_wsin, S_wcos, Z
// Up to this many particles every block computes phase 1 itself (12 B of
// shared memory per particle); past it phase 1 runs across the grid.
constexpr int64_t kSmallN = 8192;
constexpr int kBlocksPerSm = 3;  // the grid the plan aims for, at most
constexpr int kLaneRun = 4;     // consecutive weights a lane sums itself in the scan
constexpr int kRunTile = kWarp * kLaneRun;
constexpr int kScanTiles = 2;   // tiles of kRunTile weights a warp scans at once
constexpr int kShiftLoads = 16;  // log weights a thread has in flight in the shift

// Follows Params in the host float array (MegaStep._consts in
// ops/mega_step.py).
struct Motion {
  float disp_x, disp_y, disp_th, two_pi, inv_2pi;
};
constexpr int kNumMotionConsts = 5;

// debug_phases of pallas_mega.py (:216, :355, :406): "all", "no_epi"
// (stop before the epilogue), "pro_only" (stop after the proposal).
enum Phases { kAll = 0, kNoEpilogue = 1, kProposalOnly = 2 };

// The wrapper's scratch buffer, one zero-initialised allocation: the
// ticket at its start (the same place whatever the grid, so it stays 0
// between launches of any size), then the doubles. psum, pmax and g serve
// the barrier form of phase 1 only.
struct Workspace {
  int* ticket;   // blocks whose partials are written; 0 between launches
  double* psum;  // [grid] block totals of w
  double* pmom;  // [kMoments * grid] block moment sums, relative to pmax2
  float* pmax;   // [grid] block max of the input log weights
  float* pmax2;  // [grid] block max of the new log weights
  float* g;      // [n] the scaled CDF
};
constexpr int64_t kTicketBytes = 16;  // keeps the doubles aligned

int64_t workspace_bytes(int64_t n, int grid) {
  return kTicketBytes + static_cast<int64_t>(grid) * (1 + kMoments) * sizeof(double) +
         (2 * static_cast<int64_t>(grid) + n) * sizeof(float);
}

template <typename T>
struct Args {
  const T* lut;
  int64_t row_stride;
  const float* particles;    // (n, 3)
  const float* log_weights;  // (n,)
  const float* noise;        // (n, 3) N(0, 1)
  int64_t n;
  int64_t chunk;             // particles per block, contiguous
  const float* obs;          // (r,) observed px
  const int32_t* offsets;    // (r,) k*j + e_j
  int r, base, t_bins, height, width;
  const float2* table;       // the query's normaliser table, or null
  int table_entries;
  Params p;
  Motion mo;
  const float* scalars;      // (8,) [ds, dth, straight, u0, 0, 0, 0, 0]
  float* out_particles;      // (n, 3)
  float* out_log_weights;    // (n,)
  float* out_sums;           // (8,)
  Workspace ws;
  int phases;
};

// Block-wide max and sum; every thread gets the result. The sum's order
// is fixed (warp butterfly, then warps in order), so it is reproducible.
__device__ float block_max(float v, float* s_red) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    v = fmaxf(v, __shfl_xor_sync(kFullMask, v, off));
  }
  __syncthreads();  // s_red may still be read by an earlier call
  if (threadIdx.x % kWarp == 0) s_red[threadIdx.x / kWarp] = v;
  __syncthreads();
  v = s_red[0];
#pragma unroll
  for (int w = 1; w < kWarpsPerBlock; ++w) v = fmaxf(v, s_red[w]);
  return v;
}

__device__ double block_sum(double v, double* s_red) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    v += __shfl_xor_sync(kFullMask, v, off);
  }
  __syncthreads();
  if (threadIdx.x % kWarp == 0) s_red[threadIdx.x / kWarp] = v;
  __syncthreads();
  v = s_red[0];
#pragma unroll
  for (int w = 1; w < kWarpsPerBlock; ++w) v += s_red[w];
  return v;
}

// block_sum of the kMoments sums at once: one pair of barriers.
__device__ void block_sum_moments(double (&v)[kMoments], double* s_red) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1) {
#pragma unroll
    for (int c = 0; c < kMoments; ++c) v[c] += __shfl_xor_sync(kFullMask, v[c], off);
  }
  __syncthreads();
  if (threadIdx.x % kWarp == 0) {
#pragma unroll
    for (int c = 0; c < kMoments; ++c) s_red[threadIdx.x / kWarp * kMoments + c] = v[c];
  }
  __syncthreads();
#pragma unroll
  for (int c = 0; c < kMoments; ++c) {
    v[c] = s_red[c];
#pragma unroll
    for (int w = 1; w < kWarpsPerBlock; ++w) v[c] += s_red[w * kMoments + c];
  }
}

// Max over the grid's per-block partials, written by other blocks before
// a grid sync or a ticket: read through L2 (__ldcg).
__device__ float grid_max(const float* part, int grid, float* s_red) {
  float m = -INFINITY;
  for (int k = threadIdx.x; k < grid; k += kThreads) {
    m = fmaxf(m, __ldcg(part + k));
  }
  return block_max(m, s_red);
}

__device__ double grid_sum(const double* part, int count, double* s_red) {
  double s = 0.0;
  for (int k = threadIdx.x; k < count; k += kThreads) s += __ldcg(part + k);
  return block_sum(s, s_red);
}

// A warp's inclusive prefix sum of v over its lanes.
__device__ __forceinline__ double warp_prefix(double v, int lane) {
#pragma unroll
  for (int off = 1; off < kWarp; off <<= 1) {
    const double up = __shfl_up_sync(kFullMask, v, off);
    if (lane >= off) v += up;
  }
  return v;
}

// g_j from the rounded prefix and total: the expressions both forms of
// phase 1 share with the plain version.
__device__ __forceinline__ float scaled_cdf(float cs, float z, float nf, float u0) {
  return __fsub_rn(__fmul_rn(nf, __fdiv_rn(cs, z)), u0);
}

// Shared memory ahead of the beam stage: the block's own CDF where every
// block computes phase 1 itself (n doubles at pre_at, then n floats from a
// 16 B boundary, read four at a time).
// Where prefix i lives: one double skipped after every 16, so that lanes
// writing four consecutive prefixes each (the scan) and lanes reading
// consecutive ones (the pass after it) both spread over the banks.
__host__ __device__ inline int64_t pre_at(int64_t i) { return i + (i >> 4); }

__host__ __device__ inline size_t cdf_g_offset(int64_t n) {
  return (static_cast<size_t>(pre_at(n) + 1) * sizeof(double) + 15) / 16 * 16;
}

__host__ __device__ inline size_t cdf_bytes(int64_t n) {
  return cdf_g_offset(n) + (static_cast<size_t>(n) * sizeof(float) + 15) / 16 * 16;
}

template <typename T, Model kModel, int kGroup, bool kSmall>
__global__ void __launch_bounds__(kThreads) mega_step_kernel(Args<T> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float s_redf[kWarpsPerBlock];
  __shared__ double s_redd[kWarpsPerBlock * kMoments];
  __shared__ double s_scan[kWarpsPerBlock];
  __shared__ bool s_last;
  constexpr int kGroups = kThreads / kGroup;

  const Params& p = a.p;
  const int tid = threadIdx.x;
  const int lane = tid % kWarp;
  const int warp = tid / kWarp;
  const int b = blockIdx.x;
  const int nb = gridDim.x;
  const int64_t n = a.n;
  double* s_pre = reinterpret_cast<double*>(smem);
  float* s_g = reinterpret_cast<float*>(smem + (kSmall ? cdf_g_offset(n) : 0));
  const mcl::BeamStage s = mcl::stage_beams(
      reinterpret_cast<float2*>(smem + (kSmall ? cdf_bytes(n) : 0)), a.obs, a.offsets,
      a.r, a.table, a.table_entries, p);  // the syncs of phase 1 publish it
  const float ds = a.scalars[0];
  const float dth = a.scalars[1];
  const bool straight = a.scalars[2] > 0.5f;
  const float u0 = a.scalars[3];
  const float nf = static_cast<float>(n);

  // this block's contiguous chunk of particles, and this group's share
  const int64_t lo = min(n, static_cast<int64_t>(b) * a.chunk);
  const int64_t hi = min(n, lo + a.chunk);
  const int lig = tid % kGroup;
  const int64_t per_group = (hi - lo + kGroups - 1) / kGroups;
  const int64_t g_lo = min(hi, lo + (tid / kGroup) * per_group);
  const int64_t g_hi = min(hi, g_lo + per_group);

  // ---- phase 1: weights -> the scaled CDF g -----------------------------
  const float* g = kSmall ? s_g : a.ws.g;
  if constexpr (kSmall) {
    // the whole of it in this block: every block holds the same bits
    const int ns = static_cast<int>(n);  // <= kSmallN
    float m = -INFINITY;
    for (int i = tid; i < ns; i += kThreads) {
      const float lw = a.log_weights[i];
      s_g[i] = lw;
      m = fmaxf(m, lw);
    }
    const float mx = block_max(m, s_redf);
    // Each warp scans one contiguous segment. A lane sums kLaneRun
    // consecutive weights itself and the warp's butterfly runs over the
    // lanes' totals only: the SM moves one warp shuffle a clock, and a
    // double is two, so shuffles, not arithmetic, set this scan's pace.
    // kScanTiles tiles go step by step together (shuffles keep program
    // order, so a tile at a time would run the chains one after another).
    const int seg = (ns + kWarpsPerBlock * kRunTile - 1) / (kWarpsPerBlock * kRunTile) * kRunTile;
    const int w_lo = min(ns, warp * seg);
    const int w_hi = min(ns, w_lo + seg);
    double carry = 0.0;
    for (int t0 = w_lo; t0 < w_hi; t0 += kScanTiles * kRunTile) {
      double run[kScanTiles][kLaneRun], v[kScanTiles], total[kScanTiles];
#pragma unroll
      for (int k = 0; k < kScanTiles; ++k) {
        const int i = t0 + k * kRunTile + lane * kLaneRun;
        float4 lw = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (i < w_hi) lw = *reinterpret_cast<const float4*>(s_g + i);  // s_g is padded to 16 B
        const float lws[kLaneRun] = {lw.x, lw.y, lw.z, lw.w};
        double sum = 0.0;
#pragma unroll
        for (int j = 0; j < kLaneRun; ++j) {
          if (i + j < w_hi) sum += static_cast<double>(expf(lws[j] - mx));
          run[k][j] = sum;
        }
        v[k] = sum;
      }
#pragma unroll
      for (int off = 1; off < kWarp; off <<= 1) {
        double up[kScanTiles];
#pragma unroll
        for (int k = 0; k < kScanTiles; ++k) up[k] = __shfl_up_sync(kFullMask, v[k], off);
#pragma unroll
        for (int k = 0; k < kScanTiles; ++k) {
          if (lane >= off) v[k] += up[k];
        }
      }
#pragma unroll
      for (int k = 0; k < kScanTiles; ++k) total[k] = __shfl_sync(kFullMask, v[k], kWarp - 1);
#pragma unroll
      for (int k = 0; k < kScanTiles; ++k) {
        const int i = t0 + k * kRunTile + lane * kLaneRun;
        const double before_lane = carry + (v[k] - run[k][kLaneRun - 1]);
#pragma unroll
        for (int j = 0; j < kLaneRun; ++j) {
          if (i + j < w_hi) s_pre[pre_at(i + j)] = before_lane + run[k][j];
        }
        carry += total[k];
      }
    }
    if (lane == 0) s_scan[warp] = carry;
    __syncthreads();
    double before = 0.0, total = 0.0;  // warps in order, the same in every thread
#pragma unroll
    for (int w = 0; w < kWarpsPerBlock; ++w) {
      if (w == warp) before = total;
      total += s_scan[w];
    }
    const float z = static_cast<float>(total);
    for (int i = w_lo + lane; i < w_hi; i += kWarp) {  // this warp's own segment
      s_g[i] = scaled_cdf(static_cast<float>(s_pre[pre_at(i)] + before), z, nf, u0);
    }
    __syncthreads();
  } else {
    // across the grid: a block scans its chunk between the prefix of the
    // earlier blocks' totals
    cg::grid_group grid = cg::this_grid();
    float m = -INFINITY;
    for (int64_t i = lo + tid; i < hi; i += kThreads) {
      m = fmaxf(m, a.log_weights[i]);
    }
    m = block_max(m, s_redf);
    if (tid == 0) a.ws.pmax[b] = m;
    grid.sync();

    const float mx = grid_max(a.ws.pmax, nb, s_redf);
    double total = 0.0;
    for (int64_t i = lo + tid; i < hi; i += kThreads) {
      total += static_cast<double>(expf(a.log_weights[i] - mx));
    }
    total = block_sum(total, s_redd);
    if (tid == 0) a.ws.psum[b] = total;
    grid.sync();

    double carry = grid_sum(a.ws.psum, b, s_redd);  // sum of earlier blocks
    const float z = static_cast<float>(grid_sum(a.ws.psum, nb, s_redd));
    for (int64_t t0 = lo; t0 < hi; t0 += kThreads) {
      const int64_t i = t0 + tid;
      double v = i < hi ? static_cast<double>(expf(a.log_weights[i] - mx)) : 0.0;
      v = warp_prefix(v, lane);
      if (lane == kWarp - 1) s_scan[warp] = v;
      __syncthreads();
      double before = carry;
      for (int w = 0; w < warp; ++w) before += s_scan[w];
      if (i < hi) {
        a.ws.g[i] = scaled_cdf(static_cast<float>(before + v), z, nf, u0);
      }
      for (int w = 0; w < kWarpsPerBlock; ++w) carry += s_scan[w];
      __syncthreads();  // s_scan is rewritten by the next tile
    }
    grid.sync();
  }

  // ---- phase 2: resample + motion + likelihood --------------------------
  // A group of kGroup lanes takes consecutive slots of the chunk, kGroup
  // at a time: lane i proposes slot i, then the group sums each slot's
  // beams.
  const float safe_dth = fabsf(dth) < 1e-12f ? 1.0f : dth;
  const float chord =
      __fmul_rn(ds, __fdiv_rn(__fmul_rn(2.0f, sinf(__fmul_rn(dth, 0.5f))),
                              safe_dth));
  const float half_dth = __fmul_rn(dth, 0.5f);
  // this lane's slots so far: their max log weight and their moment sums
  // relative to it (phase 3's partials, kept out of global memory)
  float new_max = -INFINITY;
  double mom[kMoments] = {0.0, 0.0, 0.0, 0.0, 0.0};
  for (int64_t c = 0; c < per_group; c += kGroup) {  // uniform over the block
    const int64_t i = g_lo + c + lig;
    int64_t start = -1;  // the slot's window, or off the map
    float nx = 0.0f, ny = 0.0f, nth = 0.0f;
    if (i < g_hi) {
      const float slot = static_cast<float>(i);
      int64_t j0 = 0, j1 = n;  // first j with g_j >= slot
      while (j0 < j1) {
        const int64_t mid = (j0 + j1) / 2;
        if ((kSmall ? g[mid] : __ldcg(g + mid)) >= slot) {
          j1 = mid;
        } else {
          j0 = mid + 1;
        }
      }
      float x = 0.0f, y = 0.0f, th = 0.0f;
      if (j0 < n && (j0 > 0 || -u0 < slot)) {
        x = a.particles[3 * j0];
        y = a.particles[3 * j0 + 1];
        th = a.particles[3 * j0 + 2];
      }
      if (straight) {
        nx = __fadd_rn(x, __fmul_rn(ds, cosf(th)));
        ny = __fadd_rn(y, __fmul_rn(ds, sinf(th)));
        nth = th;
      } else {
        const float mid = __fadd_rn(th, half_dth);
        nx = __fadd_rn(x, __fmul_rn(chord, cosf(mid)));
        ny = __fadd_rn(y, __fmul_rn(chord, sinf(mid)));
        nth = __fadd_rn(th, dth);
      }
      nx = __fadd_rn(nx, __fmul_rn(a.noise[3 * i], a.mo.disp_x));
      ny = __fadd_rn(ny, __fmul_rn(a.noise[3 * i + 1], a.mo.disp_y));
      nth = __fadd_rn(nth, __fmul_rn(a.noise[3 * i + 2], a.mo.disp_th));
      nth = __fsub_rn(nth, __fmul_rn(a.mo.two_pi,
                                     floorf(__fadd_rn(__fmul_rn(nth, a.mo.inv_2pi),
                                                      0.5f))));
      a.out_particles[3 * i] = nx;
      a.out_particles[3 * i + 1] = ny;
      a.out_particles[3 * i + 2] = nth;

      const int gx = static_cast<int>(__fdiv_rn(__fsub_rn(nx, p.ox), p.res));
      const int gy = static_cast<int>(__fdiv_rn(__fsub_rn(ny, p.oy), p.res));
      if (gx >= 0 && gx < a.width && gy >= 0 && gy < a.height) {
        const int64_t cell = static_cast<int64_t>(gy) * a.width + gx;
        int b0 = static_cast<int>(rintf(__fmul_rn(nth, p.bin_scale))) + a.base;
        if (b0 < 0) b0 += a.t_bins;
        if (b0 >= a.t_bins) b0 -= a.t_bins;
        if (b0 < 0) b0 += a.t_bins;  // base can be < -T/2
        start = cell * a.row_stride + b0;
      }
    }
    if (a.phases == kProposalOnly) continue;

    float mine = -1e4f;
    const int rounds = static_cast<int>(min(static_cast<int64_t>(kGroup), per_group - c));
    for (int it = 0; it < rounds; ++it) {
      const int64_t at = __shfl_sync(kFullMask, start, it, kGroup);
      const float lp = mcl::group_window_logp<kGroup, kModel>(a.lut + at, at >= 0, s,
                                                             a.r, lane, p);
      if (lig == it && at >= 0) mine = lp;
    }
    if (i < g_hi) {
      a.out_log_weights[i] = mine;
      if (a.phases == kAll) {
        // rescale what the lane holds to the larger of the two maxima
        const float top = fmaxf(new_max, mine);
        const double keep = static_cast<double>(expf(new_max - top));
        const double ww = static_cast<double>(expf(mine - top));
        mom[0] = mom[0] * keep + ww * static_cast<double>(nx);
        mom[1] = mom[1] * keep + ww * static_cast<double>(ny);
        mom[2] = mom[2] * keep + ww * static_cast<double>(sinf(nth));
        mom[3] = mom[3] * keep + ww * static_cast<double>(cosf(nth));
        mom[4] = mom[4] * keep + ww;
        new_max = top;
      }
    }
  }
  if (a.phases != kAll) return;  // uniform: no block syncs again

  // ---- phase 3: max-shift + pose moment sums ----------------------------
  // this block's moments relative to its own max, then one hand-off
  const float lane_max = new_max;
  new_max = block_max(lane_max, s_redf);
  {
    const double scale = static_cast<double>(expf(lane_max - new_max));  // 0 for no slot
#pragma unroll
    for (int c = 0; c < kMoments; ++c) mom[c] *= scale;
  }
  block_sum_moments(mom, s_redd);
#pragma unroll
  for (int c = 0; c < kMoments; ++c) {  // no dynamic index: mom stays in registers
    if (tid == c) a.ws.pmom[c * nb + b] = mom[c];
  }
  if (tid == 0) a.ws.pmax2[b] = new_max;
  if constexpr (kSmall) {
    // the last block to arrive finishes for all: no barrier
    __threadfence();  // the chunk's log weights and the partials, device-wide
    __syncthreads();
    if (tid == 0) s_last = atomicAdd(a.ws.ticket, 1) == nb - 1;
    __syncthreads();
    if (!s_last) return;
    __threadfence();
    if (tid == 0) *a.ws.ticket = 0;  // for the next launch
  } else {
    cg::this_grid().sync();  // the launch is cooperative anyway: every block shifts its chunk
  }
  // What the tail needs from L2, all in flight at once: the first batch
  // of log weights to shift (all n in the last block, or this block's
  // chunk), the first kThreads partials for the combiner (the last
  // block, or block 0 of the barrier form), and the partial maxima.
  const int64_t s_lo = kSmall ? 0 : lo, s_hi = kSmall ? n : hi;
  float lw[kShiftLoads];
#pragma unroll
  for (int k = 0; k < kShiftLoads; ++k) {
    const int64_t i = s_lo + tid + k * kThreads;
    lw[k] = i < s_hi ? __ldcg(a.out_log_weights + i) : 0.0f;
  }
  const bool combiner = kSmall || b == 0;
  float part_max = 0.0f;
  double part[kMoments] = {0.0, 0.0, 0.0, 0.0, 0.0};
  if (combiner && tid < nb) {
    part_max = __ldcg(a.ws.pmax2 + tid);
#pragma unroll
    for (int c = 0; c < kMoments; ++c) part[c] = __ldcg(a.ws.pmom + c * nb + tid);
  }
  const float mx2 = grid_max(a.ws.pmax2, nb, s_redf);
#pragma unroll
  for (int k = 0; k < kShiftLoads; ++k) {
    const int64_t i = s_lo + tid + k * kThreads;
    if (i < s_hi) a.out_log_weights[i] = lw[k] - mx2;
  }
  for (int64_t i = s_lo + tid + kShiftLoads * kThreads; i < s_hi; i += kThreads) {
    a.out_log_weights[i] = __ldcg(a.out_log_weights + i) - mx2;
  }
  if (!combiner) return;
  // combine the partials in block order, each rescaled to the common max
  // (the difference of two floats is exact in double)
  double sum[kMoments] = {0.0, 0.0, 0.0, 0.0, 0.0};
  if (tid < nb) {
    const double scale = exp(static_cast<double>(part_max) - static_cast<double>(mx2));
#pragma unroll
    for (int c = 0; c < kMoments; ++c) sum[c] = part[c] * scale;
  }
  for (int k = tid + kThreads; k < nb; k += kThreads) {
    const double scale = exp(static_cast<double>(__ldcg(a.ws.pmax2 + k)) -
                             static_cast<double>(mx2));
#pragma unroll
    for (int c = 0; c < kMoments; ++c) sum[c] += __ldcg(a.ws.pmom + c * nb + k) * scale;
  }
  block_sum_moments(sum, s_redd);
#pragma unroll
  for (int c = 0; c < kMoments; ++c) {
    if (tid == c) a.out_sums[c] = static_cast<float>(sum[c]);
  }
  if (tid == 0) {
    a.out_sums[5] = mx2;
    a.out_sums[6] = 0.0f;
    a.out_sums[7] = 0.0f;
  }
}

size_t smem_bytes(int64_t n, int r, int table_entries, bool small) {
  return (small ? cdf_bytes(n) : 0) + mcl::stage_bytes(r, table_entries);
}

// One instantiation of the kernel: how it evaluates the beam model, the
// lanes per particle and the form of phase 1.
template <Model kModel, int kGroup, bool kSmall>
struct Form {};

// Calls f with the Form that serves r beams with or without a normaliser
// table and n particles.
template <typename F>
auto with_form(int r, bool has_table, bool small, F f) {
  if (!has_table) {
    return small ? f(Form<Model::kAnalytic, kWarp, true>{})
                 : f(Form<Model::kAnalytic, kWarp, false>{});
  }
  if (mcl::group_lanes(r, Model::kTabled) == mcl::kSmallGroup) {
    return small ? f(Form<Model::kTabled, mcl::kSmallGroup, true>{})
                 : f(Form<Model::kTabled, mcl::kSmallGroup, false>{});
  }
  return small ? f(Form<Model::kTabled, kWarp, true>{})
               : f(Form<Model::kTabled, kWarp, false>{});
}

// How the kernel is launched at (n, r): the form of phase 1, the chunk of
// particles per block and the grid.
struct Plan {
  bool small;
  int64_t chunk;
  int grid;
};

template <typename T, Model kModel, int kGroup, bool kSmall>
cudaError_t plan_as(Form<kModel, kGroup, kSmall>, int64_t n, int r, int table_entries,
                    Plan* plan) {
  constexpr int kGroups = kThreads / kGroup;
  auto kernel = mega_step_kernel<T, kModel, kGroup, kSmall>;
  const size_t smem = smem_bytes(n, r, table_entries, kSmall);
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  if (!kSmall) {
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (err != cudaSuccess) return err;
    if (!coop) return cudaErrorNotSupported;
  }
  // Opt this instantiation into all the shared memory a block may have,
  // not into this plan's size: the attribute holds for every later launch
  // of the instantiation, whatever n, r or stepper planned it.
  int optin = 0;
  cudaFuncAttributes attr;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             optin - static_cast<int>(attr.sharedSizeBytes));
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  // by the work: whole rounds of the block's groups, and no more blocks
  // than about kBlocksPerSm an SM (never more than fit at once: the
  // barrier form needs them co-resident)
  const int64_t blocks = static_cast<int64_t>(sms) * (per_sm < kBlocksPerSm ? per_sm : kBlocksPerSm);
  int64_t chunk = (n + blocks - 1) / blocks;
  chunk = (chunk + kGroups - 1) / kGroups * kGroups;
  plan->small = kSmall;
  plan->chunk = chunk;
  plan->grid = static_cast<int>((n + chunk - 1) / chunk);
  return cudaSuccess;
}

template <typename T>
cudaError_t make_plan(int64_t n, int r, int table_entries, Plan* plan) {
  if (n <= 0) return cudaErrorInvalidValue;
  return with_form(r, table_entries > 0, n <= kSmallN, [&](auto form) {
    return plan_as<T>(form, n, r, table_entries, plan);
  });
}

template <typename T, Model kModel, int kGroup, bool kSmall>
cudaError_t launch_as(Form<kModel, kGroup, kSmall>, Args<T>& a, int grid,
                      cudaStream_t stream) {
  auto kernel = mega_step_kernel<T, kModel, kGroup, kSmall>;
  const size_t smem = smem_bytes(a.n, a.r, a.table_entries, kSmall);
  if (kSmall) {  // no grid barrier: an ordinary launch
    kernel<<<grid, kThreads, smem, stream>>>(a);
    return cudaSuccess;
  }
  void* kargs[] = {&a};
  return cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel), dim3(grid),
                                     dim3(kThreads), kargs, smem, stream);
}

// ``grid``, ``chunk`` and ``small`` are the plan of mcl_mega_plan_* at this
// (n, r, table_entries), which also opted the kernel into its shared
// memory; the workspace holds workspace_bytes(n, grid) zeroed bytes.
template <typename T>
int launch(const T* lut, int64_t row_stride, const float* particles,
           const float* log_weights, const float* noise, int64_t n,
           const float* obs, const int32_t* offsets, int r, int base,
           int t_bins, int height, int width, const float* consts,
           const float* table, int table_entries, const float* scalars,
           float* out_particles, float* out_log_weights, float* out_sums,
           void* workspace, int grid, int64_t chunk, int small, int phases,
           void* stream) {
  if (n <= 0 || chunk <= 0 || grid != (n + chunk - 1) / chunk ||
      (small != 0) != (n <= kSmallN) ||
      (table != nullptr && (table_entries < 1 || table_entries > mcl::kMaxTableEntries))) {
    return cudaErrorInvalidValue;
  }
  Args<T> a;
  a.lut = lut;
  a.row_stride = row_stride;
  a.particles = particles;
  a.log_weights = log_weights;
  a.noise = noise;
  a.n = n;
  a.chunk = chunk;
  a.obs = obs;
  a.offsets = offsets;
  a.r = r;
  a.base = base;
  a.t_bins = t_bins;
  a.height = height;
  a.width = width;
  a.table = reinterpret_cast<const float2*>(table);
  a.table_entries = table ? table_entries : 0;
  a.p = mcl::params_from(consts);
  const float* mc = consts + mcl::kNumConsts;
  a.mo = Motion{mc[0], mc[1], mc[2], mc[3], mc[4]};
  static_assert(sizeof(Motion) == kNumMotionConsts * sizeof(float),
                "Motion must be kNumMotionConsts packed floats");
  a.scalars = scalars;
  a.out_particles = out_particles;
  a.out_log_weights = out_log_weights;
  a.out_sums = out_sums;
  char* base_ptr = static_cast<char*>(workspace);
  a.ws.ticket = reinterpret_cast<int*>(base_ptr);
  a.ws.psum = reinterpret_cast<double*>(base_ptr + kTicketBytes);
  a.ws.pmom = a.ws.psum + grid;
  a.ws.pmax = reinterpret_cast<float*>(a.ws.pmom + kMoments * grid);
  a.ws.pmax2 = a.ws.pmax + grid;
  a.ws.g = a.ws.pmax2 + grid;
  a.phases = phases;

  const cudaError_t err =
      with_form(r, table != nullptr, small != 0, [&](auto form) {
        return launch_as<T>(form, a, grid, static_cast<cudaStream_t>(stream));
      });
  const cudaError_t last = cudaGetLastError();  // clears a launch error
  return static_cast<int>(err != cudaSuccess ? err : last);
}

template <typename T>
int plan_out(int64_t n, int r, int table_entries, int* grid, int64_t* chunk, int* small) {
  Plan plan;
  const cudaError_t err = make_plan<T>(n, r, table_entries, &plan);
  if (err != cudaSuccess) return err;
  *grid = plan.grid;
  *chunk = plan.chunk;
  *small = plan.small ? 1 : 0;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// How the kernel launches at (n, r): its grid, the chunk of particles per
// block, and whether every block computes phase 1 itself (small) or the
// grid does across barriers.
int mcl_mega_plan_u8(int64_t n, int r, int table_entries, int* grid, int64_t* chunk,
                     int* small) {
  return plan_out<uint8_t>(n, r, table_entries, grid, chunk, small);
}

int mcl_mega_plan_u16(int64_t n, int r, int table_entries, int* grid, int64_t* chunk,
                      int* small) {
  return plan_out<uint16_t>(n, r, table_entries, grid, chunk, small);
}

int64_t mcl_mega_workspace_bytes(int64_t n, int grid) {
  return workspace_bytes(n, grid);
}

#define MCL_MEGA_ENTRY(NAME, T)                                                 \
  int NAME(const T* lut, int64_t row_stride, const float* particles,           \
           const float* log_weights, const float* noise, int64_t n,            \
           const float* obs, const int32_t* offsets, int r, int base,          \
           int t_bins, int height, int width, const float* consts,             \
           const float* table, int table_entries, const float* scalars,        \
           float* out_particles, float* out_log_weights, float* out_sums,      \
           void* workspace, int grid, int64_t chunk, int small, int phases,    \
           void* stream) {                                                      \
    return launch<T>(lut, row_stride, particles, log_weights, noise, n, obs,   \
                     offsets, r, base, t_bins, height, width, consts, table,   \
                     table_entries, scalars, out_particles, out_log_weights,   \
                     out_sums, workspace, grid, chunk, small, phases, stream); \
  }

MCL_MEGA_ENTRY(mcl_mega_step_u8, uint8_t)
MCL_MEGA_ENTRY(mcl_mega_step_u16, uint16_t)

}  // extern "C"
