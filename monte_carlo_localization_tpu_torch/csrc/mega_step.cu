// The whole MCL correction as ONE cooperative kernel launch, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel K6, monte_carlo_localization_tpu/ops/
// pallas_mega.py build_mega_step_fn -> kernel (:197, pl.pallas_call
// :485): systematic resample, motion on given noise, window addressing,
// the K1/K2 LUT likelihood, max-shift normalization and the pose moment
// sums, for a dense u8/u16 LUT. The TPU runs it as one sequential grid
// on one core; here the blocks run in parallel, so the phases are
// separated by grid-wide barriers (cooperative_groups::this_grid().sync())
// and every cross-block reduction goes through per-block partials that
// each block then reduces in block order (no float atomics: a run is
// reproducible).
//
//   phase 1, weights: mx = max(lw); w = exp(lw - mx); the inclusive prefix
//     cs of w and its total z, both in double, rounded once to float32;
//     then, in float32 as the TPU does (:243-249), g_j = n*(cs_j/z) - u0.
//     Each block owns one contiguous chunk of particles (block scan plus
//     the exclusive prefix of the block totals).
//   phase 2, per particle slot i (one warp per slot, grid-stride): the
//     ancestor is the j with g_{j-1} < i <= g_j (g_{-1} = -u0), found by a
//     binary search over g; a slot no j covers takes the row (0, 0, 0), as
//     the TPU's one-hot gather gives (:261-270). Then the displacement-form
//     motion (:274-297) with the floor-based wrap, the dense-LUT address
//     (:305-317) and the beam sum of beam_model.cuh; -1e4 off the map.
//   phase 3: mx' = max of the new log weights; out_log_weights = lp - mx';
//     S_wx, S_wy, S_wsin, S_wcos, Z in double; out_sums = [S_wx, S_wy,
//     S_wsin, S_wcos, Z, mx', 0, 0] (the layout of :436-443).
//
// What bounds it on an H100: at 4000 particles the prologue and epilogue
// move ~0.2 MB and the likelihood reads one LUT entry per beam (~0.24 MB
// at 60 beams, ~4.3 MB at 1080) and evaluates ~60 float32 operations per
// beam term: ~1-4 us of ALU or HBM time. Below that, the five grid-wide
// barriers and the serial per-block reductions over the grid's partials
// set the floor. The design keeps the whole correction in one launch, so
// the step pays one launch instead of ~116 eager ones.
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

using mcl::kWarp;
using mcl::Params;
constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarp * kWarpsPerBlock;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMoments = 5;  // S_wx, S_wy, S_wsin, S_wcos, Z

// Follows Params in the host float array (MegaStep._consts in
// ops/mega_step.py).
struct Motion {
  float disp_x, disp_y, disp_th, two_pi, inv_2pi;
};
constexpr int kNumMotionConsts = 5;

// debug_phases of pallas_mega.py (:216, :355, :406): "all", "no_epi"
// (stop before the epilogue), "pro_only" (stop after the proposal).
enum Phases { kAll = 0, kNoEpilogue = 1, kProposalOnly = 2 };

// The wrapper's scratch buffer, one allocation: doubles first.
struct Workspace {
  double* psum;  // [grid] block totals of w
  double* pmom;  // [kMoments * grid] block moment sums
  float* pmax;   // [grid] block max of the input log weights
  float* pmax2;  // [grid] block max of the new log weights
  float* g;      // [n] the scaled CDF
};

int64_t workspace_bytes(int64_t n, int grid) {
  return static_cast<int64_t>(grid) * (1 + kMoments) * sizeof(double) +
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
  const float* obs;          // (r,) observed px
  const int32_t* offsets;    // (r,) k*j + e_j
  int r, base, t_bins, height, width;
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
    v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
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
    v += __shfl_xor_sync(kFull, v, off);
  }
  __syncthreads();
  if (threadIdx.x % kWarp == 0) s_red[threadIdx.x / kWarp] = v;
  __syncthreads();
  v = s_red[0];
#pragma unroll
  for (int w = 1; w < kWarpsPerBlock; ++w) v += s_red[w];
  return v;
}

// Max over the grid's per-block partials, written before a grid sync by
// other blocks: read through L2 (__ldcg).
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

template <typename T>
__global__ void __launch_bounds__(kThreads) mega_step_kernel(Args<T> a) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float smem[];
  float* s_obs = smem;
  int32_t* s_off = reinterpret_cast<int32_t*>(smem + a.r);
  __shared__ float s_redf[kWarpsPerBlock];
  __shared__ double s_redd[kWarpsPerBlock];
  __shared__ double s_scan[kWarpsPerBlock];

  const Params& p = a.p;
  const int tid = threadIdx.x;
  const int lane = tid % kWarp;
  const int warp = tid / kWarp;
  const int b = blockIdx.x;
  const int nb = gridDim.x;
  const int64_t n = a.n;
  for (int j = tid; j < a.r; j += kThreads) {
    s_obs[j] = fminf(a.obs[j], p.m);
    s_off[j] = a.offsets[j];
  }
  const float ds = a.scalars[0];
  const float dth = a.scalars[1];
  const bool straight = a.scalars[2] > 0.5f;
  const float u0 = a.scalars[3];

  // this block's contiguous chunk, for the scan and the epilogue
  const int64_t chunk = (n + nb - 1) / nb;
  const int64_t lo = min(n, static_cast<int64_t>(b) * chunk);
  const int64_t hi = min(n, lo + chunk);

  // ---- phase 1: weights -> the scaled CDF g -----------------------------
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
  const float nf = static_cast<float>(n);
  for (int64_t t0 = lo; t0 < hi; t0 += kThreads) {
    const int64_t i = t0 + tid;
    double v = i < hi ? static_cast<double>(expf(a.log_weights[i] - mx)) : 0.0;
#pragma unroll
    for (int off = 1; off < kWarp; off <<= 1) {
      const double up = __shfl_up_sync(kFull, v, off);
      if (lane >= off) v += up;
    }
    if (lane == kWarp - 1) s_scan[warp] = v;
    __syncthreads();
    double before = carry;
    for (int w = 0; w < warp; ++w) before += s_scan[w];
    if (i < hi) {
      const float cs = static_cast<float>(before + v);
      a.ws.g[i] = __fsub_rn(__fmul_rn(nf, __fdiv_rn(cs, z)), u0);
    }
    for (int w = 0; w < kWarpsPerBlock; ++w) carry += s_scan[w];
    __syncthreads();  // s_scan is rewritten by the next tile
  }
  grid.sync();

  // ---- phase 2: resample + motion + likelihood, one warp per slot -------
  const float safe_dth = fabsf(dth) < 1e-12f ? 1.0f : dth;
  const float chord =
      __fmul_rn(ds, __fdiv_rn(__fmul_rn(2.0f, sinf(__fmul_rn(dth, 0.5f))),
                              safe_dth));
  const float half_dth = __fmul_rn(dth, 0.5f);
  float new_max = -INFINITY;
  const int64_t warps = static_cast<int64_t>(nb) * kWarpsPerBlock;
  for (int64_t i = static_cast<int64_t>(b) * kWarpsPerBlock + warp; i < n;
       i += warps) {
    const float slot = static_cast<float>(i);
    int64_t j0 = 0, j1 = n;  // first j with g_j >= slot
    while (j0 < j1) {
      const int64_t mid = (j0 + j1) / 2;
      if (__ldcg(a.ws.g + mid) >= slot) {
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
    float nx, ny, nth;
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
    if (lane == 0) {
      a.out_particles[3 * i] = nx;
      a.out_particles[3 * i + 1] = ny;
      a.out_particles[3 * i + 2] = nth;
    }
    if (a.phases == kProposalOnly) continue;

    const int gx = static_cast<int>(__fdiv_rn(__fsub_rn(nx, p.ox), p.res));
    const int gy = static_cast<int>(__fdiv_rn(__fsub_rn(ny, p.oy), p.res));
    float lp = -1e4f;
    if (gx >= 0 && gx < a.width && gy >= 0 && gy < a.height) {
      const int64_t cell = static_cast<int64_t>(gy) * a.width + gx;
      int b0 = static_cast<int>(rintf(__fmul_rn(nth, p.bin_scale))) + a.base;
      if (b0 < 0) b0 += a.t_bins;
      if (b0 >= a.t_bins) b0 -= a.t_bins;
      if (b0 < 0) b0 += a.t_bins;  // base can be < -T/2
      const T* window = a.lut + cell * a.row_stride + b0;
      lp = mcl::warp_window_logp(window, s_obs, s_off, a.r, lane, p);
    }
    if (lane == 0) a.out_log_weights[i] = lp;
    new_max = fmaxf(new_max, lp);
  }
  if (a.phases == kProposalOnly) return;  // uniform: no block syncs again
  new_max = block_max(new_max, s_redf);
  if (tid == 0) a.ws.pmax2[b] = new_max;
  grid.sync();
  if (a.phases == kNoEpilogue) return;

  // ---- phase 3: max-shift + pose moment sums ----------------------------
  const float mx2 = grid_max(a.ws.pmax2, nb, s_redf);
  double mom[kMoments] = {0.0, 0.0, 0.0, 0.0, 0.0};
  for (int64_t i = lo + tid; i < hi; i += kThreads) {
    const float lp = __ldcg(a.out_log_weights + i);
    const double ww = static_cast<double>(expf(lp - mx2));
    const float th = __ldcg(a.out_particles + 3 * i + 2);
    mom[0] += ww * static_cast<double>(__ldcg(a.out_particles + 3 * i));
    mom[1] += ww * static_cast<double>(__ldcg(a.out_particles + 3 * i + 1));
    mom[2] += ww * static_cast<double>(sinf(th));
    mom[3] += ww * static_cast<double>(cosf(th));
    mom[4] += ww;
    a.out_log_weights[i] = lp - mx2;
  }
  for (int c = 0; c < kMoments; ++c) {
    const double s = block_sum(mom[c], s_redd);
    if (tid == 0) a.ws.pmom[c * nb + b] = s;
  }
  grid.sync();
  if (b == 0) {
    for (int c = 0; c < kMoments; ++c) {
      const double s = grid_sum(a.ws.pmom + c * nb, nb, s_redd);
      if (tid == 0) a.out_sums[c] = static_cast<float>(s);
    }
    if (tid == 0) {
      a.out_sums[5] = mx2;
      a.out_sums[6] = 0.0f;
      a.out_sums[7] = 0.0f;
    }
  }
}

size_t smem_bytes(int r) {
  return static_cast<size_t>(r) * (sizeof(float) + sizeof(int32_t));
}

template <typename T>
cudaError_t allow_smem(int r) {
  const size_t smem = smem_bytes(r);
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(mega_step_kernel<T>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// The co-resident grid on the current device: blocks per SM at this
// shared-memory size times the SM count.
template <typename T>
int grid_size(int r, int* blocks) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int coop = 0, sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = allow_smem<T>(r);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, mega_step_kernel<T>, kThreads, smem_bytes(r));
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  *blocks = per_sm * sms;
  return cudaSuccess;
}

template <typename T>
int launch(const T* lut, int64_t row_stride, const float* particles,
           const float* log_weights, const float* noise, int64_t n,
           const float* obs, const int32_t* offsets, int r, int base,
           int t_bins, int height, int width, const float* consts,
           const float* scalars, float* out_particles, float* out_log_weights,
           float* out_sums, void* workspace, int grid, int phases,
           void* stream) {
  if (n <= 0 || grid <= 0) return cudaErrorInvalidValue;
  Args<T> a;
  a.lut = lut;
  a.row_stride = row_stride;
  a.particles = particles;
  a.log_weights = log_weights;
  a.noise = noise;
  a.n = n;
  a.obs = obs;
  a.offsets = offsets;
  a.r = r;
  a.base = base;
  a.t_bins = t_bins;
  a.height = height;
  a.width = width;
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
  a.ws.psum = reinterpret_cast<double*>(base_ptr);
  a.ws.pmom = a.ws.psum + grid;
  a.ws.pmax = reinterpret_cast<float*>(a.ws.pmom + kMoments * grid);
  a.ws.pmax2 = a.ws.pmax + grid;
  a.ws.g = a.ws.pmax2 + grid;
  a.phases = phases;

  cudaError_t err = allow_smem<T>(r);
  if (err != cudaSuccess) return err;
  void* kargs[] = {&a};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(mega_step_kernel<T>), dim3(grid), dim3(kThreads),
      kargs, smem_bytes(r), static_cast<cudaStream_t>(stream));
  const cudaError_t last = cudaGetLastError();  // clears a launch error
  return static_cast<int>(err != cudaSuccess ? err : last);
}

}  // namespace

extern "C" {

int mcl_mega_grid_size_u8(int r, int* blocks) {
  return grid_size<uint8_t>(r, blocks);
}

int mcl_mega_grid_size_u16(int r, int* blocks) {
  return grid_size<uint16_t>(r, blocks);
}

int64_t mcl_mega_workspace_bytes(int64_t n, int grid) {
  return workspace_bytes(n, grid);
}

int mcl_mega_step_u8(const uint8_t* lut, int64_t row_stride,
                     const float* particles, const float* log_weights,
                     const float* noise, int64_t n, const float* obs,
                     const int32_t* offsets, int r, int base, int t_bins,
                     int height, int width, const float* consts,
                     const float* scalars, float* out_particles,
                     float* out_log_weights, float* out_sums, void* workspace,
                     int grid, int phases, void* stream) {
  return launch<uint8_t>(lut, row_stride, particles, log_weights, noise, n,
                         obs, offsets, r, base, t_bins, height, width, consts,
                         scalars, out_particles, out_log_weights, out_sums,
                         workspace, grid, phases, stream);
}

int mcl_mega_step_u16(const uint16_t* lut, int64_t row_stride,
                      const float* particles, const float* log_weights,
                      const float* noise, int64_t n, const float* obs,
                      const int32_t* offsets, int r, int base, int t_bins,
                      int height, int width, const float* consts,
                      const float* scalars, float* out_particles,
                      float* out_log_weights, float* out_sums,
                      void* workspace, int grid, int phases, void* stream) {
  return launch<uint16_t>(lut, row_stride, particles, log_weights, noise, n,
                          obs, offsets, r, base, t_bins, height, width,
                          consts, scalars, out_particles, out_log_weights,
                          out_sums, workspace, grid, phases, stream);
}

}  // extern "C"
