// Fused range-LUT lookup + analytic beam-model log-likelihood, one value
// per particle, for Hopper (sm_90a).
//
// Replaces the TPU kernel monte_carlo_localization_tpu/ops/pallas_lut.py
// build_lut_query_fn -> kernel (:450) in all three of its forms: K1, the
// full-window reduce (block_logp, :420); K2, the compact-beam form
// (block_logp_compact, :434), which differs only in the order of the
// beam sum, so one kernel serves both beam counts; and K3, the sub-bin
// heading lerp (subbin, next_bin/lerp_bins :383-398, used at :499-500),
// a template flag: the window starts at floor(theta * T / 2pi) and each
// beam lerps toward its +1 bin by the fractional bin (beam_model.cuh
// window_range). The lerp reads one more LUT entry per beam from the
// same row, so K3's bound is K1's plus a subtract, multiply and add per
// beam.
//
// What it computes is query(lut_flat, particles, obs_px, row_map) of
// pallas_lut.py:835-949 for one map:
//   cell  = (int)((y - oy) / res) * W + (int)((x - ox) / res)   (truncating)
//   row   = row_map ? row_map[cell] : cell
//   b0    = (rint(theta * T / 2pi) + base) mod T                (half to even)
//   d_j   = lut[row * row_stride + b0 + off_j],  off_j = k*j + e_j
//   (subbin: b0 from floor, d_j lerped toward lut[... + off_j + 1])
//   out   = inv_squash * sum_j log p(min(obs_j, m) | min(d_j, m))
// and -1e4 for a particle outside the map. Rows carry angle-wraparound
// padding, so every beam index stays inside its row: no modulo per beam.
// Offsets are 64-bit: the Spielberg compact LUT (3.4 M rows x 3072 B) is
// far past 2^31 entries.
//
// What bounds it on an H100: at 4000 particles x 1080 beams one launch
// reads ~4.3 MB of LUT (a warp reads 32 neighbouring entries of one row
// per step, so the reads coalesce) and evaluates ~4.3 M beam terms (two
// exp, two erf approximations, two log each): a few microseconds of HBM
// or ALU time. Launch latency bounds it at these shapes, so the design
// stays simple: one warp per particle, lane l takes beams l, l+32, ...,
// and a warp-shuffle sum. A block of 8 warps stages min(obs, m) and the
// beam offsets in shared memory once.
//
// Numerics follow the TPU kernel in float32, through the beam model that
// beam_model.cuh shares with mega_step.cu. Only the beam sum is wider: it
// accumulates in double.

#include <cstdint>

#include <cuda_runtime.h>

#include "beam_model.cuh"

namespace {

using mcl::kWarp;
using mcl::Params;
constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarp * kWarpsPerBlock;

template <typename T, bool kSubbin>
__global__ void __launch_bounds__(kThreads)
    lut_loglik_kernel(const T* __restrict__ lut, int64_t row_stride,
                      const int32_t* __restrict__ row_map,
                      const float* __restrict__ particles, int64_t n,
                      const float* __restrict__ obs_px,
                      const int32_t* __restrict__ offsets, int r, int base,
                      int t_bins, int height, int width, Params p,
                      float* __restrict__ out) {
  extern __shared__ float smem[];
  float* s_obs = smem;
  int32_t* s_off = reinterpret_cast<int32_t*>(smem + r);
  for (int j = threadIdx.x; j < r; j += blockDim.x) {
    s_obs[j] = fminf(obs_px[j], p.m);
    s_off[j] = offsets[j];
  }
  __syncthreads();

  const int lane = threadIdx.x % kWarp;
  const int64_t i =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / kWarp;
  if (i >= n) return;  // whole warps leave together; no later __syncthreads

  mcl::Window w;
  if (!mcl::particle_window<kSubbin>(particles[3 * i], particles[3 * i + 1],
                                     particles[3 * i + 2], row_map, base,
                                     t_bins, height, width, p, &w)) {
    if (lane == 0) out[i] = -1e4f;
    return;
  }
  const T* window = lut + w.row * row_stride + w.b0;
  const float logw = mcl::warp_window_logp<T, kSubbin>(window, s_obs, s_off,
                                                       r, lane, p, w.frac);
  if (lane == 0) out[i] = logw;
}

template <typename T>
int launch(const T* lut, int64_t row_stride, const int32_t* row_map,
           const float* particles, int64_t n, const float* obs_px,
           const int32_t* offsets, int r, int base, int t_bins, int height,
           int width, int subbin, const float* consts, float* out,
           void* stream) {
  if (n <= 0) return 0;
  const Params p = mcl::params_from(consts);
  const int64_t blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const size_t smem = static_cast<size_t>(r) * (sizeof(float) + sizeof(int32_t));
  auto kernel = subbin ? lut_loglik_kernel<T, true> : lut_loglik_kernel<T, false>;
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      lut, row_stride, row_map, particles, n, obs_px, offsets, r, base,
      t_bins, height, width, p, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int mcl_lut_loglik_u8(const uint8_t* lut, int64_t row_stride,
                      const int32_t* row_map, const float* particles,
                      int64_t n, const float* obs_px, const int32_t* offsets,
                      int r, int base, int t_bins, int height, int width,
                      int subbin, const float* consts, float* out,
                      void* stream) {
  return launch<uint8_t>(lut, row_stride, row_map, particles, n, obs_px,
                         offsets, r, base, t_bins, height, width, subbin,
                         consts, out, stream);
}

int mcl_lut_loglik_u16(const uint16_t* lut, int64_t row_stride,
                       const int32_t* row_map, const float* particles,
                       int64_t n, const float* obs_px, const int32_t* offsets,
                       int r, int base, int t_bins, int height, int width,
                       int subbin, const float* consts, float* out,
                       void* stream) {
  return launch<uint16_t>(lut, row_stride, row_map, particles, n, obs_px,
                          offsets, r, base, t_bins, height, width, subbin,
                          consts, out, stream);
}

const char* mcl_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
