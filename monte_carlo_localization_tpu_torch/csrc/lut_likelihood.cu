// Fused range-LUT lookup + analytic beam-model log-likelihood, one value
// per particle, for Hopper (sm_90a).
//
// Replaces the TPU kernel monte_carlo_localization_tpu/ops/pallas_lut.py
// build_lut_query_fn -> kernel (:450) in both of its forms: K1, the
// full-window reduce (block_logp, :420), and K2, the compact-beam form
// (block_logp_compact, :434). The two differ only in the order of the
// beam sum, so one kernel serves both beam counts.
//
// What it computes is query(lut_flat, particles, obs_px, row_map) of
// pallas_lut.py:835-949 for one map:
//   cell  = (int)((y - oy) / res) * W + (int)((x - ox) / res)   (truncating)
//   row   = row_map ? row_map[cell] : cell
//   b0    = (rint(theta * T / 2pi) + base) mod T                (half to even)
//   d_j   = lut[row * row_stride + b0 + off_j],  off_j = k*j + e_j
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
// Numerics follow the TPU kernel in float32: the Abramowitz & Stegun
// 7.1.26 erf (pallas_lut.py:62-74), IEEE division (build without
// --use_fast_math), constants folded from double on the host. Only the
// beam sum is wider: it accumulates in double (see below).

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarp * kWarpsPerBlock;

// Layout of the host float array ``consts`` (LUTQuery._consts in
// ops/lut_query.py).
struct Params {
  float res, ox, oy, bin_scale, m;
  float gauss_coef, inv2s2, short2, z_short, z_max, z_rand, z_hit;
  float rand_term, sq2, inv_squash;
};
constexpr int kNumConsts = 15;

__device__ __forceinline__ float erf_as(float x) {
  const float sign = x < 0.0f ? -1.0f : 1.0f;
  const float ax = fabsf(x);
  const float t = 1.0f / (1.0f + 0.3275911f * ax);
  const float poly =
      t * (0.254829592f +
           t * (-0.284496736f +
                t * (1.421413741f + t * (-1.453152027f + t * 1.061405429f))));
  return sign * (1.0f - poly * expf(-ax * ax));
}

// pallas_lut.py beam_model (:400-418) for one beam; obs is already clipped.
__device__ __forceinline__ float beam_logp(float d, float obs,
                                           const Params& p) {
  d = fminf(d, p.m);
  const float z = obs - d;
  float prob = p.gauss_coef * expf(-(z * z) * p.inv2s2);
  if (obs < d) prob += p.short2 * (d - obs) / fmaxf(d, 1.0f);
  if (obs >= p.m) prob += p.z_max;
  if (obs < p.m) prob += p.rand_term;
  const float gauss_sum = 0.5f * (erf_as((p.m - d + 0.5f) / p.sq2) -
                                  erf_as((-d - 0.5f) / p.sq2));
  const float norm = p.z_hit * gauss_sum +
                     (d > 0.0f ? p.z_short * (d + 1.0f) : 0.0f) + p.z_max +
                     p.z_rand;
  return logf(fmaxf(prob, 1e-35f)) - logf(norm);
}

template <typename T>
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

  const float x = particles[3 * i];
  const float y = particles[3 * i + 1];
  const float theta = particles[3 * i + 2];
  const int gx = static_cast<int>((x - p.ox) / p.res);
  const int gy = static_cast<int>((y - p.oy) / p.res);
  if (gx < 0 || gx >= width || gy < 0 || gy >= height) {
    if (lane == 0) out[i] = -1e4f;
    return;
  }
  const int64_t cell = static_cast<int64_t>(gy) * width + gx;
  const int64_t row = row_map ? static_cast<int64_t>(row_map[cell]) : cell;
  int b0 = static_cast<int>(rintf(theta * p.bin_scale));
  b0 = (b0 + base) % t_bins;  // truncating remainder, then fixed up
  if (b0 < 0) b0 += t_bins;
  const T* window = lut + row * row_stride + b0;

  // the beam sum accumulates in double: the float32 result is then the
  // rounded sum of the float32 terms whatever the summation order, so
  // the kernel and its plain version agree to ~1 ulp at 1080 beams
  double acc = 0.0;
  for (int j = lane; j < r; j += kWarp) {
    acc += beam_logp(static_cast<float>(window[s_off[j]]), s_obs[j], p);
  }
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    acc += __shfl_down_sync(0xffffffffu, acc, off);
  }
  if (lane == 0) out[i] = p.inv_squash * static_cast<float>(acc);
}

template <typename T>
int launch(const T* lut, int64_t row_stride, const int32_t* row_map,
           const float* particles, int64_t n, const float* obs_px,
           const int32_t* offsets, int r, int base, int t_bins, int height,
           int width, const float* consts, float* out, void* stream) {
  if (n <= 0) return 0;
  Params p;
  static_assert(sizeof(Params) == kNumConsts * sizeof(float),
                "Params must be kNumConsts packed floats");
  float* fields = reinterpret_cast<float*>(&p);
  for (int c = 0; c < kNumConsts; ++c) fields[c] = consts[c];
  const int64_t blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const size_t smem = static_cast<size_t>(r) * (sizeof(float) + sizeof(int32_t));
  lut_loglik_kernel<T><<<static_cast<unsigned>(blocks), kThreads, smem,
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
                      const float* consts, float* out, void* stream) {
  return launch<uint8_t>(lut, row_stride, row_map, particles, n, obs_px,
                         offsets, r, base, t_bins, height, width, consts, out,
                         stream);
}

int mcl_lut_loglik_u16(const uint16_t* lut, int64_t row_stride,
                       const int32_t* row_map, const float* particles,
                       int64_t n, const float* obs_px, const int32_t* offsets,
                       int r, int base, int t_bins, int height, int width,
                       const float* consts, float* out, void* stream) {
  return launch<uint16_t>(lut, row_stride, row_map, particles, n, obs_px,
                          offsets, r, base, t_bins, height, width, consts, out,
                          stream);
}

const char* mcl_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
