// The shear-sweep range-LUT builder as one Hopper kernel (sm_90a).
//
// Replaces the JAX package's device LUT builder, which is XLA, not Pallas:
// a lax.scan over the grid lines per bin group
// (monte_carlo_localization_tpu/mapping/range_lut_device.py:35-77, driven
// by build_range_lut_jax :102 and build_compact_range_lut_jax :207). For
// theta bin b, shearing every grid line by the ray's per-line drift makes
// all rays straight, so one sweep over the P lines along the driving axis
// gives every cell's distance to the first occupied cell:
//
//   D_p[q] = occupied(p, q) ? 0 : D_{p+d}[q + rel(p, b)] + 1   (0 off the line)
//   px     = clip(D_p[q] * step_len[b] - 1, 0, max_range_px)
//   lut[row(cell), bin] = (px + 0.5) truncated to u8 / u16
//
// One launch serves one bin group (driving axis, sweep direction): block
// b sweeps group position b, its threads over the Q cells of a line, D
// double-buffered in shared memory with one __syncthreads per line (the
// shift reads the previous line's D, never the one being written).
// Numerics are the JAX and native builders' bit for bit: the product and
// the subtraction round separately (__fmul_rn, __fsub_rn: nvcc would
// contract them into one FMA), the store truncates toward zero, and the
// drift table `rel` comes from the host's float64 shear (np.rint).
//
// Bound: the bytes it writes, one entry per (cell, bin) (5.76 GB for
// Spielberg's dense 1440-bin LUT: 1.7 ms at 3.35 TB/s). This first form
// stores one byte (u8) or two (u16) per thread at row-stride distance, a
// 32 B sector each, so it is expected 30-300x off that bound; coalescing
// the stores (several bins per block, staged through shared memory) is a
// later redesign's work. Offsets are 64-bit: basement's 5.13 GB compact
// LUT already passes 2^31 bytes.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 256;

template <typename OutT>
__global__ void __launch_bounds__(kMaxThreads)
    range_lut_sweep_kernel(const uint8_t* __restrict__ occupied,  // cells, 0/1
                           const int8_t* __restrict__ rel,         // (P, B)
                           const float* __restrict__ step_len,     // (B,)
                           const int32_t* __restrict__ bins,       // (B,) physical bins
                           const int32_t* __restrict__ row_map,    // (cells,) or null
                           int p_len, int q_len, int b_count, int64_t p_stride,
                           int64_t q_stride, int forward, float maxr, int64_t row_stride,
                           int64_t row_base, OutT* __restrict__ out) {
  extern __shared__ float s_d[];  // 2 x q_len: the previous and the current line
  float* prev = s_d;
  float* cur = s_d + q_len;
  const int b = blockIdx.x;
  for (int q = threadIdx.x; q < q_len; q += blockDim.x) prev[q] = 0.0f;
  __syncthreads();
  const float sl = step_len[b];
  const int64_t bin = bins[b];
  for (int i = 0; i < p_len; ++i) {
    const int p = forward ? i : p_len - 1 - i;
    const int r = rel[static_cast<int64_t>(p) * b_count + b];
    for (int q = threadIdx.x; q < q_len; q += blockDim.x) {
      const int qn = q + r;
      const float nxt = (qn >= 0 && qn < q_len) ? prev[qn] : 0.0f;
      const int64_t cell = p * p_stride + q * q_stride;
      const float d = occupied[cell] ? 0.0f : __fadd_rn(nxt, 1.0f);
      cur[q] = d;
      int64_t row = cell;
      if (row_map != nullptr) {
        row = row_map[cell];
        if (row == 0) continue;  // the shared far row, pre-filled
      }
      const float px = fminf(fmaxf(__fsub_rn(__fmul_rn(d, sl), 1.0f), 0.0f), maxr);
      out[(row_base + row) * row_stride + bin] =
          static_cast<OutT>(__float2uint_rz(__fadd_rn(px, 0.5f)));
    }
    __syncthreads();
    float* t = prev;
    prev = cur;
    cur = t;
  }
}

// Opt the instantiation into all the dynamic shared memory a block may
// have, once per device: the attribute holds for every later launch.
template <typename OutT>
cudaError_t opt_in_smem() {
  static unsigned done = 0;  // a bit per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned bit = dev < 32 ? 1u << dev : 0u;
  if (done & bit) return cudaSuccess;
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(range_lut_sweep_kernel<OutT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (err == cudaSuccess) done |= bit;
  return err;
}

template <typename OutT>
int launch(const uint8_t* occupied, const int8_t* rel, const float* step_len,
           const int32_t* bins, const int32_t* row_map, int p_len, int q_len, int b_count,
           int64_t p_stride, int64_t q_stride, int forward, float maxr, int64_t row_stride,
           int64_t row_base, OutT* out, void* stream) {
  if (p_len <= 0 || q_len <= 0 || b_count <= 0) return 0;
  const size_t smem = 2 * static_cast<size_t>(q_len) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = opt_in_smem<OutT>();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int threads = (q_len + 31) / 32 * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  range_lut_sweep_kernel<OutT><<<b_count, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      occupied, rel, step_len, bins, row_map, p_len, q_len, b_count, p_stride, q_stride,
      forward, maxr, row_stride, row_base, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int mcl_range_lut_sweep_u8(const uint8_t* occupied, const int8_t* rel, const float* step_len,
                           const int32_t* bins, const int32_t* row_map, int p_len, int q_len,
                           int b_count, int64_t p_stride, int64_t q_stride, int forward,
                           float maxr, int64_t row_stride, int64_t row_base, uint8_t* out,
                           void* stream) {
  return launch<uint8_t>(occupied, rel, step_len, bins, row_map, p_len, q_len, b_count,
                         p_stride, q_stride, forward, maxr, row_stride, row_base, out, stream);
}

int mcl_range_lut_sweep_u16(const uint8_t* occupied, const int8_t* rel, const float* step_len,
                            const int32_t* bins, const int32_t* row_map, int p_len, int q_len,
                            int b_count, int64_t p_stride, int64_t q_stride, int forward,
                            float maxr, int64_t row_stride, int64_t row_base, uint16_t* out,
                            void* stream) {
  return launch<uint16_t>(occupied, rel, step_len, bins, row_map, p_len, q_len, b_count,
                          p_stride, q_stride, forward, maxr, row_stride, row_base, out, stream);
}

}  // extern "C"
