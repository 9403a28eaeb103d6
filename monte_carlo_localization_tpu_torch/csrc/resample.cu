// The systematic resampler's weight CDF and inversion as one kernel, for
// Hopper (sm_90a): from the float32 softmax of each row and the row's
// offset u0 to the int32 source index of each of its m output slots.
//
// Replaces no TPU kernel. In the JAX package this is XLA's work
// (monte_carlo_localization_tpu/ops/resample.py systematic_resample_indices,
// :16-91); the port ran it as ~42 small PyTorch kernels (ops/resample.py
// weight_cdf and systematic_invert_cdf_window) until an H100 profile of
// the benchmark's cells showed them at 57-61% of the card's time in a
// correction, most of it one scatter_reduce("amax") whose atomics collide
// where zero-weight sources all aim at the slot of the source covering
// them. It computes, for each row independently:
//   cdf[j] = (float) Hillis-Steele inclusive prefix sum, in double, of w
//   g[j]   = m * cdf[j] - u0                      (float32, two roundings)
//   out[s] = the first j in [0, n - 1) with g[j] >= s, else n - 1
// which is ops/resample.py's rule (the amax scatter of each source's first
// slot floor(g[j-1]) + 1, a cumulative max and the slot-0 seed; floor(x) <
// s <=> x < s for an integer s) and the benchmark reference's
// searchsorted(side="left") over g[:-1], wherever g is non-decreasing, as
// a prefix sum of non-negative weights is up to its float64 rounding.
//
// Numerics: the doubling pairs the same terms as prefix_sum_doubling
// (b[i] = a[i] + a[i - s], a[i - s] = 0 for i < s, s = 1, 2, 4, ... < n),
// each double add is correctly rounded, and the CDF is rounded to float32
// once, so it is bit-equal to weight_cdf; a scan in any other order can
// move the last float32 bit and hand a knife-edge slot to a neighbour.
// g uses the _rn intrinsics so nothing is contracted into an FMA, as
// PyTorch's separate multiply and subtract kernels round.
//
// What binds it on an H100, and what the design does about it. A row of
// 4000 reads 16 KB and writes 16 KB (0.01 us at 3.35 TB/s) and needs 48k
// double adds (1.4 ns): the bound is a launch and the block's own
// latency, so the whole row stays in one block's shared memory:
//   - one block of up to 1024 threads a row, so a fleet's (F, n) rows are
//     F blocks of one launch; no atomics, no scatter, no second pass;
//   - the doubling is bound by shared memory's bandwidth (128 B a clock
//     an SM), so each thread keeps its (up to 16) elements in registers
//     and a round costs one store and one load of 8 B an element, one
//     __syncthreads (12 rounds at 4000), alternating between two float64
//     buffers; g (float32) goes into the buffer the last round left free:
//     16 B an element, so a row fits up to the opt-in shared memory over
//     16 (14,528 on an H100), which mcl_resample_max_row reports; longer
//     rows stay on the PyTorch path;
//   - each slot finds its source by a binary search of g in shared memory
//     (12 reads at 4000): the work is the same for every slot whatever the
//     weights, where a source that covers many slots would serialize a
//     thread that wrote them; a thread runs its slots' searches in
//     lockstep, so their reads' latencies overlap.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kWarp = 32;
constexpr int kMaxPer = 16;  // elements a thread keeps in registers
constexpr int kRowBytes = 2 * sizeof(double);  // the two scan buffers; g reuses one

// Thread t keeps elements t, t + blockDim.x, ... (kPer of them) in
// registers through the doubling; a round stores them, waits, and adds
// a[i - s] from the buffer it stored to: 16 B of shared memory traffic an
// element a round, one __syncthreads. Rounds alternate buffers, so a
// round's stores never meet the previous round's reads.
template <int kPer>
__global__ void __launch_bounds__(kMaxThreads)
    systematic_resample_kernel(const float* __restrict__ weights, int n,
                               const float* __restrict__ u0, int u0_stride, int m,
                               int32_t* __restrict__ out) {
  extern __shared__ double smem[];
  const int64_t row = blockIdx.x;
  const int t = threadIdx.x, step = blockDim.x;
  const float* w = weights + row * n;
  double x[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int i = t + k * step;
    x[k] = i < n ? static_cast<double>(w[i]) : 0.0;
  }
  int r = 0;
  for (int s = 1; s < n; s <<= 1, ++r) {
    double* a = smem + (r & 1) * n;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {  // only what the round reads: a[0 .. n-s)
      const int i = t + k * step;
      if (i < n - s) a[i] = x[k];
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kPer; ++k) {  // i < s adds the zero head: x + 0.0 == x, x >= +0
      const int i = t + k * step;
      if (i >= s && i < n) x[k] = __dadd_rn(x[k], a[i - s]);
    }
  }
  // the buffer the last round did not read
  float* g = reinterpret_cast<float*>(smem + (r & 1) * n);
  const float mf = static_cast<float>(m);
  const float off = u0[row * u0_stride];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int i = t + k * step;
    if (i < n) g[i] = __fsub_rn(__fmul_rn(mf, __double2float_rn(x[k])), off);
  }
  __syncthreads();
  // Slot s takes how many of g[0 .. n-2] lie below it (compared in double:
  // s may pass 2^24). A thread searches kPer slots at once, so their
  // shared-memory reads overlap; the lower bound halves a span whose
  // length is the same for every slot, so the searches run in lockstep.
  int32_t* o = out + row * m;
  const int len = n - 1;
  for (int s0 = t; s0 < m; s0 += kPer * step) {
    int base[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k) base[k] = 0;
    for (int span = len; span > 1; span -= span >> 1) {
      const int half = span >> 1;
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const double slot = static_cast<double>(s0 + k * step);
        if (static_cast<double>(g[base[k] + half]) < slot) base[k] += half;
      }
    }
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int s = s0 + k * step;
      if (s < m) {
        o[s] = base[k] + (len > 0 && static_cast<double>(g[base[k]]) < static_cast<double>(s));
      }
    }
  }
}

// Calls f(kernel instantiation) for the elements a thread keeps at n:
// the least power of two that lets 1024 threads hold the row.
template <typename F>
cudaError_t with_per(int n, F&& f) {
  if (n <= kMaxThreads) return f(systematic_resample_kernel<1>, 1);
  if (n <= 2 * kMaxThreads) return f(systematic_resample_kernel<2>, 2);
  if (n <= 4 * kMaxThreads) return f(systematic_resample_kernel<4>, 4);
  if (n <= 8 * kMaxThreads) return f(systematic_resample_kernel<8>, 8);
  if (n <= kMaxPer * kMaxThreads) return f(systematic_resample_kernel<kMaxPer>, kMaxPer);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// The longest row the kernel takes on the current device (its opt-in
// shared memory a block over kRowBytes, and what 1024 threads hold), into
// *max_row; opts every instantiation into that shared memory, which holds
// for every later launch.
int mcl_resample_max_row(int* max_row) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  for (int per = 1; per <= kMaxPer; per *= 2) {
    err = with_per(per * kMaxThreads, [&](auto kernel, int) {
      return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    });
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int fits = optin / kRowBytes;
  *max_row = fits < kMaxPer * kMaxThreads ? fits : kMaxPer * kMaxThreads;
  return 0;
}

// out (rows, m) int32: each row's source indices from weights (rows, n)
// float32 and u0[row * u0_stride] (u0_stride 0: one offset for every
// row). n must be 1 .. mcl_resample_max_row's, asked on this device first.
int mcl_systematic_resample(const float* weights, int rows, int n, const float* u0,
                            int u0_stride, int m, int32_t* out, void* stream) {
  if (rows < 1 || n < 1 || m < 0 || (u0_stride != 0 && u0_stride != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err = with_per(n, [&](auto kernel, int per) {
    // enough threads to hold the row, and up to 1024 for the slots' searches
    const int hold = (n + per - 1) / per;
    const int most = hold > m ? hold : (m < kMaxThreads ? m : kMaxThreads);
    const int threads = (most + kWarp - 1) / kWarp * kWarp;
    kernel<<<rows, threads, static_cast<size_t>(kRowBytes) * n,
             static_cast<cudaStream_t>(stream)>>>(weights, n, u0, u0_stride, m, out);
    return cudaSuccess;
  });
  const cudaError_t last = cudaGetLastError();  // clears a launch error
  return static_cast<int>(err != cudaSuccess ? err : last);
}

}  // extern "C"
