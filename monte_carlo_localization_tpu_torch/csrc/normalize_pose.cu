// The normalization and pose of a correction as one kernel, for Hopper
// (sm_90a): from each row's float32 log likelihoods and the proposal to
// the max-shifted log weights, the row's log quality and its weighted-mean
// pose, in one launch for every row of a fleet.
//
// Replaces no TPU kernel. In the JAX package this is XLA's work
// (monte_carlo_localization_tpu/filter/core.py: the logsumexp, the max
// shift and expected_pose); the port ran it as ~20 small PyTorch kernels
// (filter/core.py normalize_pose's plain branch: logsumexp, amax, the
// shift, softmax, four weighted sums, stack and atan2) until an H100
// profile of the benchmark's replay cells showed them at about two thirds
// of the card's time in a correction, all of it launch floors and the
// stock reductions' own latency. It computes, for row r of n entries l:
//   m          = max(l), NaN if any entry is NaN (torch.amax)
//   shifted[i] = l[i] - m                          (one float32 subtraction)
//   e[i]       = exp((double) l[i] - (double) m)
//   log_q      = (float) (m + log(sum e) - log(n))
//   pose       = (float) (sum e x / sum e, sum e y / sum e,
//                         atan2(sum e sin th, sum e cos th))
// with the five sums in float64. A row whose max is not finite (all -inf,
// a +inf or a NaN entry) gets what the plain version gives: log_q = m and
// a NaN pose; an -inf entry of a finite row has weight 0.
//
// Numerics: shifted is bit-equal to the plain version's l - amax(l) (the
// exact row max, one IEEE subtraction), which the next correction's
// resampler reads. log_q and the pose are not bit-equal to PyTorch's
// float32 chain, and closer to a float64 computation: the exponentials,
// the products and the sums are float64 and round once, at the end. sin
// and cos are float32 (sincosf, within an ulp), below the float32 pose's
// own rounding and far cheaper than the float64 pair.
//
// What bounds it on an H100: a row of 4000 reads 16 KB of log weights and
// 48 KB of particles and writes 16 KB (0.03 us at 3.35 TB/s); its float64
// exponentials take ~0.5 us of one SM. The bound is a launch and the
// block's own latency, as for csrc/resample.cu, so:
//   - one block a row up to 4096 entries (512 threads), a fleet's rows
//     one launch; each thread keeps its (up to 16) log weights in
//     registers between the max pass and the sums;
//   - thread 0 starts a 1-D bulk copy (TMA) of the row's particles into
//     shared memory before the max pass, which hides it; the 16 B aligned
//     middle goes by TMA, the few floats before and after it by threads;
//   - a warp-shuffle max, one exchange through shared memory; five
//     float64 warp-shuffle sums, one more exchange; thread 0 writes the
//     pose and the log quality. No atomics, no second launch.
// Longer rows are cut over a thread-block cluster of up to 8 blocks,
// which exchange their maxima and sums through distributed shared memory
// (lane b of warp 0 reads block b's); rows past 8 blocks' registers (8 x
// 16 x 1024 = 131,072) keep nothing in registers and read the log weights
// and particles twice.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kWarp = 32;
constexpr int kMaxPer = 16;                          // log weights a thread keeps in registers
constexpr int kBlockElems = kMaxPer * kMaxThreads;  // a block's slice in registers
constexpr int kMaxCluster = 8;                       // blocks a row (the portable cluster)
constexpr int kSums = 5;                             // e, e x, e y, e sin, e cos
// A row longer than kSliceTarget is cut over a cluster; a block runs
// kThreadTarget threads, more where its slice needs them. Chosen on an
// H100 (PERF.md's kernel table): at 4000 a cluster of 4 saved 0.3 us of
// a row and cost a 64-row fleet 2-3 us; 512 threads beat 256 and 1024.
constexpr int64_t kSliceTarget = 4096;
constexpr int64_t kThreadTarget = 512;

struct Args {
  const float* log_w;      // (rows, n), contiguous
  const float* particles;  // (rows, n, 3), contiguous
  int64_t n;
  int64_t slice;  // a block's entries; the cluster's last block takes the rest
  int cluster;    // blocks a row
  float* shifted;      // (rows, n)
  float* log_quality;  // (rows,)
  float* pose;         // (rows, 3)
};

// torch.amax's max: a NaN wins
__device__ __forceinline__ float max_nan(float a, float b) { return (a > b || a != a) ? a : b; }

// ---- mbarrier and 1-D TMA (as csrc/lut_dedup.cu) ----------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// ---- reductions -------------------------------------------------------------

// The max over the lanes below ``span`` (a power of two), in every lane.
__device__ __forceinline__ float warp_max(float v, int span) {
  for (int o = span / 2; o > 0; o >>= 1) v = max_nan(v, __shfl_xor_sync(0xffffffffu, v, o));
  return __shfl_sync(0xffffffffu, v, 0);
}

// The five sums over the lanes below ``span``, in every lane.
__device__ __forceinline__ void warp_sums(double (&v)[kSums], int span) {
  for (int o = span / 2; o > 0; o >>= 1) {
#pragma unroll
    for (int k = 0; k < kSums; ++k) v[k] += __shfl_xor_sync(0xffffffffu, v[k], o);
  }
#pragma unroll
  for (int k = 0; k < kSums; ++k) v[k] = __shfl_sync(0xffffffffu, v[k], 0);
}

// The least power of two >= n (n <= 32).
__device__ __forceinline__ int span_of(int n) { return n <= 1 ? 1 : 1 << (32 - __clz(n - 1)); }

// The block's max, in every thread; s_warp holds a value a warp. Every
// warp reduces the warps' values itself: no second barrier.
__device__ float block_max(float v, float* s_warp) {
  const int lane = threadIdx.x % kWarp, warps = blockDim.x / kWarp;
  v = warp_max(v, kWarp);
  if (lane == 0) s_warp[threadIdx.x / kWarp] = v;
  __syncthreads();
  return warp_max(lane < warps ? s_warp[lane] : -INFINITY, span_of(warps));
}

// The block's five sums, in warp 0's threads; s_warp holds five a warp.
__device__ void block_sums(double (&v)[kSums], double (*s_warp)[kSums]) {
  const int lane = threadIdx.x % kWarp, w = threadIdx.x / kWarp, warps = blockDim.x / kWarp;
  warp_sums(v, kWarp);
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < kSums; ++k) s_warp[w][k] = v[k];
  }
  __syncthreads();
  if (w == 0) {
#pragma unroll
    for (int k = 0; k < kSums; ++k) v[k] = lane < warps ? s_warp[lane][k] : 0.0;
    warp_sums(v, span_of(warps));
  }
}

// Lanes 0-3 of the row's first block, one output each: the log quality
// and the pose's x, y and heading.
__device__ void write_row(const Args& a, int64_t row, float m, const double (&v)[kSums],
                          int lane) {
  float out;
  if (!isfinite(m)) {  // the plain version's logsumexp gives m; its softmax NaN
    out = lane == 0 ? m : NAN;
  } else if (lane == 0) {
    out = static_cast<float>(static_cast<double>(m) + log(v[0]) - log(static_cast<double>(a.n)));
  } else if (lane == 3) {
    out = static_cast<float>(atan2(v[3], v[4]));
  } else {
    out = static_cast<float>(v[lane] / v[0]);
  }
  if (lane == 0) {
    a.log_quality[row] = out;
  } else {
    a.pose[row * 3 + lane - 1] = out;
  }
}

// One entry's terms of the five sums.
__device__ __forceinline__ void add_terms(double (&v)[kSums], float l, double md, float x,
                                          float y, float th) {
  const double e = exp(static_cast<double>(l) - md);
  float s, c;
  sincosf(th, &s, &c);
  v[0] += e;
  v[1] += e * static_cast<double>(x);
  v[2] += e * static_cast<double>(y);
  v[3] += e * static_cast<double>(s);
  v[4] += e * static_cast<double>(c);
}

// kPer > 0: thread t keeps entries t, t + blockDim.x, ... (kPer of them)
// of the block's slice in registers, and the slice's particles arrive in
// shared memory by TMA during the max pass. kPer == 0: the streaming form,
// which reads the slice twice from global memory.
template <int kPer>
__global__ void __launch_bounds__(kMaxThreads) normalize_pose_kernel(const Args a) {
  extern __shared__ __align__(16) float s_part[];
  __shared__ __align__(8) uint64_t s_bar;
  __shared__ float s_wmax[kWarp];
  __shared__ double s_wsum[kWarp][kSums];
  __shared__ float s_cmax;          // this block's max, read by the cluster
  __shared__ double s_csum[kSums];  // this block's sums, read by the cluster's first block
  __shared__ float s_rmax;

  const int64_t row = blockIdx.x / a.cluster;
  const int rank = static_cast<int>(blockIdx.x % a.cluster);  // the block's rank in its cluster
  const int64_t lo = rank * a.slice;
  const int64_t cnt = a.n - lo < a.slice ? a.n - lo : a.slice;
  const float* lw = a.log_w + row * a.n + lo;
  const float* pg = a.particles + (row * a.n + lo) * 3;
  float* out = a.shifted + row * a.n + lo;
  const int t = threadIdx.x, step = blockDim.x;

  // the slice's 3 cnt floats land at s_part + shift, so that shared and
  // global addresses agree modulo 16 B
  const int shift = static_cast<int>((reinterpret_cast<uintptr_t>(pg) >> 2) & 3);
  if constexpr (kPer > 0) {
    const int floats = static_cast<int>(3 * cnt);
    const int head = min((4 - shift) & 3, floats);
    const int body = (floats - head) & ~3;
    if (t == 0) {
      mbar_init(&s_bar);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      mbar_expect(&s_bar, static_cast<uint32_t>(body) * 4u);
      if (body > 0) {
        bulk_copy(s_part + shift + head, pg + head, static_cast<uint32_t>(body) * 4u, &s_bar);
      }
    }
    const int tail = floats - head - body;  // < 4, as is head: a block has 32 threads or more
    if (t < head + tail) {
      const int j = t < head ? t : body + t;
      s_part[shift + j] = pg[j];
    }
  }

  // the max pass
  float x[kPer > 0 ? kPer : 1];
  float m = -INFINITY;
  if constexpr (kPer > 0) {
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int64_t i = t + k * step;
      x[k] = i < cnt ? lw[i] : -INFINITY;
      m = max_nan(m, x[k]);
    }
  } else {
    for (int64_t i = t; i < cnt; i += step) m = max_nan(m, lw[i]);
  }
  m = block_max(m, s_wmax);
  if (a.cluster > 1) {  // lane b of warp 0 reads block b's max
    cg::cluster_group cluster = cg::this_cluster();
    if (t == 0) s_cmax = m;
    cluster.sync();
    if (t < kWarp) {
      const float r = t < a.cluster ? *cluster.map_shared_rank(&s_cmax, t) : -INFINITY;
      m = warp_max(r, span_of(a.cluster));
      if (t == 0) s_rmax = m;
    }
    __syncthreads();
    m = s_rmax;
  }

  // the shift and the sums (a non-finite max: the sums' values are unused)
  const double md = isfinite(m) ? static_cast<double>(m) : 0.0;
  double v[kSums] = {0.0, 0.0, 0.0, 0.0, 0.0};
  if constexpr (kPer > 0) {
    mbar_wait(&s_bar, 0);
    const float* sp = s_part + shift;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int64_t i = t + k * step;
      if (i < cnt) {
        out[i] = __fsub_rn(x[k], m);
        add_terms(v, x[k], md, sp[3 * i], sp[3 * i + 1], sp[3 * i + 2]);
      }
    }
  } else {
    for (int64_t i = t; i < cnt; i += step) {
      const float l = lw[i];
      out[i] = __fsub_rn(l, m);
      add_terms(v, l, md, pg[3 * i], pg[3 * i + 1], pg[3 * i + 2]);
    }
  }
  block_sums(v, s_wsum);

  if (a.cluster > 1) {
    cg::cluster_group cluster = cg::this_cluster();
    if (t == 0) {
#pragma unroll
      for (int k = 0; k < kSums; ++k) s_csum[k] = v[k];
    }
    cluster.sync();
    if (rank == 0 && t < kWarp) {  // lane b reads block b's sums
      const double* part = cluster.map_shared_rank(s_csum, t < a.cluster ? t : 0);
#pragma unroll
      for (int k = 0; k < kSums; ++k) v[k] = t < a.cluster ? part[k] : 0.0;
      warp_sums(v, span_of(a.cluster));
    }
    cluster.sync();  // no block leaves while the first reads its sums
  }
  if (rank == 0 && t < 4) write_row(a, row, m, v, t);
}

template <int kPer>
size_t smem_bytes(int64_t slice) {
  return kPer > 0 ? static_cast<size_t>((3 * slice + 4) * sizeof(float) + 15) / 16 * 16 : 0;
}

// Calls f(kernel instantiation, shared memory bytes) for kPer == per.
template <typename F>
cudaError_t with_per(int per, int64_t slice, F&& f) {
  switch (per) {
    case 0: return f(normalize_pose_kernel<0>, smem_bytes<0>(slice));
    case 1: return f(normalize_pose_kernel<1>, smem_bytes<1>(slice));
    case 2: return f(normalize_pose_kernel<2>, smem_bytes<2>(slice));
    case 4: return f(normalize_pose_kernel<4>, smem_bytes<4>(slice));
    case 8: return f(normalize_pose_kernel<8>, smem_bytes<8>(slice));
    case kMaxPer: return f(normalize_pose_kernel<kMaxPer>, smem_bytes<kMaxPer>(slice));
    default: return cudaErrorInvalidValue;
  }
}

int64_t ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }

}  // namespace

extern "C" {

// Opts every instantiation that keeps its slice in registers into the
// shared memory of the longest slice. Call once a device, before any
// launch.
int mcl_normalize_pose_setup() {
  cudaError_t err = cudaSuccess;
  for (int per = 1; per <= kMaxPer && err == cudaSuccess; per *= 2) {
    err = with_per(per, kBlockElems, [](auto kernel, size_t smem) {
      return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(smem));
    });
  }
  return static_cast<int>(err);
}

// shifted (rows, n), log_quality (rows,) and pose (rows, 3), float32,
// from log_w (rows, n) and particles (rows, n, 3), contiguous float32,
// after mcl_normalize_pose_setup on this device.
int mcl_normalize_pose(const float* log_w, const float* particles, int64_t rows, int64_t n,
                       float* shifted, float* log_quality, float* pose, void* stream) {
  if (rows < 1 || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  // the blocks a row and the entries a block: one block up to
  // kSliceTarget, else a cluster of up to 8 blocks (slices a multiple of
  // 4 entries, so 16 B aligned within the row), each in registers while
  // its slice fits them, else the streaming form
  int per = 0, threads = kMaxThreads;
  int64_t cluster = 1, slice = n;
  if (n > kSliceTarget) {
    cluster = ceil_div(n, kSliceTarget) < kMaxCluster ? ceil_div(n, kSliceTarget) : kMaxCluster;
    slice = ceil_div(ceil_div(n, cluster), 4) * 4;
    cluster = ceil_div(n, slice);
  }
  if (slice <= kBlockElems) {  // kThreadTarget threads, more where 16 a thread need them
    per = 1;
    while (per < kMaxPer && per * int64_t{kThreadTarget} < slice) per *= 2;
    threads = static_cast<int>(ceil_div(ceil_div(slice, per), kWarp) * kWarp);
  }
  if (rows > INT32_MAX / cluster) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{log_w, particles, n, slice, static_cast<int>(cluster), shifted, log_quality, pose};
  const cudaError_t err = with_per(per, slice, [&](auto kernel, size_t smem) {
    const auto s = static_cast<cudaStream_t>(stream);
    if (cluster == 1) {
      kernel<<<static_cast<unsigned>(rows), threads, smem, s>>>(a);
      return cudaSuccess;
    }
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = static_cast<unsigned>(cluster);
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3(static_cast<unsigned>(rows * cluster));
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = s;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return cudaLaunchKernelEx(&cfg, kernel, a);
  });
  const cudaError_t last = cudaGetLastError();  // clears a launch error
  return static_cast<int>(err != cudaSuccess ? err : last);
}

}  // extern "C"
