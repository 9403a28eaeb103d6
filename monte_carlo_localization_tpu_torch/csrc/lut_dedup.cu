// Unique-window range-LUT likelihood for Hopper (sm_90a): the function of
// lut_likelihood.cu, bit for bit, reading each distinct LUT window of a
// block of particles once.
//
// Replaces two TPU kernels of monte_carlo_localization_tpu/ops/
// pallas_lut.py that compute one function: K4, kernel_dedup (:584-638,
// call :795), which reads a particle's slot by a dynamic VMEM index, and
// K5, kernel_dedup_mm (:523-582, call :761), which gathers the slot with
// a one-hot MXU matmul because Mosaic lowered the dynamic index badly.
// On Hopper a read from shared memory by slot index is the natural form,
// so one kernel serves both (pallas_dedup_matmul selects the same launch).
//
// The host side (ops/lut_query.py dedup_plan, torch ops on the device,
// as pallas_lut.py query :951-978) sorts the particles by the key of
// their window, y0 = row * (row_stride / eps) + b0 / eps (the window's
// first 512 B subrow; 0 off the map), cuts the sorted order into blocks
// of B particles, ranks each particle's window among the block's
// distinct windows and fills a slot table with the first S of them.
// One CUDA block takes one block of particles:
//   - it stages its <= S slot windows, wents entries each from
//     slot_y0 * eps, into dynamic shared memory with coalesced 16 B loads
//     (no cp.async or TMA yet), then one __syncthreads;
//   - each warp takes particles of the block in turn, recomputes the
//     particle's window with the address math of K1 (beam_model.cuh
//     particle_window) and reads it through warp_window_logp, K1's own
//     beam sum: from shared memory at slot * wents + b0 % eps when its rank
//     is < S and the slot holds its key, else from global memory exactly as
//     K1 does. This per-block overflow replaces the TPU query's whole-call
//     lax.cond (:1013); every branch reads the same entries in the same
//     order, so the result equals K1's bit for bit;
//   - it writes each result to out[perm[i]] (no separate scatter) and
//     -1e4 for a particle off the map, and counts the blocks whose
//     distinct windows exceed S into a device int32 (no host sync).
//
// What bounds it on an H100: the same beam terms as K1 (~80 float32
// operations each) plus the staging, S * wents entries per block against
// r entries per particle for K1. At 100k particles x 60 beams a converged
// cloud needs a few slots of 2 KB per block of 160, against 60 scattered
// bytes per particle that K1 reads (mostly from L2, since the cloud shares
// its windows): both are operation-bound, and on this card the sort of
// the host side, not the reads, is what dedup adds.

#include <cstdint>

#include <cuda_runtime.h>

#include "beam_model.cuh"

namespace {

using mcl::kWarp;
using mcl::Params;
constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarp * kWarpsPerBlock;
constexpr int kChunk = 16;  // bytes per staging load

// Bytes of shared memory before the staged windows: min(obs, m) and the
// beam offsets, rounded up to a 16 B boundary for the vector stores.
__host__ __device__ inline size_t header_bytes(int r) {
  return (static_cast<size_t>(r) * 8 + kChunk - 1) / kChunk * kChunk;
}

template <typename T, bool kSubbin>
__global__ void __launch_bounds__(kThreads) lut_dedup_kernel(
    const T* __restrict__ lut, int64_t row_stride,
    const int32_t* __restrict__ row_map, const float* __restrict__ particles,
    int64_t n, const int64_t* __restrict__ perm,
    const int32_t* __restrict__ rank, const int64_t* __restrict__ slot_y0,
    int slots, int block_particles, int wents, int eps,
    const float* __restrict__ obs_px, const int32_t* __restrict__ offsets,
    int r, int base, int t_bins, int height, int width, Params p,
    float* __restrict__ out, int32_t* __restrict__ overflow) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_obs = reinterpret_cast<float*>(smem);
  int32_t* s_off = reinterpret_cast<int32_t*>(s_obs + r);
  T* s_win = reinterpret_cast<T*>(smem + header_bytes(r));

  const int64_t first = static_cast<int64_t>(blockIdx.x) * block_particles;
  const int count = static_cast<int>(
      n - first < block_particles ? n - first : block_particles);
  const int last_rank = rank[first + count - 1];  // ranks rise in a block
  const int used = last_rank + 1 < slots ? last_rank + 1 : slots;
  if (threadIdx.x == 0 && last_rank >= slots) atomicAdd(overflow, 1);
  const int64_t* my_slots = slot_y0 + static_cast<int64_t>(blockIdx.x) * slots;

  for (int j = threadIdx.x; j < r; j += blockDim.x) {
    s_obs[j] = fminf(obs_px[j], p.m);
    s_off[j] = offsets[j];
  }
  const int chunks = wents * static_cast<int>(sizeof(T)) / kChunk;
  uint4* dst = reinterpret_cast<uint4*>(s_win);
  for (int c = threadIdx.x; c < used * chunks; c += blockDim.x) {
    const int s = c / chunks;
    const uint4* src =
        reinterpret_cast<const uint4*>(lut + my_slots[s] * eps);
    dst[c] = src[c - s * chunks];
  }
  __syncthreads();

  const int lane = threadIdx.x % kWarp;
  const int64_t sub_per_row = row_stride / eps;
  for (int k = threadIdx.x / kWarp; k < count; k += kWarpsPerBlock) {
    const int64_t i = first + k;
    const int64_t src = perm[i];
    mcl::Window w;
    if (!mcl::particle_window<kSubbin>(
            particles[3 * src], particles[3 * src + 1], particles[3 * src + 2],
            p.ox, p.oy, row_map, base, t_bins, height, width, p, &w)) {
      if (lane == 0) out[src] = -1e4f;
      continue;
    }
    const int rk = rank[i];
    const int64_t key = w.row * sub_per_row + w.b0 / eps;
    const T* window = (rk < slots && my_slots[rk] == key)
                          ? s_win + static_cast<int64_t>(rk) * wents + w.b0 % eps
                          : lut + w.row * row_stride + w.b0;
    const float logw = mcl::warp_window_logp<T, kSubbin>(window, s_obs, s_off,
                                                         r, lane, p, w.frac);
    if (lane == 0) out[src] = logw;
  }
}

template <typename T>
size_t smem_bytes(int r, int slots, int wents) {
  return header_bytes(r) + static_cast<size_t>(slots) * wents * sizeof(T);
}

// The most slots whose windows fit the card's opt-in shared memory.
template <typename T>
int max_slots(int r, int wents) {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess) {
    return 0;
  }
  const size_t head = header_bytes(r);
  if (static_cast<size_t>(optin) <= head) return 0;
  return static_cast<int>((optin - head) / (static_cast<size_t>(wents) * sizeof(T)));
}

template <typename T>
int launch(const T* lut, int64_t row_stride, const int32_t* row_map,
           const float* particles, int64_t n, const int64_t* perm,
           const int32_t* rank, const int64_t* slot_y0, int slots,
           int block_particles, int wents, int eps, const float* obs_px,
           const int32_t* offsets, int r, int base, int t_bins, int height,
           int width, int subbin, const float* consts, float* out,
           int32_t* overflow, void* stream) {
  if (n <= 0) return 0;
  if (slots < 1 || block_particles < 1 ||
      (wents * static_cast<int>(sizeof(T))) % kChunk != 0 || eps <= 0 ||
      row_stride % eps != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Params p = mcl::params_from(consts);
  const int64_t blocks = (n + block_particles - 1) / block_particles;
  const size_t smem = smem_bytes<T>(r, slots, wents);
  auto kernel = subbin ? lut_dedup_kernel<T, true> : lut_dedup_kernel<T, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      lut, row_stride, row_map, particles, n, perm, rank, slot_y0, slots,
      block_particles, wents, eps, obs_px, offsets, r, base, t_bins, height,
      width, p, out, overflow);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int mcl_lut_dedup_u8(const uint8_t* lut, int64_t row_stride,
                     const int32_t* row_map, const float* particles,
                     int64_t n, const int64_t* perm, const int32_t* rank,
                     const int64_t* slot_y0, int slots, int block_particles,
                     int wents, int eps, const float* obs_px,
                     const int32_t* offsets, int r, int base, int t_bins,
                     int height, int width, int subbin, const float* consts,
                     float* out, int32_t* overflow, void* stream) {
  return launch<uint8_t>(lut, row_stride, row_map, particles, n, perm, rank,
                         slot_y0, slots, block_particles, wents, eps, obs_px,
                         offsets, r, base, t_bins, height, width, subbin,
                         consts, out, overflow, stream);
}

int mcl_lut_dedup_u16(const uint16_t* lut, int64_t row_stride,
                      const int32_t* row_map, const float* particles,
                      int64_t n, const int64_t* perm, const int32_t* rank,
                      const int64_t* slot_y0, int slots, int block_particles,
                      int wents, int eps, const float* obs_px,
                      const int32_t* offsets, int r, int base, int t_bins,
                      int height, int width, int subbin, const float* consts,
                      float* out, int32_t* overflow, void* stream) {
  return launch<uint16_t>(lut, row_stride, row_map, particles, n, perm, rank,
                          slot_y0, slots, block_particles, wents, eps, obs_px,
                          offsets, r, base, t_bins, height, width, subbin,
                          consts, out, overflow, stream);
}

int mcl_lut_dedup_max_slots(int r, int wents, int itemsize) {
  return itemsize == 1 ? max_slots<uint8_t>(r, wents)
                       : max_slots<uint16_t>(r, wents);
}

}  // extern "C"
