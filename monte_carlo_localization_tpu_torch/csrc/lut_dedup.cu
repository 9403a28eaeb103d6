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
//   - each group of lanes (16 for tabled scans of <= 64 beams, else a
//     warp: beam_model.cuh group_lanes) takes particles of the block in
//     turn, recomputes the particle's window with the address math of K1
//     (beam_model.cuh particle_window) and reads it through
//     group_window_logp, K1's own beam sum with K1's normaliser table:
//     from shared memory at slot * wents + b0 % eps when its rank is < S
//     and the slot holds its key, else from global memory exactly as K1
//     does. This per-block overflow replaces the TPU query's whole-call
//     lax.cond (:1013); every branch reads the same entries in the same
//     order, so the result equals K1's bit for bit;
//   - it writes each result to out[perm[i]] (no separate scatter) and
//     -1e4 for a particle off the map, and counts the blocks whose
//     distinct windows exceed S into a device int32 (no host sync).
//
// What bounds it on an H100: the same beam terms as K1 (the normaliser
// from K1's table, so one exp and one log each) plus the staging,
// S * wents entries per block against r entries per particle for K1. At
// 100k particles x 60 beams a converged cloud needs a few slots of 2 KB per block of 160, against 60 scattered
// bytes per particle that K1 reads (mostly from L2, since the cloud shares
// its windows): both are operation-bound, and on this card the sort of
// the host side, not the reads, is what dedup adds.

#include <cstdint>

#include <cuda_runtime.h>

#include "beam_model.cuh"

namespace {

using mcl::kWarp;
using mcl::Model;
using mcl::Params;
constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarp * kWarpsPerBlock;
constexpr int kChunk = 16;  // bytes per staging load

// Bytes of shared memory before the staged windows: the beam stage of
// beam_model.cuh (min(obs, m) with the beam offsets, then the normaliser
// table), rounded up to a 16 B boundary for the vector stores.
__host__ __device__ inline size_t header_bytes(int r, int table_entries) {
  return (mcl::stage_bytes(r, table_entries) + kChunk - 1) / kChunk * kChunk;
}

template <typename T, Model kModel, int kGroup>
__global__ void __launch_bounds__(kThreads) lut_dedup_kernel(
    const T* __restrict__ lut, int64_t row_stride,
    const int32_t* __restrict__ row_map, const float* __restrict__ particles,
    int64_t n, const int64_t* __restrict__ perm,
    const int32_t* __restrict__ rank, const int64_t* __restrict__ slot_y0,
    int slots, int block_particles, int wents, int eps,
    const float* __restrict__ obs_px, const int32_t* __restrict__ offsets,
    int r, int base, int t_bins, int height, int width,
    const float2* __restrict__ table, int table_entries, Params p,
    float* __restrict__ out, int32_t* __restrict__ overflow) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr bool kSubbin = kModel == Model::kLerped;
  constexpr int kPerWarp = kWarp / kGroup;     // particles a warp sums at once
  constexpr int kGroups = kThreads / kGroup;
  const int entries = table ? table_entries : 0;
  T* s_win = reinterpret_cast<T*>(smem + header_bytes(r, entries));

  const int64_t first = static_cast<int64_t>(blockIdx.x) * block_particles;
  const int count = static_cast<int>(
      n - first < block_particles ? n - first : block_particles);
  const int last_rank = rank[first + count - 1];  // ranks rise in a block
  const int used = last_rank + 1 < slots ? last_rank + 1 : slots;
  if (threadIdx.x == 0 && last_rank >= slots) atomicAdd(overflow, 1);
  const int64_t* my_slots = slot_y0 + static_cast<int64_t>(blockIdx.x) * slots;

  const mcl::BeamStage s = mcl::stage_beams(reinterpret_cast<float2*>(smem), obs_px,
                                            offsets, r, table, entries, p);
  const int chunks = wents * static_cast<int>(sizeof(T)) / kChunk;
  uint4* dst = reinterpret_cast<uint4*>(s_win);
  for (int c = threadIdx.x; c < used * chunks; c += blockDim.x) {
    const int sl = c / chunks;
    const uint4* src =
        reinterpret_cast<const uint4*>(lut + my_slots[sl] * eps);
    dst[c] = src[c - sl * chunks];
  }
  __syncthreads();

  const int lane = threadIdx.x % kWarp;
  const int64_t sub_per_row = row_stride / eps;
  for (int k0 = threadIdx.x / kWarp * kPerWarp; k0 < count; k0 += kGroups) {
    const int k = k0 + lane / kGroup;  // the warp's groups take neighbours
    const T* window = lut;
    int64_t src = -1;
    bool valid = false;
    mcl::Window w;
    w.frac = 0.0f;
    if (k < count) {
      const int64_t i = first + k;
      src = perm[i];
      valid = mcl::particle_window<kSubbin>(
          particles[3 * src], particles[3 * src + 1], particles[3 * src + 2],
          p.ox, p.oy, row_map, base, t_bins, height, width, p, &w);
      if (valid) {
        const int rk = rank[i];
        const int64_t key = w.row * sub_per_row + w.b0 / eps;
        window = (rk < slots && my_slots[rk] == key)
                     ? s_win + static_cast<int64_t>(rk) * wents + w.b0 % eps
                     : lut + w.row * row_stride + w.b0;
      }
    }
    const float logw = mcl::group_window_logp<kGroup, kModel>(window, valid, s, r,
                                                               lane, p, w.frac);
    if (src >= 0 && lane % kGroup == 0) out[src] = valid ? logw : -1e4f;
  }
}

template <typename T>
size_t smem_bytes(int r, int table_entries, int slots, int wents) {
  return header_bytes(r, table_entries) + static_cast<size_t>(slots) * wents * sizeof(T);
}

// The most slots whose windows fit the card's opt-in shared memory.
template <typename T>
int max_slots(int r, int wents, int table_entries) {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess) {
    return 0;
  }
  const size_t head = header_bytes(r, table_entries);
  if (static_cast<size_t>(optin) <= head) return 0;
  return static_cast<int>((optin - head) / (static_cast<size_t>(wents) * sizeof(T)));
}

template <typename T>
int launch(const T* lut, int64_t row_stride, const int32_t* row_map,
           const float* particles, int64_t n, const int64_t* perm,
           const int32_t* rank, const int64_t* slot_y0, int slots,
           int block_particles, int wents, int eps, const float* obs_px,
           const int32_t* offsets, int r, int base, int t_bins, int height,
           int width, int subbin, const float* consts, const float* table,
           int table_entries, float* out, int32_t* overflow, void* stream) {
  if (n <= 0) return 0;
  if (slots < 1 || block_particles < 1 ||
      (wents * static_cast<int>(sizeof(T))) % kChunk != 0 || eps <= 0 ||
      row_stride % eps != 0 ||
      (table != nullptr && (subbin || table_entries < 1 ||
                            table_entries > mcl::kMaxTableEntries))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Params p = mcl::params_from(consts);
  const int64_t blocks = (n + block_particles - 1) / block_particles;
  const size_t smem = smem_bytes<T>(r, table ? table_entries : 0, slots, wents);
  const Model model = mcl::model_of(subbin, table != nullptr);
  auto kernel = lut_dedup_kernel<T, Model::kLerped, kWarp>;
  if (model == Model::kAnalytic) {
    kernel = lut_dedup_kernel<T, Model::kAnalytic, kWarp>;
  } else if (model == Model::kTabled) {
    kernel = mcl::group_lanes(r, model) == mcl::kSmallGroup
                 ? lut_dedup_kernel<T, Model::kTabled, mcl::kSmallGroup>
                 : lut_dedup_kernel<T, Model::kTabled, kWarp>;
  }
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      lut, row_stride, row_map, particles, n, perm, rank, slot_y0, slots,
      block_particles, wents, eps, obs_px, offsets, r, base, t_bins, height,
      width, reinterpret_cast<const float2*>(table), table_entries, p, out, overflow);
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
                     const float* table, int table_entries, float* out,
                     int32_t* overflow, void* stream) {
  return launch<uint8_t>(lut, row_stride, row_map, particles, n, perm, rank,
                         slot_y0, slots, block_particles, wents, eps, obs_px,
                         offsets, r, base, t_bins, height, width, subbin,
                         consts, table, table_entries, out, overflow, stream);
}

int mcl_lut_dedup_u16(const uint16_t* lut, int64_t row_stride,
                      const int32_t* row_map, const float* particles,
                      int64_t n, const int64_t* perm, const int32_t* rank,
                      const int64_t* slot_y0, int slots, int block_particles,
                      int wents, int eps, const float* obs_px,
                      const int32_t* offsets, int r, int base, int t_bins,
                      int height, int width, int subbin, const float* consts,
                      const float* table, int table_entries, float* out,
                      int32_t* overflow, void* stream) {
  return launch<uint16_t>(lut, row_stride, row_map, particles, n, perm, rank,
                          slot_y0, slots, block_particles, wents, eps, obs_px,
                          offsets, r, base, t_bins, height, width, subbin,
                          consts, table, table_entries, out, overflow, stream);
}

int mcl_lut_dedup_max_slots(int r, int wents, int itemsize, int table_entries) {
  return itemsize == 1 ? max_slots<uint8_t>(r, wents, table_entries)
                       : max_slots<uint16_t>(r, wents, table_entries);
}

}  // extern "C"
