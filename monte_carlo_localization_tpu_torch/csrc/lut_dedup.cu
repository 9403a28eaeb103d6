// Unique-window range-LUT likelihood for Hopper (sm_90a): the function of
// lut_likelihood.cu, bit for bit, reading each distinct LUT window of a
// chunk of particles once.
//
// Replaces two TPU kernels of monte_carlo_localization_tpu/ops/
// pallas_lut.py that compute one function: K4, kernel_dedup (:584-638,
// call :795), which reads a particle's slot by a dynamic VMEM index, and
// K5, kernel_dedup_mm (:523-582, call :761), which gathers the slot with
// a one-hot MXU matmul because Mosaic lowered the dynamic index badly.
// On Hopper a read from shared memory by slot index is the natural form,
// so one kernel serves both (pallas_dedup_matmul selects the same launch).
// It also does the work of the TPU query's plan (:951-978), which XLA ran
// as sort, cumsum and scatter around the Pallas call.
//
// What it computes, with the plan's semantics (ops/lut_query.py
// dedup_plan is the plain version): the particles sorted by the key of
// their window, y0 = start / eps (the window's first 512 B subrow; 0 off
// the map), are cut into chunks of B; a chunk reads its first S distinct
// windows from shared memory and the rest from global memory, and counts
// into ``overflow`` when it has more than S.
//
// The launch is three steps (LUTQuery.launch_dedup):
//   - window_key_kernel computes every particle's window once with K1's
//     address math (beam_model.cuh particle_window): its start in the LUT
//     (-1 off the map, the off-map flag), its fractional bin with the
//     sub-bin lerp, and its 32-bit key. A key past 2^31 - 1 would need a
//     LUT of more than 2^31 subrows of 512 B, over 1 TB: no card holds
//     one, and the wrapper refuses it. The kernel zeroes the overflow
//     count;
//   - torch.sort(keys, stable=True): the sort stays a library sort, as the
//     JAX package leaves argsort to XLA; 32-bit keys halve its radix
//     passes;
//   - lut_dedup_kernel, one block per chunk. It ranks the chunk's distinct
//     keys by a block scan of "differs from the previous key" (ballot and
//     popc), fills its S slots, counts the chunk if it overflows, and
//     stages the slot windows with cp.async.bulk (1-D TMA, one contiguous
//     window per copy) on an mbarrier; the beams and the normaliser table
//     are staged while the copies land. A slot stages the eps - 1 + span
//     entries a window can reach from its subrow (16 B rounded), not the
//     TPU's (8, 128)-rounded window. A persistent form that walked over
//     chunks and staged chunk c + 1 while it summed chunk c measured
//     31-44% slower on an H100 where it took two buffers (1080 u16 beams,
//     PERF.md): the second buffer cut the blocks an SM from 3 to 2, and
//     the other resident blocks hide the copies of a block that waits.
//
// Each particle's beams are read through group_rounds, K1's own round
// loop, beam sum and table: from the staged slot at
// (start mod eps) when its key is among the chunk's slots, else from
// global memory exactly as K1 reads them. Every branch reads the same
// entries in the same order, so the result equals K1's bit for bit
// whatever the plan; a result goes straight to out[perm[i]].
//
// What bounds it on an H100: the same beam terms as K1 plus, per
// particle, the sorted key, perm and a gather of its start (and fraction)
// against K1's particle and row-map loads, and per chunk a scan and S
// windows of ~1.6 KB (u8, 60 beams) copied by the TMA engine. At 100k
// particles x 60 beams both are operation-bound; the sort, not the
// reads, is what dedup adds.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#include "beam_model.cuh"

namespace {

using mcl::kFullMask;
using mcl::kWarp;
using mcl::Model;
using mcl::Params;
constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarp * kWarpsPerBlock;
constexpr int kAlign = 16;  // cp.async.bulk: 16 B multiples at 16 B aligned addresses
// Blocks an SM the kernel is compiled for: a register budget of 51. Left
// to itself ptxas gave the 60-beam form 32 registers and it ran 9-27%
// slower than at 47 (PERF.md); 5 an SM also hold config #4's 625 chunks
// of 160 at once on 132 SMs.
constexpr int kMinBlocksPerSm = 5;

__host__ __device__ inline size_t align16(size_t b) { return (b + kAlign - 1) / kAlign * kAlign; }

// ---- mbarrier and 1-D TMA -------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar)) : "memory");
}

// One arrival that also expects ``bytes`` of copies before the phase ends.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Until the phase of ``parity`` has completed.
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

// ---- window keys ----------------------------------------------------------

// Per particle: start = row * row_stride + b0 (-1 off the map), key =
// start >> log2(eps) (0 off the map), and the fractional bin with the
// sub-bin lerp. Thread 0 zeroes the overflow count of the launch.
template <bool kSubbin>
__global__ void window_key_kernel(const float* __restrict__ particles, int64_t n,
                                  const int32_t* __restrict__ row_map, int64_t row_stride,
                                  int eps_shift, int base, int t_bins, int height, int width,
                                  Params p, int32_t* __restrict__ keys,
                                  int64_t* __restrict__ starts, float* __restrict__ fracs,
                                  int32_t* __restrict__ overflow) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i == 0) *overflow = 0;
  if (i >= n) return;
  mcl::Window w;
  const bool on = mcl::particle_window<kSubbin>(particles[3 * i], particles[3 * i + 1],
                                                particles[3 * i + 2], p.ox, p.oy, row_map,
                                                base, t_bins, height, width, p, &w);
  const int64_t start = on ? w.row * row_stride + w.b0 : -1;
  keys[i] = on ? static_cast<int32_t>(start >> eps_shift) : 0;
  starts[i] = start;
  if (kSubbin) fracs[i] = on ? w.frac : 0.0f;
}

// ---- the unique-window kernel --------------------------------------------

template <typename T>
struct DedupArgs {
  const T* lut;
  const int64_t* starts;  // per particle, -1 off the map
  const float* fracs;     // per particle, with the sub-bin lerp
  const int32_t* keys;    // sorted keys
  const int64_t* perm;    // sorted position -> particle
  int64_t n;
  int block;              // B: particles per chunk
  int slots;              // S
  int slot_ents;          // entries staged per slot
  int eps;
  const float* obs_px;
  const int32_t* offsets;
  int r;
  const float2* table;
  int table_entries;
  Params p;
  float* out;
  int32_t* overflow;
};

// The plan of one chunk of ``count`` sorted particles from ``first``: the
// first S distinct keys into ``slot_keys`` (ascending), how many into
// *used, and one count into overflow when the chunk has more. The whole
// block calls it; it ends synchronized.
template <typename T>
__device__ void plan_chunk(const DedupArgs<T>& a, int64_t first, int count,
                           int32_t* slot_keys, int* s_warp, int* used) {
  const int tid = threadIdx.x;
  const int lane = tid % kWarp;
  const int warp = tid / kWarp;
  int carry = 0;  // distinct keys before this tile
  for (int base = 0; base < count; base += kThreads) {
    const int k = base + tid;
    bool fresh = false;
    int32_t key = 0;
    if (k < count) {
      key = a.keys[first + k];
      fresh = k == 0 || key != a.keys[first + k - 1];
    }
    const unsigned mask = __ballot_sync(kFullMask, fresh);
    if (lane == 0) s_warp[warp] = __popc(mask);
    __syncthreads();
    int before = carry, tile = 0;
#pragma unroll
    for (int w = 0; w < kWarpsPerBlock; ++w) {
      const int c = s_warp[w];
      before += w < warp ? c : 0;
      tile += c;
    }
    const int rank = before + __popc(mask & ((1u << lane) - 1u));
    if (fresh && rank < a.slots) slot_keys[rank] = key;
    carry += tile;
    __syncthreads();  // s_warp is reused by the next tile
  }
  if (tid == 0) {
    *used = min(carry, a.slots);
    if (carry > a.slots) atomicAdd(a.overflow, 1);
  }
  __syncthreads();
}

// One thread: the copies of a chunk's ``used`` slot windows into ``dst``,
// completing on ``bar``.
template <typename T>
__device__ void stage_chunk(const DedupArgs<T>& a, const int32_t* slot_keys, int used,
                            unsigned char* dst, uint64_t* bar) {
  const uint32_t bytes = static_cast<uint32_t>(a.slot_ents * sizeof(T));
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  mbar_expect(bar, bytes * used);
  for (int sl = 0; sl < used; ++sl) {
    bulk_copy(dst + static_cast<size_t>(sl) * bytes,
              a.lut + static_cast<int64_t>(slot_keys[sl]) * a.eps, bytes, bar);
  }
}

template <typename T, Model kModel, int kGroup>
__global__ void __launch_bounds__(kThreads, kMinBlocksPerSm) lut_dedup_kernel(DedupArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(8) uint64_t s_bar;
  __shared__ int s_warp[kWarpsPerBlock];
  __shared__ int s_used;
  constexpr int kGroups = kThreads / kGroup;
  constexpr bool kSubTable = kModel == Model::kLerped;
  const Params& p = a.p;
  const int tid = threadIdx.x;
  const int lane = tid % kWarp;
  const int lig = tid % kGroup;
  const int g = tid / kGroup;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * a.block;
  const int count = static_cast<int>(min(static_cast<int64_t>(a.block), a.n - first));
  const size_t win_bytes = static_cast<size_t>(a.slot_ents) * sizeof(T) * a.slots;
  const int entries = a.table ? a.table_entries : 0;
  // [windows: S slots][beam stage + table][slot keys: S]
  const T* wins = reinterpret_cast<const T*>(smem);
  int32_t* s_keys = reinterpret_cast<int32_t*>(
      smem + align16(win_bytes + mcl::stage_bytes(a.r, entries, kSubTable)));
  if (tid == 0) {
    mbar_init(&s_bar);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  plan_chunk(a, first, count, s_keys, s_warp, &s_used);
  const int used = s_used;
  if (tid == 0) stage_chunk(a, s_keys, used, smem, &s_bar);
  const mcl::BeamStage s = mcl::stage_beams(reinterpret_cast<float2*>(smem + win_bytes),
                                            a.obs_px, a.offsets, a.r, a.table, entries, p,
                                            kSubTable);
  __syncthreads();
  mbar_wait(&s_bar, 0);

  // a pass gives each group up to kGroup consecutive particles of the
  // chunk; lane i of a group finds particle i's window
  for (int base = 0; base < count; base += kGroups * kGroup) {
    const int left = count - base;
    const int per = min(kGroup, (left + kGroups - 1) / kGroups);
    const int mine_n = max(0, min(per, left - g * per));
    const T* win = nullptr;
    float frac = 0.0f;
    int64_t src = -1;
    if (lig < mine_n) {
      const int64_t i = first + base + g * per + lig;
      src = a.perm[i];
      const int64_t start = a.starts[src];
      if (start >= 0) {
        if (mcl::lerps(kModel)) frac = a.fracs[src];
        const int32_t key = a.keys[i];
        int lo = 0, hi = used;  // the slot keys ascend
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (s_keys[mid] < key) {
            lo = mid + 1;
          } else {
            hi = mid;
          }
        }
        win = lo < used && s_keys[lo] == key
                  ? wins + static_cast<int64_t>(lo) * a.slot_ents + (start & (a.eps - 1))
                  : a.lut + start;
      }
    }
    const float mine = mcl::group_rounds<kGroup, kModel>(win, frac, mine_n, s, a.r, lane, p);
    if (lig < mine_n) a.out[src] = mine;
  }
}

// The kernel's dynamic shared memory: the windows (16 B multiples), the
// stage, 16 B aligned, and the slot keys.
size_t smem_bytes(int r, int table_entries, bool sub_table, int slots, size_t slot_bytes) {
  return slots * (slot_bytes + sizeof(int32_t)) +
         align16(mcl::stage_bytes(r, table_entries, sub_table));
}

// Calls f with the kernel instantiation that serves the query.
template <typename T, typename F>
auto with_kernel(int r, Model model, F f) {
  switch (model) {
    case Model::kLerped:
      return mcl::group_lanes(r, model) == mcl::kSmallGroup
                 ? f(lut_dedup_kernel<T, Model::kLerped, mcl::kSmallGroup>)
                 : f(lut_dedup_kernel<T, Model::kLerped, kWarp>);
    case Model::kLerpedAnalytic:
      return f(lut_dedup_kernel<T, Model::kLerpedAnalytic, kWarp>);
    case Model::kAnalytic:
      return f(lut_dedup_kernel<T, Model::kAnalytic, kWarp>);
    default:
      return mcl::group_lanes(r, model) == mcl::kSmallGroup
                 ? f(lut_dedup_kernel<T, Model::kTabled, mcl::kSmallGroup>)
                 : f(lut_dedup_kernel<T, Model::kTabled, kWarp>);
  }
}

// The most slots of ``slot_ents`` entries that fit the card's opt-in
// shared memory beside the stage.
template <typename T>
int max_slots(int r, int slot_ents, int table_entries, int subbin) {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
      cudaSuccess) {
    return 0;
  }
  cudaFuncAttributes attr;
  if (cudaFuncGetAttributes(&attr, lut_dedup_kernel<T, Model::kTabled, kWarp>) != cudaSuccess) {
    return 0;
  }
  const bool sub_table = subbin && table_entries > 0;
  const size_t head = align16(mcl::stage_bytes(r, table_entries, sub_table));
  const size_t room = static_cast<size_t>(optin) - attr.sharedSizeBytes;
  if (room <= head) return 0;
  const size_t per_slot = static_cast<size_t>(slot_ents) * sizeof(T) + sizeof(int32_t);
  return static_cast<int>((room - head) / per_slot);
}

template <typename T>
int launch(const T* lut, const int64_t* starts, const float* fracs, const int32_t* keys,
           const int64_t* perm, int64_t n, int block, int slots, int slot_ents, int eps,
           const float* obs_px, const int32_t* offsets, int r, int subbin, const float* consts,
           const float* table, int table_entries, float* out, int32_t* overflow,
           void* stream) {
  if (n <= 0) return 0;
  const Params p = mcl::params_from(consts);
  const int64_t chunks = block > 0 ? (n + block - 1) / block : 0;
  if (slots < 1 || block < 1 || chunks > INT_MAX ||
      (slot_ents * static_cast<int>(sizeof(T))) % kAlign != 0 || eps <= 0 ||
      (eps & (eps - 1)) != 0 || (subbin && fracs == nullptr) ||
      (table != nullptr && !mcl::table_fits(subbin, table_entries, p))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const DedupArgs<T> a{lut, starts, fracs, keys, perm, n, block, slots, slot_ents, eps,
                       obs_px, offsets, r, reinterpret_cast<const float2*>(table),
                       table_entries, p, out, overflow};
  const Model model = mcl::model_of(subbin, table != nullptr);
  const size_t smem = smem_bytes(r, table ? table_entries : 0, model == Model::kLerped, slots,
                                 static_cast<size_t>(slot_ents) * sizeof(T));
  return with_kernel<T>(r, model, [&](auto kernel) {
    int resident = 0;  // asked for its opt-in into the shared memory the launch needs
    const cudaError_t err = mcl::resident_blocks(kernel, smem, kThreads, &resident);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<static_cast<unsigned>(chunks), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        a);
    return static_cast<int>(cudaGetLastError());
  });
}

}  // namespace

extern "C" {

// keys (n,) int32, starts (n,) int64, fracs (n,) float32 (with subbin),
// overflow (1,) int32 zeroed.
int mcl_window_keys(const float* particles, int64_t n, const int32_t* row_map,
                    int64_t row_stride, int eps, int base, int t_bins, int height, int width,
                    int subbin, const float* consts, int32_t* keys, int64_t* starts,
                    float* fracs, int32_t* overflow, void* stream) {
  if (n < 0 || eps <= 0 || (eps & (eps - 1)) != 0 || row_stride % eps != 0 ||
      (subbin && fracs == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Params p = mcl::params_from(consts);
  const int shift = __builtin_ctz(static_cast<unsigned>(eps));
  const int64_t grid = (n + kThreads - 1) / kThreads;
  const unsigned blocks = static_cast<unsigned>(grid > 0 ? grid : 1);  // n = 0 zeroes overflow
  auto s = static_cast<cudaStream_t>(stream);
  if (subbin) {
    window_key_kernel<true><<<blocks, kThreads, 0, s>>>(particles, n, row_map, row_stride,
                                                        shift, base, t_bins, height, width,
                                                        p, keys, starts, fracs, overflow);
  } else {
    window_key_kernel<false><<<blocks, kThreads, 0, s>>>(particles, n, row_map, row_stride,
                                                         shift, base, t_bins, height, width,
                                                         p, keys, starts, fracs, overflow);
  }
  return static_cast<int>(cudaGetLastError());
}

#define MCL_DEDUP_ENTRY(NAME, T)                                                         \
  int NAME(const T* lut, const int64_t* starts, const float* fracs, const int32_t* keys, \
           const int64_t* perm, int64_t n, int block, int slots, int slot_ents, int eps,  \
           const float* obs_px, const int32_t* offsets, int r, int subbin,                \
           const float* consts, const float* table, int table_entries, float* out,        \
           int32_t* overflow, void* stream) {                                             \
    return launch<T>(lut, starts, fracs, keys, perm, n, block, slots, slot_ents, eps,     \
                     obs_px, offsets, r, subbin, consts, table, table_entries, out,       \
                     overflow, stream);                                                   \
  }

MCL_DEDUP_ENTRY(mcl_lut_dedup_u8, uint8_t)
MCL_DEDUP_ENTRY(mcl_lut_dedup_u16, uint16_t)

int mcl_lut_dedup_max_slots(int r, int slot_ents, int itemsize, int table_entries, int subbin) {
  return itemsize == 1 ? max_slots<uint8_t>(r, slot_ents, table_entries, subbin)
                       : max_slots<uint16_t>(r, slot_ents, table_entries, subbin);
}

}  // extern "C"
