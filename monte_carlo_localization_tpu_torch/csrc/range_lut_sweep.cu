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
// Bound: the bytes it writes, one entry per (cell, bin): 10.3 GB for
// Spielberg's compact u8 LUT, 3.1 ms at 3.35 TB/s. What the design does
// about it:
//
// - A block sweeps a tile of adjacent physical bins of one group (one
//   32 B sector of a LUT row: 32 u8 or 16 u16 bins; 16, 8 or 4 B where a
//   grid line is too long for that in shared memory), so a cell's entries
//   of the tile are one contiguous run of its row. A thread owns one 4 B
//   word of a cell (4 u8 or 2 u16 bins): eight neighbouring threads write a
//   whole sector with one store instruction. The host's tile plan cuts a
//   group's runs of adjacent bins at multiples of the tile width; lanes
//   outside a partial tile are computed and never stored.
// - D is a saturated integer, one lane of the LUT's width per bin:
//   D <- occupied ? 0 : min(D_nbr + 1, C) with C = max_range_px + 1. Every
//   D >= C gives px = max_range_px (step_len >= 1 and the float ops round
//   monotonically), so the entries are those of the unbounded sweep. Two
//   lines of D live in shared memory as words, four u8 (two u16) lanes
//   updated at once: the drift picks each lane from the word of the cell
//   to the left, the same cell or the right by two bit selects, and
//   "+1 unless already C" is a carry-free SWAR add.
// - A block sweeps a chunk of lines. A chunk that starts at sweep line
//   i0 > C starts C lines earlier with D = C everywhere and stores nothing
//   before i0: a saturated D depends only on the C lines before it, so this
//   warm-up is exact. Chunks give the card blocks enough to fill its SMs
//   (a group has some 25 tiles at Spielberg); the host picks the chunk
//   length from the SM count and the blocks an SM holds.
// - Each line's cells (row | occupied << 31, in line order: the host
//   transposes a column group's) are staged in shared memory by cp.async
//   while the line before is swept, and the drift of the next line is
//   loaded ahead into registers, so one __syncthreads a line is the only
//   wait.
// - A line too long for two lines of D in shared memory (past 14,527
//   cells at one word a cell) keeps them in global memory instead: each
//   resident block owns two lines of scratch, reads its cells straight
//   from the cell words, and the same __syncthreads orders a line's
//   writes before the next line's reads (it orders a block's global
//   accesses as it does its shared ones). The grid is then the blocks
//   the card holds at once (and the scratch allows), each looping over
//   the launch's (tile, chunk) items, so the scratch is bounded by the
//   card, not by the map.
//
// Numerics are the JAX and native builders' bit for bit: D is exact in a
// float (2^23 + D by its bits, less 2^23), the product and the subtraction
// round separately (__fmul_rn, __fsub_rn: nvcc would contract them into
// one FMA), and the truncating store is __fadd_rz(px + 0.5, 2^23), whose
// low bits are the entry (the value of __float2uint_rz, cast to the LUT's
// type). The drift table `rel` comes from the host's float64 shear
// (np.rint). Offsets are 64-bit: basement's 5.13 GB compact LUT passes
// 2^31 bytes.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr uint32_t kOccupied = 0x80000000u;  // a cell word's flag; the low bits are its row
constexpr uint32_t kTwo23 = 0x4B000000u;     // the bits of 2^23

// Shared memory of a block: two lines of (Q + 2) cells x `words` words of
// D (a zero cell at each end reads as "off the line") and two lines of Q
// cell words; none where D lies in global memory.
__host__ __device__ inline int64_t smem_bytes(int q_len, int words, bool global_d) {
  if (global_d) return 0;
  return 8 * static_cast<int64_t>(words) * (q_len + 2) + 8 * static_cast<int64_t>(q_len);
}

__device__ __forceinline__ void cp_async_4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}

// Start copying line p's cell words into shared memory.
__device__ __forceinline__ void stage_line(int32_t* dst, const int32_t* __restrict__ cells,
                                           int p, int q_len) {
  const int32_t* src = cells + static_cast<int64_t>(p) * q_len;
  for (int q = threadIdx.x; q < q_len; q += blockDim.x) cp_async_4(dst + q, src + q);
  asm volatile("cp.async.commit_group;\n" ::);
}

// Lanes of a D word: 4 of 8 bits for a u8 LUT, 2 of 16 bits for u16.
template <typename OutT>
struct Lanes {
  static constexpr int kCount = 4 / sizeof(OutT);
  static constexpr int kBits = 8 * sizeof(OutT);
  static constexpr uint32_t kOne = sizeof(OutT) == 1 ? 0x01010101u : 0x00010001u;
  static constexpr uint32_t kLow = kOne * ((1u << (kBits - 1)) - 1);  // all but each lane's top bit

  static __device__ __forceinline__ uint32_t mask(int j) {
    return ((1u << (kBits - 1) << 1) - 1) << (kBits * j);
  }
  // min(x + 1, C) in each lane, for lanes x <= C: +1 where the lane is not C
  static __device__ __forceinline__ uint32_t sat_inc(uint32_t x, uint32_t c_word) {
    const uint32_t ne = x ^ c_word;
    const uint32_t top = ((ne & kLow) + kLow) | ne;  // each lane's top bit: lane != C
    return x + ((top >> (kBits - 1)) & kOne);
  }
  // 2^23 + lane j of w, as float bits
  static __device__ __forceinline__ uint32_t as_float_bits(uint32_t w, int j) {
    return sizeof(OutT) == 1 ? __byte_perm(w, kTwo23, 0x7540 | j)
                             : __byte_perm(w, kTwo23, 0x7400 | ((2 * j + 1) << 4) | (2 * j));
  }
  // the entries' low bits packed into one word
  static __device__ __forceinline__ uint32_t pack(const uint32_t (&e)[kCount]) {
    if constexpr (sizeof(OutT) == 1) {
      return __byte_perm(__byte_perm(e[0], e[1], 0x0040), __byte_perm(e[2], e[3], 0x0040),
                         0x5410);
    } else {
      return __byte_perm(e[0], e[1], 0x5410);
    }
  }
};

// The LUT entry of distance d (lane bits of 2^23 + d as a float), as the
// bits of 2^23 + entry: the JAX builder's float32 expression, rounding
// step by step.
__device__ __forceinline__ uint32_t entry_bits(uint32_t d_bits, float sl, float maxr) {
  const float d = __fsub_rn(__uint_as_float(d_bits), 8388608.0f);  // exact
  const float px = fminf(fmaxf(__fsub_rn(__fmul_rn(d, sl), 1.0f), 0.0f), maxr);
  return __float_as_uint(__fadd_rz(__fadd_rn(px, 0.5f), 8388608.0f));  // 2^23 + trunc
}

struct SweepArgs {
  const int32_t* cells;  // (P, Q) row | occupied << 31, in line order
  uint32_t* scratch;     // global D: two lines of (Q + 2) x words a block; else null
  const int8_t* rel;     // (P, B) drift to the line before along the sweep
  const float* step_len; // (B,)
  const int4* tiles;     // (n_tiles,) {first group bin, base physical bin, lo lane, hi lane}
  int n_tiles;
  int items;  // (tile, chunk) pairs: n_tiles x chunks
  int p_len;
  int q_len;
  int b_count;
  int words_log2;  // D words a cell (1 << words_log2 of them: 32, 16, 8 or 4 B)
  int lines;       // stored lines a chunk
  int forward;
  int skip_row0;  // a compact LUT: row 0, the shared far row, is never written
  int sat;        // C = max_range_px + 1
  float maxr;
  int vec_ok;     // a word's 4 B lie 4 B aligned in every row
  int64_t row_stride;
  int64_t row_base;
};

template <typename OutT, bool kGlobalD>
__global__ void __launch_bounds__(kMaxThreads)
    range_lut_sweep_kernel(const SweepArgs a, OutT* __restrict__ out) {
  using L = Lanes<OutT>;
  extern __shared__ __align__(16) uint32_t s_mem[];
  const int words = 1 << a.words_log2;
  const int padded = (a.q_len + 2) * words;
  uint32_t* const d_base = kGlobalD ? a.scratch + static_cast<int64_t>(blockIdx.x) * 2 * padded
                                    : s_mem;
  int32_t* const s_cells = reinterpret_cast<int32_t*>(s_mem + 2 * padded);  // 2 x Q, shared D only
  const int w = threadIdx.x & (words - 1);  // this thread's word of every cell
  const int items = a.q_len << a.words_log2;

  for (int item = blockIdx.x; item < a.items; item += gridDim.x) {
    uint32_t* prev = d_base;
    uint32_t* cur = d_base + padded;
    const int4 tile = a.tiles[item % a.n_tiles];
    const int first = (item / a.n_tiles) * a.lines;  // first stored sweep line
    const int last = min(first + a.lines, a.p_len);
    const int start = max(first - a.sat, 0);  // the warm-up's first line
    const uint32_t c_word = static_cast<uint32_t>(a.sat) * L::kOne;
    const uint32_t init = start == 0 ? 0u : c_word;  // the sweep's own start, or saturated
    for (int i = threadIdx.x; i < padded; i += blockDim.x) {
      const bool pad = i < words || i >= padded - words;
      prev[i] = pad ? 0u : init;
      cur[i] = 0u;
    }

    // this thread's lanes' bins
    int col[L::kCount];  // group index of each lane's bin, -1 outside the tile
    float sl[L::kCount];
    bool any = false, full = true;
#pragma unroll
    for (int j = 0; j < L::kCount; ++j) {
      const int lane = w * L::kCount + j;
      const bool valid = lane >= tile.z && lane < tile.w;
      col[j] = valid ? tile.x + lane - tile.z : -1;
      sl[j] = valid ? a.step_len[col[j]] : 1.0f;
      any |= valid;
      full &= valid;
    }
    const bool vector_store = full && a.vec_ok;
    const int64_t col0 = tile.y + w * L::kCount;  // the word's first entry in a row

    // the drift of this thread's lanes on sweep line i (0 outside the
    // tile), and from it the masks of the lanes that read the cell to the
    // left (rel -1) and to the right (rel +1)
    auto load_rel = [&](int i, int (&r)[L::kCount]) {
      const int8_t* row =
          a.rel + static_cast<int64_t>(a.forward ? i : a.p_len - 1 - i) * a.b_count;
#pragma unroll
      for (int j = 0; j < L::kCount; ++j) r[j] = col[j] >= 0 ? __ldg(row + col[j]) : 0;
    };
    auto masks = [&](const int (&r)[L::kCount], uint32_t& left, uint32_t& right) {
      left = right = 0u;
#pragma unroll
      for (int j = 0; j < L::kCount; ++j) {
        left |= r[j] < 0 ? L::mask(j) : 0u;
        right |= r[j] > 0 ? L::mask(j) : 0u;
      }
    };
    // the cell words of sweep line i
    auto line_of = [&](int i) -> const int32_t* {
      if constexpr (kGlobalD) {
        return a.cells + static_cast<int64_t>(a.forward ? i : a.p_len - 1 - i) * a.q_len;
      } else {
        return s_cells + ((i - start) & 1) * a.q_len;
      }
    };

    if constexpr (!kGlobalD) {
      stage_line(s_cells, a.cells, a.forward ? start : a.p_len - 1 - start, a.q_len);
    }
    int r_next[L::kCount];
    load_rel(start, r_next);
    uint32_t left, right;
    masks(r_next, left, right);
    if constexpr (!kGlobalD) asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();

    for (int i = start; i < last; ++i) {
      const int32_t* line = line_of(i);
      if (i + 1 < last) {  // the next line's cells and drift load while this one is swept
        if constexpr (!kGlobalD) {
          stage_line(s_cells + ((i + 1 - start) & 1) * a.q_len, a.cells,
                     a.forward ? i + 1 : a.p_len - 2 - i, a.q_len);
        }
        load_rel(i + 1, r_next);
      }
      const uint32_t mid = ~(left | right);
      const bool store = i >= first && any;
      for (int k = threadIdx.x; k < items; k += blockDim.x) {
        const int idx = k + words;  // cell q = k >> words_log2 at padded index q + 1
        const uint32_t nbr =
            (prev[idx - words] & left) | (prev[idx] & mid) | (prev[idx + words] & right);
        const uint32_t cell = static_cast<uint32_t>(
            kGlobalD ? __ldg(line + (k >> a.words_log2)) : line[k >> a.words_log2]);
        const uint32_t d = (cell & kOccupied) ? 0u : L::sat_inc(nbr, c_word);
        cur[idx] = d;
        const uint32_t row = cell & ~kOccupied;
        if (!store || (a.skip_row0 && row == 0)) continue;
        uint32_t e[L::kCount];
#pragma unroll
        for (int j = 0; j < L::kCount; ++j) {
          e[j] = entry_bits(L::as_float_bits(d, j), sl[j], a.maxr);
        }
        OutT* dst = out + (a.row_base + row) * a.row_stride + col0;
        if (vector_store) {
          *reinterpret_cast<uint32_t*>(dst) = L::pack(e);
        } else {
#pragma unroll
          for (int j = 0; j < L::kCount; ++j) {
            if (col[j] >= 0) dst[j] = static_cast<OutT>(e[j]);
          }
        }
      }
      masks(r_next, left, right);
      if constexpr (!kGlobalD) asm volatile("cp.async.wait_all;\n" ::: "memory");
      __syncthreads();  // this line's D before the next line reads it, in either memory
      uint32_t* t = prev;
      prev = cur;
      cur = t;
    }
  }
}

// Opt the instantiation into all the dynamic shared memory a block may
// have, once per device: the attribute holds for every later launch.
template <typename OutT, bool kGlobalD>
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
  err = cudaFuncSetAttribute(range_lut_sweep_kernel<OutT, kGlobalD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (err == cudaSuccess) done |= bit;
  return err;
}

template <typename OutT, bool kGlobalD>
int occupancy(int threads, int q_len, int words, int* blocks) {
  cudaError_t err = opt_in_smem<OutT, kGlobalD>();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, range_lut_sweep_kernel<OutT, kGlobalD>, threads,
      static_cast<size_t>(smem_bytes(q_len, words, kGlobalD))));
}

template <typename OutT, bool kGlobalD>
int launch(const SweepArgs& a, int blocks, int threads, OutT* out, void* stream) {
  const cudaError_t err = opt_in_smem<OutT, kGlobalD>();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = static_cast<size_t>(smem_bytes(a.q_len, 1 << a.words_log2, kGlobalD));
  range_lut_sweep_kernel<OutT, kGlobalD>
      <<<blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(a, out);
  return static_cast<int>(cudaGetLastError());
}

template <typename OutT>
int launch(const SweepArgs& a, int blocks, int threads, OutT* out, void* stream) {
  if (a.p_len <= 0 || a.q_len <= 0 || a.n_tiles <= 0 || a.items <= 0 || blocks <= 0) return 0;
  return a.scratch != nullptr ? launch<OutT, true>(a, blocks, threads, out, stream)
                              : launch<OutT, false>(a, blocks, threads, out, stream);
}

SweepArgs make_args(const int32_t* cells, uint32_t* scratch, const int8_t* rel,
                    const float* step_len, const int32_t* tiles, int n_tiles, int items,
                    int p_len, int q_len, int b_count, int words_log2, int lines, int forward,
                    int skip_row0, int sat, float maxr, int vec_ok, int64_t row_stride,
                    int64_t row_base) {
  return SweepArgs{cells, scratch, rel, step_len, reinterpret_cast<const int4*>(tiles), n_tiles,
                   items, p_len, q_len, b_count, words_log2, lines, forward, skip_row0, sat,
                   maxr, vec_ok, row_stride, row_base};
}

}  // namespace

extern "C" {

// Blocks of `threads` an SM holds for a line of q_len cells at `words`
// words a cell (itemsize 1: u8, 2: u16), with D in shared memory or, for
// global_d, in global memory; returns a CUDA error code.
int mcl_range_lut_sweep_occupancy(int itemsize, int threads, int q_len, int words, int global_d,
                                  int* blocks) {
  if (global_d) {
    return itemsize == 1 ? occupancy<uint8_t, true>(threads, q_len, words, blocks)
                         : occupancy<uint16_t, true>(threads, q_len, words, blocks);
  }
  return itemsize == 1 ? occupancy<uint8_t, false>(threads, q_len, words, blocks)
                       : occupancy<uint16_t, false>(threads, q_len, words, blocks);
}

// One group's sweep over `items` (tile, chunk) pairs by `blocks` blocks;
// `scratch` (blocks x 2 x (q_len + 2) x words words) puts D in global
// memory, null keeps it in shared memory (then blocks == items).
int mcl_range_lut_sweep_u8(const int32_t* cells, uint32_t* scratch, const int8_t* rel,
                           const float* step_len, const int32_t* tiles, int n_tiles, int items,
                           int p_len, int q_len, int b_count, int words_log2, int lines,
                           int forward, int skip_row0, int sat, float maxr, int vec_ok,
                           int64_t row_stride, int64_t row_base, int blocks, int threads,
                           uint8_t* out, void* stream) {
  return launch<uint8_t>(make_args(cells, scratch, rel, step_len, tiles, n_tiles, items, p_len,
                                   q_len, b_count, words_log2, lines, forward, skip_row0, sat,
                                   maxr, vec_ok, row_stride, row_base),
                         blocks, threads, out, stream);
}

int mcl_range_lut_sweep_u16(const int32_t* cells, uint32_t* scratch, const int8_t* rel,
                            const float* step_len, const int32_t* tiles, int n_tiles, int items,
                            int p_len, int q_len, int b_count, int words_log2, int lines,
                            int forward, int skip_row0, int sat, float maxr, int vec_ok,
                            int64_t row_stride, int64_t row_base, int blocks, int threads,
                            uint16_t* out, void* stream) {
  return launch<uint16_t>(make_args(cells, scratch, rel, step_len, tiles, n_tiles, items, p_len,
                                    q_len, b_count, words_log2, lines, forward, skip_row0, sat,
                                    maxr, vec_ok, row_stride, row_base),
                          blocks, threads, out, stream);
}

}  // extern "C"
