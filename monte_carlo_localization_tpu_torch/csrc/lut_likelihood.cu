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
// pallas_lut.py:835-949; for one map:
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
//
// One kernel serves one map and a fleet (num_members / per_member_maps,
// pallas_lut.py:835-949): F members of npm particles each, in one launch.
// Particle i of member m = i / npm reads scan row m; over a batched map it
// reads map
//   map = map_of ? map_of[member_base + m] : member_base + m
// with that map's float32 origin and true (H, W), the compact row
// row_map[row_map_bases[map] + cell], and the window at
//   lut_bases[map] * eps + row * row_stride + b0        (64-bit)
// where lut_bases counts subrows of eps entries (the JAX layout). One map
// is the fleet of one member on map 0 (LUTQuery.launch passes its tables).
// The TPU grid could put a block across two members; here the grid is
// members x ceil(npm / 8) blocks, so a block never straddles one and
// stages its member's scan and map tables in shared memory once; the
// last block of a member idles npm % 8 of its warps at most. JAX's member
// chunking (SMEM_PARTICLE_CAP) is TPU glue: one launch serves 64 x 4000
// particles.

#include <cstdint>

#include <cuda_runtime.h>

#include "beam_model.cuh"

namespace {

using mcl::kWarp;
using mcl::Params;
constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarp * kWarpsPerBlock;

// One map's part of the fleet tables, uniform over a block (a block never
// straddles a member), so thread 0 reads it once beside the scan staging
// and no warp waits on those loads before its particle's address math.
template <typename T>
struct MapView {
  const T* lut;          // the map's LUT block
  const int32_t* rows;   // the map's cells in the row map, or null (dense)
  float ox, oy;          // float32 origin
  int height, width;
};

template <typename T, bool kSubbin>
__global__ void __launch_bounds__(kThreads)
    lut_loglik_kernel(const T* __restrict__ lut, int64_t row_stride,
                      const int32_t* __restrict__ row_map,
                      const int32_t* __restrict__ row_map_bases,
                      const float* __restrict__ particles, int64_t npm,
                      unsigned blocks_per_member, int member_base,
                      const int32_t* __restrict__ map_of, int per_member,
                      const float* __restrict__ origin_x,
                      const float* __restrict__ origin_y,
                      const int32_t* __restrict__ dims,
                      const int32_t* __restrict__ lut_bases, int eps,
                      const float* __restrict__ obs_px,
                      const int32_t* __restrict__ offsets, int r, int base,
                      int t_bins, Params p, float* __restrict__ out) {
  extern __shared__ float smem[];
  __shared__ MapView<T> s_map;
  float* s_obs = smem;
  int32_t* s_off = reinterpret_cast<int32_t*>(smem + r);
  const unsigned member = blockIdx.x / blocks_per_member;
  if (threadIdx.x == 0) {
    const int mi = member_base + static_cast<int>(member);
    const int map = per_member ? (map_of ? map_of[mi] : mi) : 0;
    // widen before multiplying: lut_bases * eps passes 2^31 entries
    s_map.lut = lut + static_cast<int64_t>(lut_bases[map]) * eps;
    s_map.rows = row_map && row_map_bases ? row_map + row_map_bases[map] : row_map;
    s_map.ox = origin_x[map];
    s_map.oy = origin_y[map];
    s_map.height = dims[2 * map];
    s_map.width = dims[2 * map + 1];
  }
  const float* obs_row = obs_px + static_cast<int64_t>(member) * r;
  for (int j = threadIdx.x; j < r; j += blockDim.x) {
    s_obs[j] = fminf(obs_row[j], p.m);
    s_off[j] = offsets[j];
  }
  __syncthreads();

  const int lane = threadIdx.x % kWarp;
  const int64_t local =
      static_cast<int64_t>(blockIdx.x % blocks_per_member) * kWarpsPerBlock +
      threadIdx.x / kWarp;
  if (local >= npm) return;  // whole warps leave together
  const int64_t i = static_cast<int64_t>(member) * npm + local;
  const MapView<T> m = s_map;

  mcl::Window w;
  if (!mcl::particle_window<kSubbin>(particles[3 * i], particles[3 * i + 1],
                                     particles[3 * i + 2], m.ox, m.oy, m.rows,
                                     base, t_bins, m.height, m.width, p, &w)) {
    if (lane == 0) out[i] = -1e4f;
    return;
  }
  const T* window = m.lut + w.row * row_stride + w.b0;
  const float logw = mcl::warp_window_logp<T, kSubbin>(window, s_obs, s_off,
                                                       r, lane, p, w.frac);
  if (lane == 0) out[i] = logw;
}

template <typename T>
int launch(const T* lut, int64_t row_stride, const int32_t* row_map,
           const int32_t* row_map_bases, const float* particles, int members,
           int64_t npm, int member_base, const int32_t* map_of, int per_member,
           const float* origin_x, const float* origin_y, const int32_t* dims,
           const int32_t* lut_bases, int eps, const float* obs_px,
           const int32_t* offsets, int r, int base, int t_bins, int subbin,
           const float* consts, float* out, void* stream) {
  if (members <= 0 || npm <= 0) return 0;
  const Params p = mcl::params_from(consts);
  const int64_t per_member_blocks = (npm + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const int64_t blocks = per_member_blocks * members;  // 32-bit block math below
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidConfiguration);
  const size_t smem = static_cast<size_t>(r) * (sizeof(float) + sizeof(int32_t));
  auto kernel = subbin ? lut_loglik_kernel<T, true> : lut_loglik_kernel<T, false>;
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      lut, row_stride, row_map, row_map_bases, particles, npm,
      static_cast<unsigned>(per_member_blocks), member_base, map_of, per_member, origin_x, origin_y,
      dims, lut_bases, eps, obs_px, offsets, r, base, t_bins, p, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

#define MCL_LUT_ENTRY(NAME, T)                                                \
  int NAME(const T* lut, int64_t row_stride, const int32_t* row_map,         \
           const int32_t* row_map_bases, const float* particles, int members, \
           int64_t npm, int member_base, const int32_t* map_of,              \
           int per_member, const float* origin_x, const float* origin_y,     \
           const int32_t* dims, const int32_t* lut_bases, int eps,           \
           const float* obs_px, const int32_t* offsets, int r, int base,     \
           int t_bins, int subbin, const float* consts, float* out,          \
           void* stream) {                                                    \
    return launch<T>(lut, row_stride, row_map, row_map_bases, particles,     \
                     members, npm, member_base, map_of, per_member,          \
                     origin_x, origin_y, dims, lut_bases, eps, obs_px,       \
                     offsets, r, base, t_bins, subbin, consts, out, stream); \
  }

MCL_LUT_ENTRY(mcl_lut_loglik_u8, uint8_t)
MCL_LUT_ENTRY(mcl_lut_loglik_u16, uint16_t)

const char* mcl_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
