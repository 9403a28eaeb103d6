// Fused range-LUT lookup + beam-model log-likelihood, one value per
// particle, for Hopper (sm_90a).
//
// Replaces the TPU kernel monte_carlo_localization_tpu/ops/pallas_lut.py
// build_lut_query_fn -> kernel (:450) in all three of its forms: K1, the
// full-window reduce (block_logp, :420); K2, the compact-beam form
// (block_logp_compact, :434), which differs only in the order of the
// beam sum, so one kernel serves both beam counts; and K3, the sub-bin
// heading lerp (subbin, next_bin/lerp_bins :383-398, used at :499-500),
// a template argument: the window starts at floor(theta * T / 2pi) and
// each beam lerps toward its +1 bin by the fractional bin (beam_model.cuh
// window_range). The lerp reads one more LUT entry per beam from the
// same row and makes the expected range a fraction, so K3 reads its
// normaliser from the sub-bin table (a cubic segment per 1/2 px,
// subbin_norm_kernel below) and computes the short term's reciprocal.
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
// What binds it on an H100, and what the design does about it. The large
// shapes (64 x 4000 x 60, 100k x 60, 4000 x 1080) are bound by the
// arithmetic of a beam term, not by bytes: a term's LUT byte comes from
// L2 or HBM at a small fraction of their rates, while the analytic model
// costs two erf (a division and an exp each), a third division and two
// logs per term. So:
//   - the normaliser, which depends on the expected range alone, is read
//     from a table in shared memory (beam_model.cuh), filled once per
//     query by log_norm_kernel (integer entries: one exp and one log a
//     term) or subbin_norm_kernel (the sub-bin lerp: three more FMAs and
//     a reciprocal) below. How the model is evaluated is a template
//     argument, so a tabled kernel carries no analytic code: half the
//     code to fetch, which the 4 us shapes feel;
//   - tabled scans of <= 64 beams (K2, and K3 with its table) put two
//     particles in a warp (16 lanes each, every lane <= 4 terms from
//     registers), so no lane idles at 60 beams and the butterfly is 4
//     steps for two particles; the next particle's window values are
//     loaded before this one's are summed (beam_model.cuh group_rounds).
//     Analytic terms (a range past the tables' cap) are about four times
//     as long, so they keep a warp per particle;
//   - a group of lanes takes P consecutive particles (P <= the group's
//     lanes, chosen by the launcher so the grid is about two waves): lane
//     i does the address math of particle i (two IEEE divisions, a rint,
//     a remainder, the row_map load), once per P particles instead of on
//     every lane for every particle, and hands the window to the group by
//     shuffle; results go out in one coalesced store;
//   - a block stages min(obs, m) with the beam offsets and the table
//     (1.6-8 KB; 6.4 KB of sub-bin table at m = 200) once for its
//     8..16 x P particles.
// The small shapes (4000 x 60) are bound by latency: the launch, the
// staging and the dependent loads particle -> row_map -> window; the
// particle load starts before the staging so the two overlap.
//
// Numerics follow the TPU kernel in float32, through the beam model that
// beam_model.cuh shares with lut_dedup.cu and mega_step.cu. Only the beam
// sum is wider: it accumulates in double.
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
// members x blocks_per_member blocks, so a block never straddles one and
// stages its member's scan and map tables in shared memory once; the last
// block of a member idles the groups past npm. JAX's member chunking
// (SMEM_PARTICLE_CAP) is TPU glue: one launch serves 64 x 4000 particles.

#include <cstdint>

#include <cuda_runtime.h>

#include "beam_model.cuh"

namespace {

using mcl::kWarp;
using mcl::Model;
using mcl::Params;
constexpr int kThreads = 256;
constexpr int kWaves = 2;  // the grid the launcher aims for, in full waves

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

template <typename T>
struct Args {
  const T* lut;
  int64_t row_stride;
  const int32_t* row_map;
  const int32_t* row_map_bases;
  const float* particles;
  int64_t npm;
  unsigned blocks_per_member;
  int per_group;  // P: consecutive particles per group of lanes
  int member_base;
  const int32_t* map_of;
  int per_member;
  const float* origin_x;
  const float* origin_y;
  const int32_t* dims;
  const int32_t* lut_bases;
  int eps;
  const float* obs_px;
  const int32_t* offsets;
  int r, base, t_bins;
  const float2* table;  // the query's normaliser table, or null
  int table_entries;
  Params p;
  float* out;
};

template <typename T, Model kModel, int kGroup>
__global__ void __launch_bounds__(kThreads) lut_loglik_kernel(Args<T> a) {
  constexpr bool kSubbin = mcl::lerps(kModel);
  extern __shared__ __align__(16) float2 smem[];
  __shared__ MapView<T> s_map;
  constexpr int kGroups = kThreads / kGroup;
  const Params& p = a.p;
  const unsigned member = blockIdx.x / a.blocks_per_member;
  const unsigned block = blockIdx.x % a.blocks_per_member;
  const int lane = threadIdx.x % kWarp;
  const int lig = threadIdx.x % kGroup;  // lane in group

  // this group's P consecutive particles of the member; lane i owns the
  // address math and the result of particle i
  const int64_t first =
      (static_cast<int64_t>(block) * kGroups + threadIdx.x / kGroup) * a.per_group;
  const int64_t left = a.npm - first;
  const int count = left <= 0 ? 0 : (left < a.per_group ? static_cast<int>(left) : a.per_group);
  const int64_t i = static_cast<int64_t>(member) * a.npm + first + lig;
  float x = 0.0f, y = 0.0f, theta = 0.0f;
  if (lig < count) {  // in flight while the block stages
    x = a.particles[3 * i];
    y = a.particles[3 * i + 1];
    theta = a.particles[3 * i + 2];
  }

  if (threadIdx.x == 0) {
    const int mi = a.member_base + static_cast<int>(member);
    const int map = a.per_member ? (a.map_of ? a.map_of[mi] : mi) : 0;
    // widen before multiplying: lut_bases * eps passes 2^31 entries
    s_map.lut = a.lut + static_cast<int64_t>(a.lut_bases[map]) * a.eps;
    s_map.rows = a.row_map && a.row_map_bases ? a.row_map + a.row_map_bases[map]
                                              : a.row_map;
    s_map.ox = a.origin_x[map];
    s_map.oy = a.origin_y[map];
    s_map.height = a.dims[2 * map];
    s_map.width = a.dims[2 * map + 1];
  }
  const mcl::BeamStage s = mcl::stage_beams(
      smem, a.obs_px + static_cast<int64_t>(member) * a.r, a.offsets, a.r, a.table,
      a.table_entries, p, kModel == Model::kLerped);
  __syncthreads();
  const MapView<T> m = s_map;

  const T* win = nullptr;  // null off the map
  float frac = 0.0f;
  if (lig < count) {
    mcl::Window w;
    if (mcl::particle_window<kSubbin>(x, y, theta, m.ox, m.oy, m.rows, a.base,
                                      a.t_bins, m.height, m.width, p, &w)) {
      win = m.lut + (w.row * a.row_stride + w.b0);
      frac = w.frac;
    }
  }
  const float mine = mcl::group_rounds<kGroup, kModel>(win, frac, count, s, a.r, lane, p);
  if (lig < count) a.out[i] = mine;
}

// Fills the sub-bin table of one query: count = kSubbinSteps * m + 1
// entries (beam_model.cuh subbin_entry).
__global__ void subbin_norm_kernel(int count, Params p, float4* __restrict__ out) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k < count) out[k] = mcl::subbin_entry(k, p);
}

// Fills the normaliser table of one query: entry e holds
// {log norm(d), 1 / max(d, 1)} at d = min(e, m), or with ``d_in`` at
// d_in[e] clipped to [0, m], the model's domain (how the analytic function
// is read out for any d).
__global__ void log_norm_kernel(const float* __restrict__ d_in, int count, Params p,
                                float2* __restrict__ out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= count) return;
  const float d = fminf(d_in ? fmaxf(d_in[e], 0.0f) : static_cast<float>(e), p.m);
  out[e] = mcl::norm_entry(d, p);
}

template <typename T, Model kModel, int kGroup>
int launch_as(Args<T> a, int members, void* stream) {
  constexpr int kGroups = kThreads / kGroup;
  const size_t smem = mcl::stage_bytes(a.r, a.table ? a.table_entries : 0,
                                       kModel == Model::kLerped);
  auto kernel = lut_loglik_kernel<T, kModel, kGroup>;
  int resident = 0;
  const cudaError_t err = mcl::resident_blocks(kernel, smem, kThreads, &resident);
  if (err != cudaSuccess) return static_cast<int>(err);
  // P particles per group so that the grid is about kWaves waves; never
  // more than the group has lanes to own them
  const int64_t groups = static_cast<int64_t>(resident) * kGroups * kWaves;
  const int64_t total = a.npm * members;
  int64_t per_group = (total + groups - 1) / groups;
  per_group = per_group < 1 ? 1 : (per_group > kGroup ? kGroup : per_group);
  const int64_t per_block = per_group * kGroups;
  const int64_t per_member_blocks = (a.npm + per_block - 1) / per_block;
  const int64_t blocks = per_member_blocks * members;  // 32-bit block math in the kernel
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidConfiguration);
  a.per_group = static_cast<int>(per_group);
  a.blocks_per_member = static_cast<unsigned>(per_member_blocks);
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const T* lut, int64_t row_stride, const int32_t* row_map,
           const int32_t* row_map_bases, const float* particles, int members,
           int64_t npm, int member_base, const int32_t* map_of, int per_member,
           const float* origin_x, const float* origin_y, const int32_t* dims,
           const int32_t* lut_bases, int eps, const float* obs_px,
           const int32_t* offsets, int r, int base, int t_bins, int subbin,
           const float* consts, const float* table, int table_entries, float* out,
           void* stream) {
  if (members <= 0 || npm <= 0) return 0;
  const Params p = mcl::params_from(consts);
  if (table != nullptr && !mcl::table_fits(subbin, table_entries, p)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args<T> a;
  a.lut = lut;
  a.row_stride = row_stride;
  a.row_map = row_map;
  a.row_map_bases = row_map_bases;
  a.particles = particles;
  a.npm = npm;
  a.member_base = member_base;
  a.map_of = map_of;
  a.per_member = per_member;
  a.origin_x = origin_x;
  a.origin_y = origin_y;
  a.dims = dims;
  a.lut_bases = lut_bases;
  a.eps = eps;
  a.obs_px = obs_px;
  a.offsets = offsets;
  a.r = r;
  a.base = base;
  a.t_bins = t_bins;
  a.table = reinterpret_cast<const float2*>(table);
  a.table_entries = table_entries;
  a.p = p;
  a.out = out;
  switch (mcl::model_of(subbin, table != nullptr)) {
    case Model::kLerped:
      return mcl::group_lanes(r, Model::kLerped) == mcl::kSmallGroup
                 ? launch_as<T, Model::kLerped, mcl::kSmallGroup>(a, members, stream)
                 : launch_as<T, Model::kLerped, kWarp>(a, members, stream);
    case Model::kLerpedAnalytic:
      return launch_as<T, Model::kLerpedAnalytic, kWarp>(a, members, stream);
    case Model::kAnalytic:
      return launch_as<T, Model::kAnalytic, kWarp>(a, members, stream);
    default:
      return mcl::group_lanes(r, Model::kTabled) == mcl::kSmallGroup
                 ? launch_as<T, Model::kTabled, mcl::kSmallGroup>(a, members, stream)
                 : launch_as<T, Model::kTabled, kWarp>(a, members, stream);
  }
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
           int t_bins, int subbin, const float* consts, const float* table,  \
           int table_entries, float* out, void* stream) {                    \
    return launch<T>(lut, row_stride, row_map, row_map_bases, particles,     \
                     members, npm, member_base, map_of, per_member,          \
                     origin_x, origin_y, dims, lut_bases, eps, obs_px,       \
                     offsets, r, base, t_bins, subbin, consts, table,        \
                     table_entries, out, stream);                            \
  }

MCL_LUT_ENTRY(mcl_lut_loglik_u8, uint8_t)
MCL_LUT_ENTRY(mcl_lut_loglik_u16, uint16_t)

// out (count, 2) float32: the normaliser table of the query with these
// constants (d_in null), or the same function at d_in[0..count).
int mcl_log_norm(const float* d_in, int count, const float* consts, float* out,
                 void* stream) {
  if (count <= 0) return 0;
  const Params p = mcl::params_from(consts);
  log_norm_kernel<<<(count + 127) / 128, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      d_in, count, p, reinterpret_cast<float2*>(out));
  return static_cast<int>(cudaGetLastError());
}

// out (count, 4) float32: the sub-bin table of the query with these
// constants, count = kSubbinSteps * m + 1.
int mcl_subbin_norm(int count, const float* consts, float* out, void* stream) {
  const Params p = mcl::params_from(consts);
  if (!mcl::table_fits(true, count, p)) return static_cast<int>(cudaErrorInvalidValue);
  subbin_norm_kernel<<<(count + 127) / 128, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      count, p, reinterpret_cast<float4*>(out));
  return static_cast<int>(cudaGetLastError());
}

int mcl_max_table_entries() { return mcl::kMaxTableEntries; }

int mcl_max_subbin_entries() { return mcl::kMaxSubbinEntries; }

int mcl_subbin_steps() { return mcl::kSubbinSteps; }

const char* mcl_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
