// The analytic beam model, the per-particle beam sum and the window
// address math, shared by the LUT-likelihood kernel (lut_likelihood.cu,
// TPU kernels K1/K2/K3), the unique-window kernel (lut_dedup.cu, TPU
// kernels K4/K5) and the mega step (mega_step.cu, TPU kernel K6), so all
// evaluate one copy of the math.
//
// It is the TPU kernels' beam model: monte_carlo_localization_tpu/ops/
// pallas_lut.py beam_model (:400-418) with its Abramowitz & Stegun
// 7.1.26 erf (_erf, :62-74), which ops/pallas_mega.py beam_model
// (:177-195) repeats. Float32 throughout, IEEE division (build without
// --use_fast_math), constants folded from double on the host.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace mcl {

constexpr int kWarp = 32;

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

// log p(obs | d) for one beam; obs is already clipped to m.
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

// The expected range of one beam: the window entry at ``off``, or with
// the sub-bin lerp (TPU kernel K3, pallas_lut.py lerp_bins :394-398) its
// interpolation toward the +1 bin by the heading's fractional bin,
// x0 + frac * (x1 - x0) in round-to-nearest steps so nothing is fused into
// an FMA. off + 1 needs no wrap modulo T: the guard bin of
// window_entries and the row's wraparound padding put bin T at bin 0's
// place.
template <bool kSubbin, typename T>
__device__ __forceinline__ float window_range(const T* window, int off,
                                              float frac) {
  const float x0 = static_cast<float>(window[off]);
  if (!kSubbin) return x0;
  const float x1 = static_cast<float>(window[off + 1]);
  return __fadd_rn(x0, __fmul_rn(frac, __fsub_rn(x1, x0)));
}

// inv_squash * sum_j log p(obs_j | window[off_j]) for one particle,
// computed by one whole warp: lane l takes beams l, l+32, ... ``window``
// may point into global or shared memory (the dedup kernel's staged
// windows go through this same code, which keeps it bit-equal to K1).
// Every lane returns lane 0's sum (the butterfly leaves each lane its own
// rounding order), so the warp stays uniform. The beam sum accumulates in
// double, so the float32 result is the rounded sum of the float32 terms
// whatever the summation order, and the kernels agree with their plain
// versions to ~1 ulp.
template <typename T, bool kSubbin = false>
__device__ __forceinline__ float warp_window_logp(
    const T* window, const float* s_obs, const int32_t* s_off, int r,
    int lane, const Params& p, float frac = 0.0f) {
  double acc = 0.0;
  for (int j = lane; j < r; j += kWarp) {
    acc += beam_logp(window_range<kSubbin>(window, s_off[j], frac), s_obs[j],
                     p);
  }
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  }
  acc = __shfl_sync(0xffffffffu, acc, 0);
  return p.inv_squash * static_cast<float>(acc);
}

// Where one particle's window starts (pallas_lut.py query :855-912), the
// address math of the LUT kernels (lut_likelihood.cu, lut_dedup.cu):
//   cell = (int)((y - oy) / res) * W + (int)((x - ox) / res)  (truncating)
//   row  = row_map ? row_map[cell] : cell
//   b0   = (rint(theta * T / 2pi) + base) mod T                (half to even)
// or, with the sub-bin lerp, b0 from floor(theta * T / 2pi) and frac its
// fractional part. Returns false for a particle outside the map. The
// origin is the map's float32 origin: a batched map's own (JAX's
// origins[0][mi]), or the single map's as folded into Params.
struct Window {
  int64_t row;
  int b0;
  float frac;
};

template <bool kSubbin>
__device__ __forceinline__ bool particle_window(
    float x, float y, float theta, float ox, float oy,
    const int32_t* __restrict__ row_map, int base, int t_bins, int height,
    int width, const Params& p, Window* w) {
  const int gx = static_cast<int>((x - ox) / p.res);
  const int gy = static_cast<int>((y - oy) / p.res);
  if (gx < 0 || gx >= width || gy < 0 || gy >= height) return false;
  const int64_t cell = static_cast<int64_t>(gy) * width + gx;
  w->row = row_map ? static_cast<int64_t>(row_map[cell]) : cell;
  int b0;
  if (kSubbin) {
    const float bpos = __fmul_rn(theta, p.bin_scale);
    const float bf = floorf(bpos);
    w->frac = __fsub_rn(bpos, bf);
    b0 = static_cast<int>(bf);
  } else {
    b0 = static_cast<int>(rintf(theta * p.bin_scale));
    w->frac = 0.0f;
  }
  b0 = (b0 + base) % t_bins;  // truncating remainder, then fixed up
  if (b0 < 0) b0 += t_bins;
  w->b0 = b0;
  return true;
}

// Unpack the host's float array into Params.
inline Params params_from(const float* consts) {
  static_assert(sizeof(Params) == kNumConsts * sizeof(float),
                "Params must be kNumConsts packed floats");
  Params p;
  float* fields = reinterpret_cast<float*>(&p);
  for (int c = 0; c < kNumConsts; ++c) fields[c] = consts[c];
  return p;
}

}  // namespace mcl
