// ============================================================================
// mcl_native — host-side native kernels for the TPU MCL engine.
//
// The TPU compute path is JAX/XLA; this library covers the host runtime:
//   * exact 2-D Euclidean distance transform (Felzenszwalb/Huttenlocher),
//     used at map-load time to build the sphere-marching clearance field,
//   * an OpenMP batch DDA ray caster, the native correctness oracle and
//     trace synthesizer (the role OpenMP ray casting plays in the
//     reference, src/particle_filter.cpp:586-650 — here it is a host tool,
//     not the production compute path).
//
// C ABI, loaded from Python via ctypes.
// ============================================================================

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <limits>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

constexpr double kInf = 1e20;

// Exact 1-D squared distance transform (lower envelope of parabolas).
void edt_1d(const double* f, int n, double* d, int* v, double* z) {
  int k = 0;
  v[0] = 0;
  z[0] = -kInf;
  z[1] = kInf;
  for (int q = 1; q < n; ++q) {
    double s = ((f[q] + q * q) - (f[v[k]] + v[k] * v[k])) / (2.0 * q - 2.0 * v[k]);
    while (s <= z[k]) {
      --k;
      s = ((f[q] + q * q) - (f[v[k]] + v[k] * v[k])) / (2.0 * q - 2.0 * v[k]);
    }
    ++k;
    v[k] = q;
    z[k] = s;
    z[k + 1] = kInf;
  }
  k = 0;
  for (int q = 0; q < n; ++q) {
    while (z[k + 1] < q) ++k;
    d[q] = double(q - v[k]) * (q - v[k]) + f[v[k]];
  }
}

}  // namespace

// Shear-scan DP range-LUT builder, templated on the output cell type:
// uint8 when max_range_px <= 254 (the common case, half the memory),
// uint16 for long-range/fine-resolution maps (max_range_px <= 65534).
template <typename OutT>
static void build_range_lut_impl(const uint8_t* occupied, int h, int w,
                                 int t_bins, int max_range_px, OutT* out) {
  const double two_pi = 6.283185307179586;
#ifdef _OPENMP
#pragma omp parallel
#endif
  {
    std::vector<float> d_prev, d_cur;
#ifdef _OPENMP
#pragma omp for schedule(dynamic, 1)
#endif
    for (int t = 0; t < t_bins; ++t) {
      const double theta = two_pi * t / t_bins;
      const double c = std::cos(theta), s = std::sin(theta);
      const bool row_major_axis = std::abs(s) >= std::abs(c);
      const int P = row_major_axis ? h : w;
      const int Q = row_major_axis ? w : h;
      const int sp = row_major_axis ? (s > 0 ? 1 : -1) : (c > 0 ? 1 : -1);
      const double denom = row_major_axis ? std::abs(s) : std::abs(c);
      const double delta = (row_major_axis ? c : s) / denom;
      const float step_len = static_cast<float>(1.0 / denom);

      d_prev.assign(Q, 0.0f);
      d_cur.assign(Q, 0.0f);
      const int p_start = (sp > 0) ? P - 1 : 0;
      const int p_end = (sp > 0) ? -1 : P;
      const int p_stepi = (sp > 0) ? -1 : 1;
      const float maxr = static_cast<float>(max_range_px);
      for (int p = p_start; p != p_end; p += p_stepi) {
        const long shift_p = std::lround(delta * sp * p);
        const long shift_n = std::lround(delta * sp * (p + sp));
        const long rel = shift_n - shift_p;
        for (int q = 0; q < Q; ++q) {
          const int y = row_major_axis ? p : q;
          const int x = row_major_axis ? q : p;
          const bool occ = occupied[static_cast<size_t>(y) * w + x];
          float dist;
          if (occ) {
            dist = 0.0f;
          } else {
            const long qn = q + rel;
            const float next = (qn >= 0 && qn < Q) ? d_prev[qn] : 0.0f;
            dist = next + 1.0f;
          }
          d_cur[q] = dist;
          float px = dist * step_len - 1.0f;  // reference DDA bias (-1 px)
          if (px < 0.0f) px = 0.0f;
          if (px > maxr) px = maxr;
          out[(static_cast<size_t>(y) * w + x) * t_bins + t] =
              static_cast<OutT>(px + 0.5f);
        }
        std::swap(d_prev, d_cur);
      }
    }
  }
}

// Compact variant: only cells with row_map[cell] > 0 (those within
// max_range of an obstacle) get real LUT rows; everything else shares the
// caller-initialized constant far row 0. Rows are written PADDED to
// row_stride entries with angle wraparound (entry b = bin b % t_bins),
// i.e. the layout the Pallas query kernel consumes directly. Threads
// parallelize over theta bins; two bins never write the same entry
// (b == t mod t_bins), so the scattered writes are race-free.
template <typename OutT>
static void build_compact_range_lut_impl(const uint8_t* occupied, int h,
                                         int w, int t_bins, int max_range_px,
                                         const int32_t* row_map,
                                         int row_stride, OutT* out) {
  const double two_pi = 6.283185307179586;
#ifdef _OPENMP
#pragma omp parallel
#endif
  {
    std::vector<float> d_prev, d_cur;
#ifdef _OPENMP
#pragma omp for schedule(dynamic, 1)
#endif
    for (int t = 0; t < t_bins; ++t) {
      const double theta = two_pi * t / t_bins;
      const double c = std::cos(theta), s = std::sin(theta);
      const bool row_major_axis = std::abs(s) >= std::abs(c);
      const int P = row_major_axis ? h : w;
      const int Q = row_major_axis ? w : h;
      const int sp = row_major_axis ? (s > 0 ? 1 : -1) : (c > 0 ? 1 : -1);
      const double denom = row_major_axis ? std::abs(s) : std::abs(c);
      const double delta = (row_major_axis ? c : s) / denom;
      const float step_len = static_cast<float>(1.0 / denom);

      d_prev.assign(Q, 0.0f);
      d_cur.assign(Q, 0.0f);
      const int p_start = (sp > 0) ? P - 1 : 0;
      const int p_end = (sp > 0) ? -1 : P;
      const int p_stepi = (sp > 0) ? -1 : 1;
      const float maxr = static_cast<float>(max_range_px);
      for (int p = p_start; p != p_end; p += p_stepi) {
        const long shift_p = std::lround(delta * sp * p);
        const long shift_n = std::lround(delta * sp * (p + sp));
        const long rel = shift_n - shift_p;
        for (int q = 0; q < Q; ++q) {
          const int y = row_major_axis ? p : q;
          const int x = row_major_axis ? q : p;
          const bool occ = occupied[static_cast<size_t>(y) * w + x];
          float dist;
          if (occ) {
            dist = 0.0f;
          } else {
            const long qn = q + rel;
            const float next = (qn >= 0 && qn < Q) ? d_prev[qn] : 0.0f;
            dist = next + 1.0f;
          }
          d_cur[q] = dist;
          const int32_t rm = row_map[static_cast<size_t>(y) * w + x];
          if (rm > 0) {
            float px = dist * step_len - 1.0f;
            if (px < 0.0f) px = 0.0f;
            if (px > maxr) px = maxr;
            const OutT v = static_cast<OutT>(px + 0.5f);
            OutT* row = out + static_cast<size_t>(rm) * row_stride;
            for (int b = t; b < row_stride; b += t_bins) row[b] = v;
          }
        }
        std::swap(d_prev, d_cur);
      }
    }
  }
}

extern "C" {

// Exact EDT in cells of a boolean obstacle mask (h x w, row-major).
void mcl_edt(const uint8_t* obstacle, int h, int w, float* out) {
  std::vector<double> sq(static_cast<size_t>(h) * w);
  for (size_t i = 0; i < sq.size(); ++i) sq[i] = obstacle[i] ? 0.0 : kInf;

#ifdef _OPENMP
#pragma omp parallel
#endif
  {
    std::vector<double> f(std::max(h, w)), d(std::max(h, w)), z(std::max(h, w) + 1);
    std::vector<int> v(std::max(h, w));
    // columns
#ifdef _OPENMP
#pragma omp for
#endif
    for (int x = 0; x < w; ++x) {
      for (int y = 0; y < h; ++y) f[y] = sq[static_cast<size_t>(y) * w + x];
      edt_1d(f.data(), h, d.data(), v.data(), z.data());
      for (int y = 0; y < h; ++y) sq[static_cast<size_t>(y) * w + x] = d[y];
    }
    // rows
#ifdef _OPENMP
#pragma omp for
#endif
    for (int y = 0; y < h; ++y) {
      double* row = sq.data() + static_cast<size_t>(y) * w;
      edt_1d(row, w, d.data(), v.data(), z.data());
      for (int x = 0; x < w; ++x) row[x] = d[x];
    }
  }
  for (size_t i = 0; i < sq.size(); ++i) out[i] = static_cast<float>(std::sqrt(sq[i]));
}

// Reference-exact fixed-step DDA ray cast over a batch of queries.
// occ: int8 occupancy (h x w, row-major, >50 == obstacle).
// queries: nq x 3 float32 (x_world, y_world, angle).
void mcl_cast_rays(const int8_t* occ, int h, int w, double origin_x,
                   double origin_y, double resolution, int max_range_px,
                   double max_range_meters, const float* queries, long nq,
                   float* out, int num_threads) {
#ifdef _OPENMP
  if (num_threads > 0) omp_set_num_threads(num_threads);
#pragma omp parallel for schedule(dynamic, 64)
#endif
  for (long i = 0; i < nq; ++i) {
    const double x0 = queries[i * 3 + 0];
    const double y0 = queries[i * 3 + 1];
    const double ang = queries[i * 3 + 2];
    const double dx = std::cos(ang) * resolution;
    const double dy = std::sin(ang) * resolution;
    double cx = x0, cy = y0;
    float result = static_cast<float>(max_range_meters);
    for (int step = 0; step < max_range_px; ++step) {
      cx += dx;
      cy += dy;
      const int gx = static_cast<int>((cx - origin_x) / resolution);
      const int gy = static_cast<int>((cy - origin_y) / resolution);
      if (gx < 0 || gx >= w || gy < 0 || gy >= h) {
        result = static_cast<float>(step * resolution);
        break;
      }
      if (occ[static_cast<size_t>(gy) * w + gx] > 50) {
        result = static_cast<float>(step * resolution);
        break;
      }
    }
    out[i] = result;
  }
}

// Precompute the angle-quantized range LUT by shear-scan dynamic
// programming: for each angle bin, shearing each row/column by the ray's
// per-row drift makes every ray a straight line in sheared coordinates
// (within +-0.5 cell, non-accumulating), so ranges for ALL cells follow
// from one O(H*W) backward sweep instead of per-cell marching.
//
// out: (h * w * t_bins) uint8, layout [y][x][t], value = range in px
//      (clipped to max_range_px; the map border counts as an obstacle,
//      matching the reference's boundary hit, src/particle_filter.cpp:629).
void mcl_build_range_lut(const uint8_t* occupied, int h, int w, int t_bins,
                         int max_range_px, uint8_t* out) {
  build_range_lut_impl<uint8_t>(occupied, h, w, t_bins, max_range_px, out);
}

// uint16 variant for max_range_px > 254 (long range / fine resolution).
void mcl_build_range_lut_u16(const uint8_t* occupied, int h, int w,
                             int t_bins, int max_range_px, uint16_t* out) {
  build_range_lut_impl<uint16_t>(occupied, h, w, t_bins, max_range_px, out);
}

// Row-compacted builders (giant maps): out is (num_rows, row_stride) with
// row 0 the caller-initialized shared far row; cells map to rows via
// row_map (h*w int32, 0 = far row). Rows come out padded with angle
// wraparound, ready for the Pallas query kernel.
void mcl_build_compact_range_lut(const uint8_t* occupied, int h, int w,
                                 int t_bins, int max_range_px,
                                 const int32_t* row_map, int row_stride,
                                 uint8_t* out) {
  build_compact_range_lut_impl<uint8_t>(occupied, h, w, t_bins, max_range_px,
                                        row_map, row_stride, out);
}

void mcl_build_compact_range_lut_u16(const uint8_t* occupied, int h, int w,
                                     int t_bins, int max_range_px,
                                     const int32_t* row_map, int row_stride,
                                     uint16_t* out) {
  build_compact_range_lut_impl<uint16_t>(occupied, h, w, t_bins,
                                         max_range_px, row_map, row_stride,
                                         out);
}

int mcl_native_version() { return 4; }

}  // extern "C"
