// The motion phase of a correction as one kernel, for Hopper (sm_90a):
// from the old particles, the resampler's source indices (or none), each
// row's action and the N(0, 1) noise to the proposal, one thread a
// particle and one launch for every row of a fleet.
//
// Replaces no TPU kernel. In the JAX package this is XLA's work
// (monte_carlo_localization_tpu/models/motion.py and the row gather of
// filter/core.py); the port ran it as 59 small device kernels beside the
// noise's draw (models/motion.py's PyTorch ops, the gather in
// filter/core.py correct) until an H100 profile of the benchmark's replay
// cells showed them at 54-55% of the card's time in a correction, all of
// it launch floors. It computes, for row r and slot i:
//   (x, y, th) = particles[r, idx[r, i]]      (particles[r, i] without idx)
//   (ds, dth)  = the row's action through reconstruct_velocity, or as it is
//   straight   = |omega| < 1e-6: (x + ds cos th, y + ds sin th, th)
//   else       = (x + c cos(th + dth/2), y + c sin(th + dth/2), th + dth),
//                c = ds * (2 sin(dth/2) / dth)
//   out[r, i]  = (x' + n0 dx, y' + n1 dy, wrap(th' + n2 dth_disp))
// with wrap(a) = atan2(sin a, cos a), which is models/motion.py's plain
// version op for op.
//
// Numerics: bit-equal to the plain version on a card. Each product, sum
// and quotient is one of PyTorch's kernels there, rounded once, so they
// are the _rn intrinsics here (nothing contracted into an FMA); the
// quotients are IEEE divisions (utils/geometry.py div and the
// tensor-by-tensor divisions; a division by the Python 2.0 is PyTorch's
// multiply by 0.5, the same value); sinf, cosf and atan2f are what
// PyTorch's sin, cos and atan2 call for float32 (no --use_fast_math);
// the clamp keeps a NaN as PyTorch's does; and every Python constant is
// the float32 PyTorch casts it to.
//
// What binds it on an H100: at 4000 particles it reads 12 B of particle,
// 12 B of noise and 4 B of index and writes 12 B a particle (160 KB, 0.05
// us at 3.35 TB/s) and computes ~5 sines and cosines, one atan2 and a few
// divisions a particle: the bound is the launch and one thread's latency.
// So blocks are small (kThreads), to spread a 4000-row filter over most
// SMs rather than a few, and each row's action is rebuilt by every thread
// of the row (a few divisions), where a first pass would cost a launch.

#include <cmath>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;

// Where the kernel reads: strides in elements; a row stride of 0 shares
// one tensor between rows (a single filter is one row).
struct Args {
  const float* particles;  // (rows, n_src, 3), contiguous
  const int32_t* idx;      // (rows, m) source rows, or null: slot i reads row i
  int64_t idx_row, idx_col;
  const float* action;  // (rows, 3)
  int64_t act_row, act_col;
  const float* noise;  // (rows, m, 3)
  int64_t noise_row, noise_col, noise_axis;
  int64_t n_src, m, total;  // total = rows * m
  float disp_x, disp_y, disp_th;
  int exact_dt;
  float* out;  // (rows, m, 3), contiguous
};

__global__ void __launch_bounds__(kThreads) motion_kernel(const Args a) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= a.total) return;
  const int64_t row = t / a.m;
  const int64_t i = t - row * a.m;

  // the row's displacement (models/motion.py reconstruct_velocity)
  const float* act = a.action + row * a.act_row;
  const float fwd = act[0];
  const float dth_act = act[2 * a.act_col];
  float ds, dth, omega;
  if (a.exact_dt) {
    const float afwd = fabsf(fwd);
    // div(afwd, 1.0) is afwd; div(afwd, 5.0) an IEEE division
    float dt_moving = afwd < 0.1f ? afwd : __fdiv_rn(afwd, 5.0f);
    if (!isnan(dt_moving)) dt_moving = fminf(fmaxf(dt_moving, 0.001f), 0.1f);
    const bool has_fwd = afwd > 0.001f;
    const float dt = has_fwd ? dt_moving : 0.01f;
    const float v = has_fwd ? __fdiv_rn(fwd, dt) : 0.0f;
    omega = fabsf(dth_act) > 0.001f ? __fdiv_rn(dth_act, dt) : 0.0f;
    ds = __fmul_rn(v, dt);
    dth = __fmul_rn(omega, dt);
  } else {
    ds = fwd;
    dth = dth_act;
    omega = dth_act;
  }

  int64_t src = i;
  if (a.idx != nullptr) src = a.idx[row * a.idx_row + i * a.idx_col];
  float nx, ny, nth;
  if (src < 0 || src >= a.n_src) {  // no such source row: NaN, never a stray read
    nx = ny = nth = NAN;
  } else {
    const float* p = a.particles + (row * a.n_src + src) * 3;
    const float x = p[0], y = p[1], th = p[2];
    if (fabsf(omega) < 1e-6f) {
      nx = __fadd_rn(x, __fmul_rn(ds, cosf(th)));
      ny = __fadd_rn(y, __fmul_rn(ds, sinf(th)));
      nth = th;
    } else {
      const float safe_dth = fabsf(dth) < 1e-12f ? 1.0f : dth;
      const float half = __fmul_rn(dth, 0.5f);
      const float chord =
          __fmul_rn(ds, __fdiv_rn(__fmul_rn(2.0f, sinf(half)), safe_dth));
      const float mid = __fadd_rn(th, half);
      nx = __fadd_rn(x, __fmul_rn(chord, cosf(mid)));
      ny = __fadd_rn(y, __fmul_rn(chord, sinf(mid)));
      nth = __fadd_rn(th, dth);
    }
  }
  const float* nz = a.noise + row * a.noise_row + i * a.noise_col;
  nx = __fadd_rn(nx, __fmul_rn(nz[0], a.disp_x));
  ny = __fadd_rn(ny, __fmul_rn(nz[a.noise_axis], a.disp_y));
  nth = __fadd_rn(nth, __fmul_rn(nz[2 * a.noise_axis], a.disp_th));
  nth = atan2f(sinf(nth), cosf(nth));
  float* o = a.out + t * 3;
  o[0] = nx;
  o[1] = ny;
  o[2] = nth;
}

}  // namespace

extern "C" {

// out (rows, m, 3) float32: the proposal of slots 0 .. m-1 of each row.
// particles (rows, n_src, 3) contiguous float32; idx int32 with strides
// (idx_row, idx_col), or null (then m == n_src); action (rows, 3) with
// strides (act_row, act_col); noise (rows, m, 3) with strides (noise_row,
// noise_col, noise_axis), all in elements; dispersions per axis;
// exact_dt: rebuild (dt, v, omega) from the action.
int mcl_motion(const float* particles, int64_t rows, int64_t n_src, int64_t m,
               const int32_t* idx, int64_t idx_row, int64_t idx_col, const float* action,
               int64_t act_row, int64_t act_col, const float* noise, int64_t noise_row,
               int64_t noise_col, int64_t noise_axis, float disp_x, float disp_y,
               float disp_th, int exact_dt, float* out, void* stream) {
  if (rows < 1 || n_src < 1 || m < 1 || (idx == nullptr && m != n_src)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t total = rows * m;
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{particles, idx, idx_row, idx_col, action, act_row, act_col,
               noise, noise_row, noise_col, noise_axis, n_src, m, total,
               disp_x, disp_y, disp_th, exact_dt, out};
  motion_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
