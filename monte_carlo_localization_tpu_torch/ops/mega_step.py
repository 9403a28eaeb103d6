"""The mega step: one whole MCL correction (resample, motion, LUT
likelihood, max-shift, pose moment sums) as one launch of the CUDA
kernel ``csrc/mega_step.cu``, the Hopper counterpart of the JAX
package's ``ops/pallas_mega.py`` (TPU kernel K6), beside its plain
PyTorch version :func:`mega_step_reference`.

Inputs are flat: particles (N, 3), log weights (N,), N(0, 1) motion noise
(N, 3), the (R,) observed ranges in pixels clipped to ``max_range_px``,
and ``scalars`` (8,) = [ds, dtheta, straight, u0, 0, 0, 0, 0], the motion
displacement form after the dt heuristic. Outputs: the proposal (N, 3),
its max-shifted log weights (N,) and ``sums`` (8,) = [S_wx, S_wy,
S_wsin, S_wcos, Z, max_logp, 0, 0] with ``w = exp(logp - max_logp)``.
Dense LUTs only (``row = cell``), as on the TPU.

:class:`MegaStep` is the wrapper: on CUDA tensors it launches the kernel
(and raises on anything it does not take); on CPU tensors it runs the
plain version.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from monte_carlo_localization_tpu_torch.ops.lut_query import (
    LUTQuery,
    lut_log_weights_reference,
)
from monte_carlo_localization_tpu_torch.utils.device import DEFAULT_DEVICE

NUM_SUMS = 8
# debug_phases of pallas_mega.py: everything, stop before the epilogue,
# stop after the proposal. For timing the phases on the card only.
PHASES = {"all": 0, "no_epi": 1, "pro_only": 2}


class MegaStep:
    """One correction per call, for one dense-LUT map and one beam set.

    The keyword arguments are :class:`LUTQuery`'s (the beam layout and
    the folded beam-model constants live in ``self.query``) plus the
    motion model's ``motion_dispersion`` (x, y, theta). On CUDA tensors
    each call launches ``csrc/mega_step.cu`` and adds one to
    ``launch_count``. The launcher sizes the grid by the work
    (:meth:`plan`): up to 8192 particles every block computes the weight
    CDF itself in shared memory and no grid barrier is needed; past that
    the CDF is scanned across a cooperative grid.
    """

    def __init__(
        self,
        t_bins: int,
        beam_angles: np.ndarray,
        *,
        motion_dispersion: tuple[float, float, float] = (0.05, 0.025, 0.25),
        device: torch.device | str = DEFAULT_DEVICE,
        **query_kw,
    ):
        self.query = LUTQuery(t_bins, beam_angles, device=device, **query_kw)
        self.device = self.query.device
        self.disp_x, self.disp_y, self.disp_theta = (float(v) for v in motion_dispersion)
        self.two_pi = 2.0 * math.pi
        self.inv_2pi = 1.0 / (2.0 * math.pi)
        # LUTQuery's constants, then the Motion struct of csrc/mega_step.cu
        self._consts = (ctypes.c_float * (len(self.query._consts) + 5))(
            *self.query._consts, self.disp_x, self.disp_y, self.disp_theta,
            self.two_pi, self.inv_2pi,
        )
        self._plans: dict[tuple[torch.device, int], tuple[int, int, bool]] = {}
        # zeroed workspaces by (device, bytes), never freed: a CUDA graph of
        # the step holds their addresses
        self._workspaces: dict[tuple[torch.device, int], torch.Tensor] = {}
        self.launch_count = 0

    def plan(self, n: int, device: torch.device | str | None = None) -> tuple[int, int, bool]:
        """(grid blocks, particles per block, small) the kernel launches
        with for ``n`` particles, asked of the launcher once per (device,
        n). ``small``: every block computes the weight CDF itself and the
        launch has no grid barrier; else the CDF runs across a
        cooperative grid."""
        dev = torch.device(self.device if device is None else device)
        key = (dev, int(n))
        if key not in self._plans:
            from monte_carlo_localization_tpu_torch.ops._cuda_build import load_library

            built = load_library()
            lib = built.libs["mega_step"]
            fn = lib.mcl_mega_plan_u8 if self.query.lut_dtype.itemsize == 1 else lib.mcl_mega_plan_u16
            grid, chunk, small = ctypes.c_int(0), ctypes.c_int64(0), ctypes.c_int(0)
            with torch.cuda.device(dev):
                err = fn(int(n), self.query.num_beams, self.query.table_entries,
                         ctypes.byref(grid), ctypes.byref(chunk), ctypes.byref(small))
            if err != 0:
                raise RuntimeError(f"mega_step plan failed: CUDA error {err} ({built.error_string(err)})")
            self._plans[key] = (grid.value, chunk.value, bool(small.value))
        return self._plans[key]

    def __call__(self, lut_flat, particles, log_weights, noise, obs_clipped, scalars,
                 out_particles, out_log_weights, out_sums):
        """Write one correction into the ``out_*`` tensors."""
        if particles.device.type == "cuda":
            return self.launch(lut_flat, particles, log_weights, noise, obs_clipped, scalars,
                               out_particles, out_log_weights, out_sums)
        if particles.device.type == "cpu":
            prop, lw, sums = mega_step_reference(
                self, lut_flat, particles, log_weights, noise, obs_clipped, scalars
            )
            out_particles.copy_(prop)
            out_log_weights.copy_(lw)
            out_sums.copy_(sums)
            return out_particles, out_log_weights, out_sums
        raise ValueError(f"no mega step for device {particles.device}")

    def launch(self, lut_flat, particles, log_weights, noise, obs_clipped, scalars,
               out_particles, out_log_weights, out_sums, debug_phases: str = "all"):
        """Run the CUDA kernel; raises on any input it does not take."""
        from monte_carlo_localization_tpu_torch.ops._cuda_build import load_library

        dev = particles.device
        if dev.type != "cuda":
            raise ValueError(f"kernel launch needs CUDA tensors, got {dev}")
        if debug_phases not in PHASES:
            raise ValueError(f"debug_phases {debug_phases!r} not in {sorted(PHASES)}")
        q = self.query
        n = particles.shape[0] if particles.dim() == 2 else -1
        if n < 1:
            raise ValueError(f"particles shape {tuple(particles.shape)} != (N, 3), N >= 1")
        want_dtype = torch.uint8 if q.lut_dtype.itemsize == 1 else torch.uint16
        f32 = torch.float32
        tensors = dict(
            lut_flat=(lut_flat, want_dtype, None),
            particles=(particles, f32, (n, 3)),
            log_weights=(log_weights, f32, (n,)),
            noise=(noise, f32, (n, 3)),
            obs_clipped=(obs_clipped, f32, (q.num_beams,)),
            scalars=(scalars, f32, (NUM_SUMS,)),
            out_particles=(out_particles, f32, (n, 3)),
            out_log_weights=(out_log_weights, f32, (n,)),
            out_sums=(out_sums, f32, (NUM_SUMS,)),
            beam_offsets=(q.beam_offsets, torch.int32, None),
        )
        for name, (t, dtype, shape) in tensors.items():
            if t.device != dev:
                raise ValueError(f"{name} is on {t.device}, particles on {dev}")
            if t.dtype != dtype:
                raise ValueError(f"{name} dtype {t.dtype}, kernel takes {dtype}")
            if not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous")
            if shape is not None and tuple(t.shape) != shape:
                raise ValueError(f"{name} shape {tuple(t.shape)} != {shape}")
        # ancestors are gathered while proposals are written
        if out_particles.data_ptr() == particles.data_ptr() or (
            out_log_weights.data_ptr() == log_weights.data_ptr()
        ):
            raise ValueError("out_particles / out_log_weights must not be the input buffers")
        if lut_flat.dim() != 1 or lut_flat.numel() < q.height * q.width * q.row_stride:
            raise ValueError("lut_flat must be the flat dense LUT, one row per map cell")

        built = load_library()
        lib = built.libs["mega_step"]
        fn = lib.mcl_mega_step_u8 if want_dtype == torch.uint8 else lib.mcl_mega_step_u16
        grid, chunk, small = self.plan(n, dev)
        ws_bytes = lib.mcl_mega_workspace_bytes(n, grid)
        ws = self._workspaces.get((dev, ws_bytes))
        if ws is None:
            # zeroed: the kernel's ticket counts from 0 and resets itself
            ws = self._workspaces[(dev, ws_bytes)] = torch.zeros(
                ws_bytes, dtype=torch.uint8, device=dev)
        table = q.norm_table(dev)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = fn(
                lut_flat.data_ptr(), q.row_stride, particles.data_ptr(),
                log_weights.data_ptr(), noise.data_ptr(), n, obs_clipped.data_ptr(),
                q.beam_offsets.data_ptr(), q.num_beams, q.base, q.t_bins, q.height,
                q.width, ctypes.addressof(self._consts),
                None if table is None else table.data_ptr(), q.table_entries,
                scalars.data_ptr(), out_particles.data_ptr(), out_log_weights.data_ptr(),
                out_sums.data_ptr(), ws.data_ptr(), grid, chunk, int(small),
                PHASES[debug_phases], stream,
            )
        if err != 0:
            raise RuntimeError(f"mega_step launch failed: CUDA error {err} ({built.error_string(err)})")
        self.launch_count += 1
        return out_particles, out_log_weights, out_sums


def scaled_cdf(log_weights: torch.Tensor, u0: torch.Tensor) -> torch.Tensor:
    """``g = n * (cs / z) - u0`` in float32, where ``cs`` is the inclusive
    prefix of ``w = exp(lw - max lw)`` and ``z`` its total, both summed in
    double and rounded once (the kernel's phase 1)."""
    n = log_weights.shape[0]
    w = torch.exp(log_weights - torch.max(log_weights))
    cs = torch.cumsum(w, dim=0, dtype=torch.float64)
    return float(n) * (cs.to(torch.float32) / cs[-1].to(torch.float32)) - u0


def systematic_ancestors(g: torch.Tensor, u0: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(ancestor (N,) int64, valid (N,) bool) for the output slots
    ``i = 0..N-1``: the j with ``g[j-1] < i <= g[j]`` (``g[-1] = -u0``).
    A slot no j covers is not valid: the TPU's one-hot gather leaves its
    row (0, 0, 0)."""
    n = g.shape[0]
    slots = torch.arange(n, dtype=torch.float32, device=g.device)
    idx = torch.searchsorted(g, slots, side="left")
    valid = (idx < n) & ((idx > 0) | (-u0 < slots))
    return idx.clamp(max=n - 1), valid


def mega_motion(step: MegaStep, particles, noise, ds, dth, straight) -> torch.Tensor:
    """The displacement-form motion of pallas_mega.py:274-297 with the
    floor-based wrap to [-pi, pi), in the kernel's order of float32 ops."""
    x, y, th = particles[:, 0], particles[:, 1], particles[:, 2]
    safe_dth = torch.where(torch.abs(dth) < 1e-12, 1.0, dth)
    chord = ds * (2.0 * torch.sin(dth * 0.5) / safe_dth)
    mid = th + dth * 0.5
    st = straight > 0.5
    nx = torch.where(st, x + ds * torch.cos(th), x + chord * torch.cos(mid))
    ny = torch.where(st, y + ds * torch.sin(th), y + chord * torch.sin(mid))
    nth = torch.where(st, th, th + dth)
    nx = nx + noise[:, 0] * step.disp_x
    ny = ny + noise[:, 1] * step.disp_y
    nth = nth + noise[:, 2] * step.disp_theta
    nth = nth - step.two_pi * torch.floor(nth * step.inv_2pi + 0.5)
    return torch.stack([nx, ny, nth], dim=1)


def mega_step_reference(step: MegaStep, lut_flat, particles, log_weights, noise,
                        obs_clipped, scalars):
    """Plain PyTorch version of the kernel: the same three phases.
    Returns (proposal (N, 3), max-shifted log weights (N,), sums (8,))."""
    ds, dth, straight, u0 = scalars[0], scalars[1], scalars[2], scalars[3]
    g = scaled_cdf(log_weights, u0)
    idx, valid = systematic_ancestors(g, u0)
    prop = torch.where(valid[:, None], particles[idx], 0.0)
    prop = mega_motion(step, prop, noise, ds, dth, straight)
    # dense LUT: the kernel's address (:305-317) picks K1's rows and bins,
    # theta being wrapped already
    lp = lut_log_weights_reference(step.query, lut_flat, prop, obs_clipped)
    mx = torch.max(lp)
    ww = torch.exp(lp - mx).to(torch.float64)
    moments = torch.stack([
        torch.sum(ww * prop[:, 0].to(torch.float64)),
        torch.sum(ww * prop[:, 1].to(torch.float64)),
        torch.sum(ww * torch.sin(prop[:, 2]).to(torch.float64)),
        torch.sum(ww * torch.cos(prop[:, 2]).to(torch.float64)),
        torch.sum(ww),
    ]).to(torch.float32)
    zero = torch.zeros(2, dtype=torch.float32, device=lp.device)
    return prop, lp - mx, torch.cat([moments, mx[None], zero])
