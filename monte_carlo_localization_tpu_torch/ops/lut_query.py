"""Fused range-LUT likelihood: the query of the JAX package's
``ops/pallas_lut.py`` for one map, as a hand-written CUDA kernel
(``csrc/lut_likelihood.cu``) beside its plain PyTorch version.

Beam j of a particle reads LUT entry ``b0 + k*j + e_j`` of the particle's
row, where ``b0`` is the particle's heading bin and ``(base, k, e)`` is the
static decomposition of the beam set (:func:`beam_geometry`). The numpy
geometry helpers below are the JAX module's, unchanged, so both packages
agree on the LUT's byte layout (``row_stride`` entries per row with
angle-wraparound padding) and one LUT buffer serves both.

:class:`LUTQuery` is the wrapper: on CUDA tensors it launches the kernel
(and raises on anything it does not take); on CPU tensors it runs
:func:`lut_log_weights_reference`, the gather form of the same math.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

LANE = 128
SUB = 512  # bytes of one TPU DMA subrow; fixes the LUT's row padding
LOG_TINY = 1e-35
OOB_LOG_WEIGHT = -1e4
# shared memory per block: r floats + r int32; stay in the 48 KB default
MAX_BEAMS = 48 * 1024 // 8


def entries_per_subrow(itemsize: int) -> int:
    """LUT entries per 512 B subrow: 512 for u8, 256 for u16."""
    if itemsize not in (1, 2):
        raise ValueError(f"unsupported LUT itemsize {itemsize} (u8/u16 only)")
    return SUB // itemsize


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def suggest_theta_bins(beam_angles: np.ndarray, target: int = 1440) -> int:
    """T near ``target`` such that one beam step is an integer number k of
    theta bins for this beam set (k=1, T~1439 at 1080 beams over 270
    degrees; k=18, T~1416 at 60 beams)."""
    a = np.asarray(beam_angles, np.float64)
    if len(a) < 2:
        return target
    inc = np.median(np.abs(np.diff(a)))
    k = max(1, int(round(inc * target / (2.0 * math.pi))))
    return max(8, int(round(2.0 * math.pi * k / inc)))


def beam_geometry(beam_angles: np.ndarray, t_bins: int):
    """Static decomposition bin(beam_j) = base + k*j + e_j.

    Returns (base, k, e (R,) int32 with 0 <= e <= emax).
    """
    delta = 2.0 * math.pi / t_bins
    bins = np.round(np.asarray(beam_angles, np.float64) / delta).astype(np.int64)
    r = len(bins)
    if r > 1:
        k = max(1, int(round((bins[-1] - bins[0]) / (r - 1))))
    else:
        k = 1
    e = (bins - bins[0] - k * np.arange(r, dtype=np.int64)).astype(np.int64)
    base = int(bins[0] + e.min())
    e = (e - e.min()).astype(np.int32)
    return base, k, e


def window_entries(t_bins: int, beam_angles: np.ndarray, itemsize: int = 1) -> int:
    """Per-particle window in LUT entries, rounded as the TPU kernel's DMA
    needs (it fixes ``required_row_stride``, hence the byte layout). The
    span carries one guard bin past the last beam for the sub-bin lerp."""
    base, k, e = beam_geometry(beam_angles, t_bins)
    span = k * (len(beam_angles) - 1) + int(e.max()) + 1 + 1
    if span > t_bins:
        raise ValueError(
            f"beam window spans {span} bins > T={t_bins}; use "
            "T = suggest_theta_bins(beam_angles)"
        )
    eps = entries_per_subrow(itemsize)
    return _round_up(eps - 1 + span, max(eps, 8 * LANE))


def required_row_stride(t_bins: int, beam_angles: np.ndarray, itemsize: int = 1) -> int:
    """LUT row stride (in entries) so any window [b0, b0+span), b0 < T,
    fits one physical row."""
    w = window_entries(t_bins, beam_angles, itemsize)
    eps = entries_per_subrow(itemsize)
    max_floor = eps * ((t_bins - 1) // eps)
    return _round_up(max_floor + w, eps)


def _erf_as(x: torch.Tensor) -> torch.Tensor:
    """Abramowitz & Stegun 7.1.26 erf (|err| < 1.5e-7), the TPU kernel's."""
    sign = torch.where(x < 0, -1.0, 1.0)
    ax = torch.abs(x)
    t = 1.0 / (1.0 + 0.3275911 * ax)
    poly = t * (
        0.254829592
        + t * (-0.284496736 + t * (1.421413741 + t * (-1.453152027 + t * 1.061405429)))
    )
    return sign * (1.0 - poly * torch.exp(-ax * ax))


class LUTQuery:
    """``query(lut_flat, particles, obs_px, row_map=None) -> (N,)`` log
    weights for one map and one beam set.

    ``lut_flat`` is the (rows * row_stride,) u8/u16 LUT; ``particles`` is
    (N, 3) float32; ``obs_px`` is the (R,) float32 observed range in
    pixels (``SensorModel.to_pixel_index``); ``row_map`` is the (H*W,)
    int32 compact-LUT indirection, or None for a dense LUT. Particles
    outside the map get -1e4.

    On CUDA tensors each call launches ``csrc/lut_likelihood.cu`` and adds
    one to ``launch_count``; on CPU tensors it runs the plain version.
    """

    def __init__(
        self,
        t_bins: int,
        beam_angles: np.ndarray,
        *,
        height: int,
        width: int,
        resolution: float,
        origin_x: float,
        origin_y: float,
        max_range_px: int,
        row_stride: int,
        z_hit: float,
        z_short: float,
        z_max: float,
        z_rand: float,
        sigma_hit: float,
        inv_squash: float,
        lut_dtype=np.uint8,
        device: torch.device | str = "cpu",
    ):
        beam_angles = np.asarray(beam_angles)
        r = len(beam_angles)
        if not 1 <= r <= MAX_BEAMS:
            raise ValueError(f"{r} beams; the kernel takes 1..{MAX_BEAMS}")
        base, k, e = beam_geometry(beam_angles, t_bins)
        offsets = k * np.arange(r, dtype=np.int64) + e
        # one LUT entry per beam: a non-monotone beam set would merge beams
        if len(set(offsets.tolist())) < r:
            raise ValueError(
                "beam set maps two beams to one LUT entry (non-monotone "
                "residuals); sort/uniform-space the beams or change t_bins"
            )
        self.lut_dtype = np.dtype(lut_dtype)
        itemsize = self.lut_dtype.itemsize
        need = required_row_stride(t_bins, beam_angles, itemsize)
        if row_stride < need:
            raise ValueError(f"row_stride {row_stride} < required {need}")
        if row_stride % entries_per_subrow(itemsize) != 0:
            raise ValueError(
                f"row_stride must be a multiple of {entries_per_subrow(itemsize)}"
            )
        self.device = torch.device(device)
        self.num_beams = r
        self.t_bins = int(t_bins)
        self.base = int(base)
        self.row_stride = int(row_stride)
        self.height = int(height)
        self.width = int(width)
        self.beam_offsets = torch.as_tensor(offsets, dtype=torch.int32, device=self.device)
        # Python floats, folded from double exactly as the JAX kernel folds
        # them; torch and the CUDA kernel both apply them in float32
        self.resolution = float(resolution)
        self.origin_x = float(origin_x)
        self.origin_y = float(origin_y)
        self.bin_scale = t_bins / (2.0 * math.pi)
        self.m = float(max_range_px)
        self.gauss_coef = z_hit / (sigma_hit * math.sqrt(2.0 * math.pi))
        self.inv2s2 = 1.0 / (2.0 * sigma_hit * sigma_hit)
        self.short2 = 2.0 * z_short
        self.z_short = float(z_short)
        self.z_max = float(z_max)
        self.z_rand = float(z_rand)
        self.z_hit = float(z_hit)
        self.rand_term = z_rand / self.m
        self.sq2 = math.sqrt(2.0) * sigma_hit
        self.inv_squash = float(inv_squash)
        # order of Params in csrc/lut_likelihood.cu
        self._consts = (ctypes.c_float * 15)(
            self.resolution, self.origin_x, self.origin_y, self.bin_scale,
            self.m, self.gauss_coef, self.inv2s2, self.short2, self.z_short,
            self.z_max, self.z_rand, self.z_hit, self.rand_term, self.sq2,
            self.inv_squash,
        )
        self.launch_count = 0

    def __call__(self, lut_flat, particles, obs_px, row_map=None) -> torch.Tensor:
        if particles.device.type == "cuda":
            return self.launch(lut_flat, particles, obs_px, row_map)
        if particles.device.type == "cpu":
            return lut_log_weights_reference(self, lut_flat, particles, obs_px, row_map)
        raise ValueError(f"no LUT likelihood for device {particles.device}")

    def launch(self, lut_flat, particles, obs_px, row_map=None) -> torch.Tensor:
        """Run the CUDA kernel; raises on any input it does not take."""
        from monte_carlo_localization_tpu_torch.ops._cuda_build import load_library

        dev = particles.device
        if dev.type != "cuda":
            raise ValueError(f"kernel launch needs CUDA tensors, got {dev}")
        want_dtype = torch.uint8 if self.lut_dtype.itemsize == 1 else torch.uint16
        tensors = dict(
            lut_flat=(lut_flat, want_dtype, None),
            particles=(particles, torch.float32, None),
            obs_px=(obs_px, torch.float32, (self.num_beams,)),
            beam_offsets=(self.beam_offsets, torch.int32, None),
        )
        if row_map is not None:
            tensors["row_map"] = (row_map, torch.int32, (self.height * self.width,))
        for name, (t, dtype, shape) in tensors.items():
            if t.device != dev:
                raise ValueError(f"{name} is on {t.device}, particles on {dev}")
            if t.dtype != dtype:
                raise ValueError(f"{name} dtype {t.dtype}, kernel takes {dtype}")
            if not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous")
            if shape is not None and tuple(t.shape) != shape:
                raise ValueError(f"{name} shape {tuple(t.shape)} != {shape}")
        if particles.dim() != 2 or particles.shape[1] != 3:
            raise ValueError(f"particles shape {tuple(particles.shape)} != (N, 3)")
        if lut_flat.dim() != 1 or lut_flat.numel() % self.row_stride:
            raise ValueError(
                f"lut_flat must be flat whole rows of {self.row_stride} entries"
            )
        if row_map is None and lut_flat.numel() < self.height * self.width * self.row_stride:
            raise ValueError("dense LUT has fewer rows than the map has cells")

        built = load_library()
        fn = (
            built.lib.mcl_lut_loglik_u8 if want_dtype == torch.uint8
            else built.lib.mcl_lut_loglik_u16
        )
        n = particles.shape[0]
        out = torch.empty(n, dtype=torch.float32, device=dev)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = fn(
                lut_flat.data_ptr(), self.row_stride,
                None if row_map is None else row_map.data_ptr(),
                particles.data_ptr(), n, obs_px.data_ptr(),
                self.beam_offsets.data_ptr(), self.num_beams, self.base,
                self.t_bins, self.height, self.width,
                ctypes.addressof(self._consts), out.data_ptr(), stream,
            )
        if err != 0:
            msg = built.lib.mcl_cuda_error_string(err).decode()
            raise RuntimeError(f"lut_likelihood launch failed: CUDA error {err} ({msg})")
        self.launch_count += 1
        return out


def lut_log_weights_reference(
    q: LUTQuery, lut_flat, particles, obs_px, row_map=None
) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the same float32 address math
    and beam model, as one (N, R) gather, and the beam sum accumulated in
    double. The CPU path and the kernel's reference in the tests and on
    the card."""
    x, y, theta = particles[:, 0], particles[:, 1], particles[:, 2]
    gx = ((x - q.origin_x) / q.resolution).to(torch.int32)  # truncates
    gy = ((y - q.origin_y) / q.resolution).to(torch.int32)
    oob = (gx < 0) | (gx >= q.width) | (gy < 0) | (gy >= q.height)
    cell = (
        gy.clamp(0, q.height - 1).to(torch.int64) * q.width
        + gx.clamp(0, q.width - 1).to(torch.int64)
    )
    row = cell if row_map is None else row_map[cell].to(torch.int64)
    b0 = torch.round(theta * q.bin_scale).to(torch.int32)  # half to even
    b0 = torch.fmod(b0 + q.base, q.t_bins)  # truncating, as lax.rem
    b0 = torch.where(b0 < 0, b0 + q.t_bins, b0)
    idx = (
        (row * q.row_stride + b0.to(torch.int64))[:, None]
        + q.beam_offsets.to(device=particles.device, dtype=torch.int64)[None, :]
    )
    if lut_flat.dtype == torch.uint16:
        # few uint16 ops exist; read the bits through int16
        d = (lut_flat.view(torch.int16)[idx].to(torch.int32) & 0xFFFF).to(torch.float32)
    else:
        d = lut_flat[idx].to(torch.float32)

    m = q.m
    obs = torch.clamp(obs_px.to(torch.float32), max=m)[None, :]
    d = torch.clamp(d, max=m)
    z = obs - d
    p = q.gauss_coef * torch.exp(-(z * z) * q.inv2s2)
    p = p + torch.where(obs < d, q.short2 * (d - obs) / torch.clamp(d, min=1.0), 0.0)
    p = p + torch.where(obs >= m, q.z_max, 0.0)
    p = p + torch.where(obs < m, q.rand_term, 0.0)
    gauss_sum = 0.5 * (_erf_as((m - d + 0.5) / q.sq2) - _erf_as((-d - 0.5) / q.sq2))
    norm = (
        q.z_hit * gauss_sum
        + torch.where(d > 0, q.z_short * (d + 1.0), 0.0)
        + q.z_max
        + q.z_rand
    )
    logp = torch.log(torch.clamp(p, min=LOG_TINY)) - torch.log(norm)
    # summed in double, as the kernel does, then rounded to float32
    logw = q.inv_squash * logp.sum(dim=1, dtype=torch.float64).to(torch.float32)
    return torch.where(oob, OOB_LOG_WEIGHT, logw)
