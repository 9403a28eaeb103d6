"""Fused range-LUT likelihood: the query of the JAX package's
``ops/pallas_lut.py``, for one map or for a fleet, as hand-written CUDA
kernels beside their plain PyTorch versions.

Beam j of a particle reads LUT entry ``b0 + k*j + e_j`` of the particle's
row, where ``b0`` is the particle's heading bin and ``(base, k, e)`` is the
static decomposition of the beam set (:func:`beam_geometry`). The numpy
geometry helpers below are the JAX module's, unchanged, so both packages
agree on the LUT's byte layout (``row_stride`` entries per row with
angle-wraparound padding) and one LUT buffer serves both.

:class:`LUTQuery` is the wrapper. On CUDA tensors it launches
``csrc/lut_likelihood.cu`` (TPU kernels K1/K2, and K3 with ``subbin``)
or, with ``dedup_slots``, ``csrc/lut_dedup.cu`` (K4/K5: a key kernel, a
sort and the unique-window kernel), and raises on anything they do not
take. On CPU tensors it runs the plain versions:
:func:`lut_log_weights_reference`, the gather form of the same math, and
:func:`lut_dedup_reference`, which reads every window through the slot
table that :func:`dedup_plan` builds.

The kernels read the beam model's normaliser, which depends on the
expected range alone, from a table that one tiny kernel fills once per
query: ``ceil(m) + 1`` entries of integer ranges
(:meth:`LUTQuery.norm_table`; plain version :func:`log_norm_table`) or,
for the sub-bin lerp's fractional ranges, a cubic segment per 1/2 px
(:meth:`LUTQuery.subbin_table`; plain version :func:`subbin_norm_table`).
A range past the tables' cap keeps the analytic normaliser.

The fleet form (``num_members`` F, ``per_member_maps``) serves F filters
of N/F particles each in one launch: each member reads its own scan row
and, over a batched map, its own map's origin, shape, row-map block and
LUT block (``pallas_lut.py`` query :855-912).

``lut_loglik_kernel`` comes in two forms (``beam_model.cuh``
``group_lanes``): 16 lanes a particle for a scan of at most 64 beams
that reads a normaliser table, else a warp a particle
(:attr:`LUTQuery.group_lanes`). Each form's launches over the process,
graph replays included, are the counts named :attr:`LUTQuery.form`,
``lut_loglik.small_group`` and ``lut_loglik.warp``, in ``TRACER``'s
summary.
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass

import numpy as np
import torch

from monte_carlo_localization_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device
from monte_carlo_localization_tpu_torch.utils.geometry import div
from monte_carlo_localization_tpu_torch.utils.timing import COUNTS, Count

LANE = 128
SUB = 512  # bytes of one TPU DMA subrow; fixes the LUT's row padding
LOG_TINY = 1e-35
OOB_LOG_WEIGHT = -1e4
# shared memory per block: r floats + r int32; stay in the 48 KB default
MAX_BEAMS = 48 * 1024 // 8
STAGE_ALIGN = 16  # bytes; lut_dedup.cu stages windows by 1-D TMA: 16 B sizes and addresses
# the normaliser table's cap (kMaxTableEntries of csrc/beam_model.cuh):
# a query with ceil(max_range_px) + 1 entries past it stays analytic
MAX_TABLE_ENTRIES = 1024
# the sub-bin table (kSubbinSteps, kMaxSubbinEntries): SUBBIN_STEPS nodes
# per pixel for an integer max_range_px of 1..1023, else analytic
SUBBIN_STEPS = 2
MAX_SUBBIN_ENTRIES = SUBBIN_STEPS * (MAX_TABLE_ENTRIES - 1) + 1
RSQRT_PI = 0.56418958354775628695  # 1 / sqrt(pi): beam_model.cuh kRsqrtPi
INT32_MAX = 2**31 - 1
# lanes a particle in lut_loglik_kernel (beam_model.cuh kWarp, kSmallGroup,
# kSmallBeams): a small group for a tabled scan of <= SMALL_BEAMS beams
WARP = 32
SMALL_GROUP = 16
SMALL_BEAMS = 64


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
    weights for one map and one beam set, or with the fleet arguments for
    a fleet (:meth:`__call__`).

    ``lut_flat`` is the (rows * row_stride,) u8/u16 LUT; ``particles`` is
    (N, 3) float32; ``obs_px`` is the (R,) float32 observed range in
    pixels (``SensorModel.to_pixel_index``); ``row_map`` is the (H*W,)
    int32 compact-LUT indirection, or None for a dense LUT. Particles
    outside the map get -1e4.

    Options, as ``build_lut_query_fn``'s: ``subbin`` starts each window
    at the floor bin and lerps every beam toward its +1 bin by the
    heading's fractional bin (K3). ``dedup_slots`` = S > 0 sorts the
    particles by window and reads each block of ``block`` particles'
    first min(S, block) distinct windows once (K4); the result equals the
    standard query's bit for bit. ``dedup_matmul`` (K5's option) needs S
    in 1..128 and runs the same kernel. ``info`` mirrors the JAX query's.

    ``num_members`` = F > 1 makes it a fleet query: the particles are F
    contiguous groups of N/F and ``obs_px`` is (F, R), one scan per
    member. ``per_member_maps`` adds a batched map: each call then takes
    the per-map origins, and optionally shapes, LUT block bases and
    row-map bases (as the JAX query). Dedup needs a single member.

    On CUDA tensors each call launches ``csrc/lut_likelihood.cu`` (adding
    one to ``launch_count``, or to ``fleet_launch_count`` for a fleet
    query; one kernel serves both; and one to the count of its
    :attr:`form`) or, with dedup,
    ``csrc/lut_dedup.cu`` (``dedup_launch_count``; ``last_overflow``
    holds the device count of blocks with more than S windows). On CPU
    tensors it runs the plain versions. The counts are ``utils/timing.py``
    :class:`Count` objects, so a graph's replays add theirs; a caller may
    reset one by setting it.

    Without ``subbin`` the kernels read the normaliser from
    :meth:`norm_table` (``table_entries`` = ceil(max_range_px) + 1 rows,
    0 where the query stays analytic); filling it on a card launches
    ``log_norm_kernel`` once per device and adds one to
    ``table_launch_count``. With ``subbin`` they read it from
    :meth:`subbin_table` (``subbin_table_entries`` rows, 0 where the query
    stays analytic: ``max_range_px`` not an integer, or past 1023), filled
    by ``subbin_norm_kernel`` (``subbin_table_launch_count``). The dedup
    plan's key kernel counts its launches in ``key_launch_count``.
    """

    launch_count = Count.attr("_launches")
    fleet_launch_count = Count.attr("_fleet_launches")
    dedup_launch_count = Count.attr("_dedup_launches")
    table_launch_count = Count.attr("_table_launches")
    subbin_table_launch_count = Count.attr("_subbin_table_launches")
    key_launch_count = Count.attr("_key_launches")

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
        subbin: bool = False,
        dedup_slots: int = 0,
        dedup_matmul: bool = False,
        block: int = 16,
        num_members: int = 1,
        per_member_maps: bool = False,
        device: torch.device | str = DEFAULT_DEVICE,
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
        if block < 1:
            raise ValueError(f"block {block} < 1")
        if num_members < 1:
            raise ValueError(f"num_members {num_members} < 1")
        # the JAX query's rules (pallas_lut.py:511-521)
        if int(dedup_slots) > 0 and (num_members > 1 or per_member_maps):
            raise ValueError(
                "dedup_slots needs a single member (sorting particles by "
                "window would mix fleet members' scans)"
            )
        n_slots = min(int(dedup_slots), int(block))
        if dedup_matmul and n_slots <= 0:
            raise ValueError("dedup_matmul requires dedup_slots > 0")
        if dedup_matmul and n_slots > LANE:
            raise ValueError(f"dedup_matmul supports at most {LANE} slots")
        self.device = resolve_device(device)
        self.num_beams = r
        self.t_bins = int(t_bins)
        self.base = int(base)
        self.row_stride = int(row_stride)
        self.height = int(height)
        self.width = int(width)
        self.subbin = bool(subbin)
        self.dedup_slots = max(n_slots, 0)
        self.dedup_matmul = bool(dedup_matmul)
        self.block = int(block)
        self.num_members = int(num_members)
        self.per_member_maps = bool(per_member_maps)
        self.fleet = self.num_members > 1 or self.per_member_maps
        self.eps = entries_per_subrow(itemsize)
        self.window_entries = window_entries(t_bins, beam_angles, itemsize)
        # entries the dedup kernel stages per slot: all a window can reach
        # from its subrow (the lerp's guard bin included), in 16 B
        span = k * (r - 1) + int(e.max()) + 2
        self.slot_entries = _round_up(self.eps - 1 + span, STAGE_ALIGN // itemsize)
        self.info = dict(
            n_e=len(set(int(v) for v in e)),
            window_bytes=self.window_entries * itemsize,
            window_entries=self.window_entries,
            row_stride=self.row_stride, t_bins=self.t_bins,
            lut_dtype=str(self.lut_dtype), dedup_slots=n_slots,
            subbin=self.subbin, dedup_matmul=self.dedup_matmul,
        )
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
        # order of Params in csrc/beam_model.cuh
        self._consts = (ctypes.c_float * 15)(
            self.resolution, self.origin_x, self.origin_y, self.bin_scale,
            self.m, self.gauss_coef, self.inv2s2, self.short2, self.z_short,
            self.z_max, self.z_rand, self.z_hit, self.rand_term, self.sq2,
            self.inv_squash,
        )
        entries = math.ceil(self.m) + 1
        self.table_entries = 0 if self.subbin or entries > MAX_TABLE_ENTRIES else entries
        self.subbin_table_entries = subbin_table_entries(self.m) if self.subbin else 0
        self._norm_tables: dict[torch.device, torch.Tensor] = {}
        self._subbin_tables: dict[torch.device, torch.Tensor] = {}
        # FleetTables of the one map by (device, N), never freed: a CUDA
        # graph of the step holds their addresses
        self._shared_tables: dict[tuple[torch.device, int], FleetTables] = {}
        self._launches, self._fleet_launches, self._dedup_launches = Count(), Count(), Count()
        self._table_launches, self._subbin_table_launches = Count(), Count()
        self._key_launches = Count()
        self.last_overflow: torch.Tensor | None = None
        self.launched_slots = 0  # S of the last dedup launch, after the card's clamp

    def __call__(self, lut_flat, particles, obs_px, row_map=None, **fleet) -> torch.Tensor:
        """Log weights (N,). A fleet query also takes the keywords of
        :meth:`fleet_tables`: ``member_base``, ``origins``, ``map_of``,
        ``dims``, ``lut_bases``, ``row_map_bases``."""
        if self.fleet:
            tables = self.fleet_tables(particles, obs_px, row_map, **fleet)
            if particles.device.type == "cuda":
                return self.launch(lut_flat, particles, obs_px, row_map, tables)
            if particles.device.type == "cpu":
                return lut_log_weights_reference(self, lut_flat, particles, obs_px, row_map, tables)
            raise ValueError(f"no LUT likelihood for device {particles.device}")
        if fleet:
            raise ValueError(f"fleet arguments {sorted(fleet)} to a single-map query")
        if particles.device.type == "cuda":
            if self.dedup_slots > 0:
                return self.launch_dedup(lut_flat, particles, obs_px, row_map)
            return self.launch(lut_flat, particles, obs_px, row_map)
        if particles.device.type == "cpu":
            if self.dedup_slots > 0:
                logw, self.last_overflow = lut_dedup_reference(
                    self, lut_flat, particles, obs_px, row_map
                )
                return logw
            return lut_log_weights_reference(self, lut_flat, particles, obs_px, row_map)
        raise ValueError(f"no LUT likelihood for device {particles.device}")

    def _check_inputs(self, lut_flat, particles, obs_px, row_map, tables=None) -> torch.dtype:
        """Raise on any input the kernels do not take; returns the LUT's
        torch dtype. A fleet call's ``obs_px`` is (F, R) and its
        ``tables`` are checked too."""
        dev = particles.device
        if dev.type != "cuda":
            raise ValueError(f"kernel launch needs CUDA tensors, got {dev}")
        want_dtype = torch.uint8 if self.lut_dtype.itemsize == 1 else torch.uint16
        obs_shape = (self.num_members, self.num_beams) if self.fleet else (self.num_beams,)
        tensors = dict(
            lut_flat=(lut_flat, want_dtype, None),
            particles=(particles, torch.float32, None),
            obs_px=(obs_px, torch.float32, obs_shape),
            beam_offsets=(self.beam_offsets, torch.int32, None),
            row_map=(row_map, torch.int32, None if self.fleet else (self.height * self.width,)),
        )
        if tables is not None:
            tensors.update(
                origin_x=(tables.origin_x, torch.float32, None),
                origin_y=(tables.origin_y, torch.float32, None),
                dims=(tables.dims, torch.int32, None),
                lut_bases=(tables.lut_bases, torch.int32, None),
                row_map_bases=(tables.row_map_bases, torch.int32, None),
                map_of=(tables.map_of, torch.int32, None),
            )
        for name, (t, dtype, shape) in tensors.items():
            if t is None:
                continue
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
        if (not self.fleet and row_map is None
                and lut_flat.numel() < self.height * self.width * self.row_stride):
            raise ValueError("dense LUT has fewer rows than the map has cells")
        return want_dtype

    def launch_log_norm(self, d: torch.Tensor | None = None,
                        device: torch.device | str | None = None) -> torch.Tensor:
        """Run ``log_norm_kernel`` (``csrc/lut_likelihood.cu``): the
        (count, 2) float32 rows {log norm(d), 1 / max(d, 1)} of the beam
        model's normaliser at ``d`` (float32 on a card, clipped to
        [0, ``max_range_px``]), or without ``d`` the query's table, row e at
        d = min(e, max_range_px)."""
        from monte_carlo_localization_tpu_torch.ops._cuda_build import launch

        if d is None:
            dev = resolve_device(self.device if device is None else device)
            count = self.table_entries
            if count < 1:
                raise ValueError("this query has no normaliser table (subbin, or max_range_px past the cap)")
        else:
            dev, count = d.device, d.numel()
            if d.dtype != torch.float32 or d.dim() != 1 or not d.is_contiguous():
                raise ValueError("d must be a contiguous 1-D float32 tensor")
        if dev.type != "cuda":
            raise ValueError(f"kernel launch needs a CUDA device, got {dev}")
        out = torch.empty((count, 2), dtype=torch.float32, device=dev)
        launch("lut_likelihood", "mcl_log_norm", dev, None if d is None else d.data_ptr(), count,
               ctypes.addressof(self._consts), out.data_ptr(), name="log_norm.kernel",
               count=self._table_launches)
        return out

    def norm_table(self, device: torch.device | str) -> torch.Tensor | None:
        """The normaliser table the kernels read, (``table_entries``, 2)
        float32 on ``device``, filled once per device: by
        ``log_norm_kernel`` on a card, by :func:`log_norm_table` on the
        CPU. None where the query stays analytic."""
        if self.table_entries < 1:
            return None
        dev = torch.device(device)
        table = self._norm_tables.get(dev)
        if table is None:
            if dev.type == "cuda":
                table = self.launch_log_norm(device=dev)
            else:
                table = log_norm_table(self, dev)
            self._norm_tables[dev] = table
        return table

    def launch_subbin_norm(self, device: torch.device | str | None = None) -> torch.Tensor:
        """Run ``subbin_norm_kernel`` (``csrc/lut_likelihood.cu``): the
        query's sub-bin table, (``subbin_table_entries``, 4) float32 on a
        card (:func:`subbin_norm_table` is its plain version)."""
        from monte_carlo_localization_tpu_torch.ops._cuda_build import launch

        dev = resolve_device(self.device if device is None else device)
        count = self.subbin_table_entries
        if count < 1:
            raise ValueError("this query has no sub-bin table (no subbin, or max_range_px "
                             "not an integer of 1..1023)")
        if dev.type != "cuda":
            raise ValueError(f"kernel launch needs a CUDA device, got {dev}")
        out = torch.empty((count, 4), dtype=torch.float32, device=dev)
        launch("lut_likelihood", "mcl_subbin_norm", dev, count, ctypes.addressof(self._consts),
               out.data_ptr(), name="subbin_norm.kernel", count=self._subbin_table_launches)
        return out

    def subbin_table(self, device: torch.device | str) -> torch.Tensor | None:
        """The sub-bin table K3 reads, (``subbin_table_entries``, 4)
        float32 on ``device``, filled once per device: by
        ``subbin_norm_kernel`` on a card, by :func:`subbin_norm_table` on
        the CPU. None where the query stays analytic."""
        if self.subbin_table_entries < 1:
            return None
        dev = torch.device(device)
        table = self._subbin_tables.get(dev)
        if table is None:
            if dev.type == "cuda":
                table = self.launch_subbin_norm(dev)
            else:
                table = subbin_norm_table(self, dev)
            self._subbin_tables[dev] = table
        return table

    @property
    def group_lanes(self) -> int:
        """Lanes a particle in this query's ``lut_loglik_kernel`` launch:
        :data:`SMALL_GROUP` where it reads a table (the normaliser's, or
        with ``subbin`` the sub-bin one) over at most :data:`SMALL_BEAMS`
        beams, else :data:`WARP`."""
        entries = self.subbin_table_entries if self.subbin else self.table_entries
        return SMALL_GROUP if self.num_beams <= SMALL_BEAMS and entries > 0 else WARP

    @property
    def form(self) -> str:
        """The count of this query's ``lut_loglik_kernel`` launches by form:
        ``lut_loglik.small_group`` or ``lut_loglik.warp``
        (:attr:`group_lanes`)."""
        return "lut_loglik.small_group" if self.group_lanes == SMALL_GROUP else "lut_loglik.warp"

    def kernel_table(self, device) -> tuple[torch.Tensor | None, int]:
        """(table, rows) the kernels take: the sub-bin table with
        ``subbin``, else the normaliser table; (None, 0) where analytic."""
        if self.subbin:
            return self.subbin_table(device), self.subbin_table_entries
        return self.norm_table(device), self.table_entries

    def launch(self, lut_flat, particles, obs_px, row_map=None,
               tables: FleetTables | None = None) -> torch.Tensor:
        """Run ``csrc/lut_likelihood.cu`` (K1/K2, K3 with ``subbin``) over
        every particle in one launch; raises on any input it does not
        take. A fleet query passes its :meth:`fleet_tables`; one map is
        the fleet of one member on map 0."""
        from monte_carlo_localization_tpu_torch.ops._cuda_build import launch

        if self.fleet and tables is None:
            raise ValueError("a fleet launch needs its tables (LUTQuery.fleet_tables)")
        want_dtype = self._check_inputs(lut_flat, particles, obs_px, row_map, tables)
        dev = particles.device
        if tables is None:
            tables = self._one_map_tables(dev, particles.shape[0])
        entry = "mcl_lut_loglik_u8" if want_dtype == torch.uint8 else "mcl_lut_loglik_u16"
        out = torch.empty(particles.shape[0], dtype=torch.float32, device=dev)
        table, entries = self.kernel_table(dev)

        def ptr(t):
            return None if t is None else t.data_ptr()

        launch(
            "lut_likelihood", entry, dev,
            lut_flat.data_ptr(), self.row_stride, ptr(row_map), ptr(tables.row_map_bases),
            particles.data_ptr(), self.num_members, tables.npm, tables.member_base,
            ptr(tables.map_of), int(self.per_member_maps), tables.origin_x.data_ptr(),
            tables.origin_y.data_ptr(), tables.dims.data_ptr(),
            tables.lut_bases.data_ptr(), self.eps, obs_px.data_ptr(),
            self.beam_offsets.data_ptr(), self.num_beams, self.base, self.t_bins,
            int(self.subbin), ctypes.addressof(self._consts), ptr(table),
            entries, out.data_ptr(),
            name=self.form, count=self._fleet_launches if self.fleet else self._launches,
        )
        return out

    def _check_key_range(self, lut_flat) -> None:
        """Window keys are 32-bit: a LUT of more than 2^31 - 1 subrows of
        ``eps`` entries (over 1 TB) would need more, and no card holds
        one."""
        if lut_flat.numel() // self.eps > INT32_MAX:
            raise ValueError(
                f"a LUT of {lut_flat.numel() // self.eps} subrows has window keys past int32"
            )

    def launch_window_keys(self, lut_flat, particles, row_map=None):
        """Run ``window_key_kernel`` (``csrc/lut_dedup.cu``), the dedup
        plan's address math: (keys (N,) int32, starts (N,) int64 (-1 off
        the map), fracs (N,) float32 with ``subbin`` else None, overflow
        (1,) int32 zeroed). :func:`window_keys` is its plain version."""
        from monte_carlo_localization_tpu_torch.ops._cuda_build import launch

        self._check_key_range(lut_flat)
        self._check_inputs(lut_flat, particles, None, row_map)
        dev, n = particles.device, particles.shape[0]
        keys = torch.empty(n, dtype=torch.int32, device=dev)
        starts = torch.empty(n, dtype=torch.int64, device=dev)
        fracs = torch.empty(n, dtype=torch.float32, device=dev) if self.subbin else None
        overflow = torch.empty(1, dtype=torch.int32, device=dev)
        launch(
            "lut_dedup", "mcl_window_keys", dev,
            particles.data_ptr(), n, None if row_map is None else row_map.data_ptr(),
            self.row_stride, self.eps, self.base, self.t_bins, self.height, self.width,
            int(self.subbin), ctypes.addressof(self._consts), keys.data_ptr(),
            starts.data_ptr(), None if fracs is None else fracs.data_ptr(),
            overflow.data_ptr(), name="window_key.kernel", count=self._key_launches,
        )
        return keys, starts, fracs, overflow

    def plan_dedup(self, lut_flat, particles, row_map=None):
        """The unique-window kernel's plan on a card: the window keys, then
        a stable library sort of them. Returns (sorted keys, perm, starts,
        fracs, overflow)."""
        keys, starts, fracs, overflow = self.launch_window_keys(lut_flat, particles, row_map)
        keys, perm = torch.sort(keys, stable=True)
        return keys, perm, starts, fracs, overflow

    def launch_dedup(self, lut_flat, particles, obs_px, row_map=None) -> torch.Tensor:
        """Run ``csrc/lut_dedup.cu`` (K4/K5) after :meth:`plan_dedup`;
        raises on any input it does not take. S is clamped to what fits
        the card's shared memory (``launched_slots``)."""
        from monte_carlo_localization_tpu_torch.ops._cuda_build import launch, load_library

        if self.dedup_slots <= 0:
            raise ValueError("launch_dedup needs dedup_slots > 0")
        self._check_key_range(lut_flat)
        want_dtype = self._check_inputs(lut_flat, particles, obs_px, row_map)
        if lut_flat.data_ptr() % STAGE_ALIGN:
            raise ValueError(f"lut_flat must start on a {STAGE_ALIGN} B boundary")
        dev = particles.device
        itemsize = self.lut_dtype.itemsize
        table, entries = self.kernel_table(dev)
        with torch.cuda.device(dev):
            fit = load_library().libs["lut_dedup"].mcl_lut_dedup_max_slots(
                self.num_beams, self.slot_entries, itemsize, entries, int(self.subbin))
        slots = min(self.dedup_slots, fit)
        if slots < 1:
            raise RuntimeError(
                f"no dedup slot of {self.slot_entries * itemsize} B fits the card's shared memory"
            )
        keys, perm, starts, fracs, overflow = self.plan_dedup(lut_flat, particles, row_map)
        n = particles.shape[0]
        out = torch.empty(n, dtype=torch.float32, device=dev)
        launch(
            "lut_dedup", "mcl_lut_dedup_u8" if want_dtype == torch.uint8 else "mcl_lut_dedup_u16",
            dev, lut_flat.data_ptr(), starts.data_ptr(),
            None if fracs is None else fracs.data_ptr(), keys.data_ptr(), perm.data_ptr(),
            n, self.block, slots, self.slot_entries, self.eps, obs_px.data_ptr(),
            self.beam_offsets.data_ptr(), self.num_beams, int(self.subbin),
            ctypes.addressof(self._consts), None if table is None else table.data_ptr(),
            entries, out.data_ptr(), overflow.data_ptr(),
            name="lut_dedup.kernel", count=self._dedup_launches,
        )
        # each replay of a graph of this call writes these flags again
        COUNTS.keep(self, "last_overflow", overflow)
        self.launched_slots = slots
        return out

    def fleet_tables(
        self, particles, obs_px, row_map=None, member_base: int = 0, origins=None,
        map_of=None, dims=None, lut_bases=None, row_map_bases=None,
    ) -> FleetTables:
        """The per-map tables of one fleet call, on the particles' device,
        with the JAX query's rules (``pallas_lut.py`` query :855-912):

        - ``member_base``: the global index of this call's first member;
        - ``origins`` = (x (M,), y (M,)) float32 per-map origins, needed
          with ``per_member_maps``;
        - ``map_of`` (F_total,) int32 member -> map (default: identity);
        - ``dims`` (M, 2) int32 true (height, width) and ``lut_bases``
          (M,) LUT block starts in 512 B subrows select the tight layout;
          without them every map has the common (height, width) and its
          block starts at ``map * height * width * row_stride / eps``;
        - ``row_map_bases`` (M,) int32: each map's cells in the
          concatenated compact row map, needed with a ``row_map``.

        Without ``per_member_maps`` every member reads the query's one map
        and these arguments are ignored, as in JAX. ``obs_px`` row m is
        the scan of the call's member m."""
        dev = particles.device
        f = self.num_members
        n = particles.shape[0]
        if n % f != 0:
            raise ValueError(f"{n} particles do not split into {f} members")
        if tuple(obs_px.shape) != (f, self.num_beams):
            raise ValueError(f"obs_px shape {tuple(obs_px.shape)} != ({f}, {self.num_beams})")

        def i32(x):
            return torch.as_tensor(x, dtype=torch.int32, device=dev).contiguous()

        if not self.per_member_maps:
            return self._one_map_tables(dev, n)
        if origins is None:
            raise ValueError("per_member_maps query needs origins=(ox (M,), oy (M,))")
        ox = torch.as_tensor(origins[0], dtype=torch.float32, device=dev).contiguous()
        oy = torch.as_tensor(origins[1], dtype=torch.float32, device=dev).contiguous()
        m = ox.shape[0]
        if row_map is not None and (row_map_bases is None or lut_bases is None):
            raise ValueError(
                "compact per-member LUTs need row_map_bases and lut_bases "
                "(GridMap.with_member_compact_luts)"
            )
        if dims is None:
            dims = [[self.height, self.width]] * m
        if lut_bases is None:
            member_subrows = self.height * self.width * (self.row_stride // self.eps)
            if (m - 1) * member_subrows > np.iinfo(np.int32).max:
                raise ValueError("padded per-member LUT bases overflow int32")
            lut_bases = np.arange(m, dtype=np.int64) * member_subrows
        tables = FleetTables(
            npm=n // f, member_base=int(member_base),
            map_of=None if map_of is None else i32(map_of),
            origin_x=ox, origin_y=oy, dims=i32(dims), lut_bases=i32(lut_bases),
            row_map_bases=None if row_map_bases is None else i32(row_map_bases),
        )
        for name, t, shape in (
            ("origins[1]", tables.origin_y, (m,)), ("dims", tables.dims, (m, 2)),
            ("lut_bases", tables.lut_bases, (m,)),
            ("row_map_bases", tables.row_map_bases, (m,)),
        ):
            if t is not None and tuple(t.shape) != shape:
                raise ValueError(f"{name} shape {tuple(t.shape)} != {shape}")
        need = tables.member_base + f
        if tables.map_of is not None:
            if tables.map_of.dim() != 1 or tables.map_of.shape[0] < need:
                raise ValueError(f"map_of must be 1-D with at least {need} members")
        elif m < need:
            raise ValueError(f"{m} maps for members up to {need} and no map_of")
        return tables

    def _one_map_tables(self, dev, n: int) -> FleetTables:
        """The query's one map as map 0 of a fleet of ``num_members``, with
        its origin as float32 (the value the single-map math applies),
        built once per (device, N)."""
        if (dev, n) not in self._shared_tables:
            self._shared_tables[(dev, n)] = FleetTables(
                npm=n // self.num_members, member_base=0, map_of=None,
                origin_x=torch.tensor([self.origin_x], dtype=torch.float32, device=dev),
                origin_y=torch.tensor([self.origin_y], dtype=torch.float32, device=dev),
                dims=torch.tensor([[self.height, self.width]], dtype=torch.int32, device=dev),
                lut_bases=torch.zeros(1, dtype=torch.int32, device=dev),
                row_map_bases=None,
            )
        return self._shared_tables[(dev, n)]


@dataclass(frozen=True)
class FleetTables:
    """The resolved per-map tables of one fleet query call
    (:meth:`LUTQuery.fleet_tables`), all on the particles' device. A query
    without ``per_member_maps`` holds its one map as map 0."""

    npm: int  # particles per member
    member_base: int
    map_of: torch.Tensor | None  # (F_total,) int32, or None: map = member
    origin_x: torch.Tensor  # (M,) float32
    origin_y: torch.Tensor
    dims: torch.Tensor  # (M, 2) int32 (height, width)
    lut_bases: torch.Tensor  # (M,) int32, in subrows of eps entries
    row_map_bases: torch.Tensor | None  # (M,) int32


def _heading_bin(q: LUTQuery, theta):
    """(b0 (N,) int32 in [0, T), frac (N,) float32 or None): the window's
    first bin, rounded half to even, or with ``subbin`` the floor bin and
    its fraction (``pallas_lut.py`` query :889-900)."""
    bpos = theta * q.bin_scale
    if q.subbin:
        bfloor = torch.floor(bpos)
        frac = bpos - bfloor
        b0 = bfloor.to(torch.int32)
    else:
        frac = None
        b0 = torch.round(bpos).to(torch.int32)  # half to even
    b0 = torch.fmod(b0 + q.base, q.t_bins)  # truncating, as lax.rem
    b0 = torch.where(b0 < 0, b0 + q.t_bins, b0)
    return b0, frac


def fleet_window_start(q: LUTQuery, particles, tables: FleetTables, row_map=None):
    """The fleet kernel's address math (``pallas_lut.py`` query :855-912):
    (start (N,) int64 flat LUT index of each window, frac, oob (N,) bool,
    member (N,) int64 the call-local member, whose scan row it reads)."""
    n = particles.shape[0]
    dev = particles.device
    member = torch.arange(n, device=dev) // tables.npm
    if not q.per_member_maps:
        maps = torch.zeros_like(member)
    elif tables.map_of is not None:
        maps = tables.map_of[tables.member_base + member].to(torch.int64)
    else:
        maps = tables.member_base + member
    gx = div(particles[:, 0] - tables.origin_x[maps], q.resolution).to(torch.int32)
    gy = div(particles[:, 1] - tables.origin_y[maps], q.resolution).to(torch.int32)
    h, w = tables.dims[maps, 0], tables.dims[maps, 1]
    oob = (gx < 0) | (gx >= w) | (gy < 0) | (gy >= h)
    cell = (
        torch.minimum(torch.clamp(gy, min=0), h - 1).to(torch.int64) * w
        + torch.minimum(torch.clamp(gx, min=0), w - 1)
    )
    if row_map is not None:
        if tables.row_map_bases is not None:
            cell = cell + tables.row_map_bases[maps]
        row = row_map[cell].to(torch.int64)
    else:
        row = cell
    b0, frac = _heading_bin(q, particles[:, 2])
    start = tables.lut_bases[maps].to(torch.int64) * q.eps + row * q.row_stride + b0
    return start, frac, oob, member


def window_start(q: LUTQuery, particles, row_map=None):
    """Each particle's window, with the kernels' float32 address math
    (``pallas_lut.py`` query :873-900): (row (N,) int64, b0 (N,) int32,
    frac (N,) float32 or None without ``subbin``, oob (N,) bool). Off the
    map, row and b0 are those of the nearest cell."""
    x, y, theta = particles[:, 0], particles[:, 1], particles[:, 2]
    # IEEE division, as the kernels: a reciprocal multiply truncates to
    # another cell at knife edges
    gx = div(x - q.origin_x, q.resolution).to(torch.int32)  # truncates
    gy = div(y - q.origin_y, q.resolution).to(torch.int32)
    oob = (gx < 0) | (gx >= q.width) | (gy < 0) | (gy >= q.height)
    cell = (
        gy.clamp(0, q.height - 1).to(torch.int64) * q.width
        + gx.clamp(0, q.width - 1).to(torch.int64)
    )
    row = cell if row_map is None else row_map[cell].to(torch.int64)
    b0, frac = _heading_bin(q, theta)
    return row, b0, frac, oob


def _read_lut(lut_flat, idx) -> torch.Tensor:
    if lut_flat.dtype == torch.uint16:
        # few uint16 ops exist; read the bits through int16
        return (lut_flat.view(torch.int16)[idx].to(torch.int32) & 0xFFFF).to(torch.float32)
    return lut_flat[idx].to(torch.float32)


def _log_norm(q: LUTQuery, d: torch.Tensor) -> torch.Tensor:
    """log of the beam model's normaliser at expected range ``d`` (float32,
    already clipped to ``max_range_px``)."""
    m = q.m
    gauss_sum = 0.5 * (_erf_as(div(m - d + 0.5, q.sq2)) - _erf_as(div(-d - 0.5, q.sq2)))
    norm = (
        q.z_hit * gauss_sum
        + torch.where(d > 0, q.z_short * (d + 1.0), 0.0)
        + q.z_max
        + q.z_rand
    )
    return torch.log(norm)


def _log_norm_right(q: LUTQuery, d: torch.Tensor) -> torch.Tensor:
    """log of the normaliser with the short-return term on: at d > 0 the
    bits of :func:`_log_norm`, at d = 0 its limit from the right."""
    gauss_sum = 0.5 * (_erf_as(div(q.m - d + 0.5, q.sq2)) - _erf_as(div(-d - 0.5, q.sq2)))
    return torch.log(q.z_hit * gauss_sum + q.z_short * (d + 1.0) + q.z_max + q.z_rand)


def subbin_table_entries(m: float) -> int:
    """Rows of the sub-bin table at max range ``m`` px: SUBBIN_STEPS * m + 1
    for an integer m of 1..1023, else 0 (the query keeps the analytic
    normaliser)."""
    if m < 1 or m != int(m):
        return 0
    rows = SUBBIN_STEPS * int(m) + 1
    return rows if rows <= MAX_SUBBIN_ENTRIES else 0


def subbin_norm_table(q: LUTQuery, device: torch.device | str = "cpu") -> torch.Tensor:
    """Plain PyTorch version of ``subbin_norm_kernel``: (SUBBIN_STEPS * m +
    1, 4) float32. Row k is node d_k = k / SUBBIN_STEPS and the cubic
    Hermite segment of log norm over (d_{k-1}, d_k] in s = (d_k - d) *
    SUBBIN_STEPS: log norm(d) ~ c0 + s (c1 + s (c2 + s c3)), c0 the analytic
    :func:`_log_norm` at the node (the integer table's value at integer
    nodes). Slopes are exact Gaussian derivatives, the segment
    coefficients float64 rounded once; a segment's left end is the limit
    from the right, so row 1's reaches d -> 0+ and row 0 (d = 0 alone) is
    log norm(0)."""
    entries = subbin_table_entries(q.m)
    if entries < 1:
        raise ValueError(f"no sub-bin table at max_range_px {q.m} (an integer of 1..1023)")
    h = 1.0 / SUBBIN_STEPS
    d = torch.arange(entries, dtype=torch.float32, device=device) * h  # exact
    v = _log_norm(q, d)
    v0 = _log_norm_right(q, d[:-1])
    f32 = lambda x: float(np.float32(x))  # noqa: E731  the kernel's float32 constants

    def slope(dd, vv):  # log_norm_slope of csrc/beam_model.cuh, in double
        dd, sq2 = dd.double(), f32(q.sq2)
        u_lo = div(dd + 0.5, sq2)
        u_hi = div(f32(q.m) - dd + 0.5, sq2)
        dgauss = RSQRT_PI / sq2 * (torch.exp(-u_lo * u_lo) - torch.exp(-u_hi * u_hi))
        return (f32(q.z_hit) * dgauss + f32(q.z_short)) / torch.exp(vv.double())

    a1 = -h * slope(d[1:], v[1:])
    b1 = -h * slope(d[:-1], v0)
    delta = v0.double() - v[1:].double()
    rows = torch.zeros((entries, 4), dtype=torch.float32, device=device)
    rows[:, 0] = v
    rows[1:, 1] = a1.float()
    rows[1:, 2] = (3.0 * delta - 2.0 * a1 - b1).float()
    rows[1:, 3] = (b1 + a1 - 2.0 * delta).float()
    return rows


def subbin_log_norm(table: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """log norm(d) read from a sub-bin table as the kernels read it, d
    float32 in [0, m]: the segment of node ceil(d * SUBBIN_STEPS) at
    s = node - d * SUBBIN_STEPS (0 at a node, so a node gives its own
    value)."""
    u = d * SUBBIN_STEPS
    k = torch.ceil(u)
    s = k - u
    c = table[k.to(torch.int64)]
    return c[..., 0] + s * (c[..., 1] + s * (c[..., 2] + s * c[..., 3]))


def log_norm_table(q: LUTQuery, device: torch.device | str = "cpu") -> torch.Tensor:
    """Plain PyTorch version of ``log_norm_kernel``: the query's normaliser
    table, (ceil(max_range_px) + 1, 2) float32. Row e holds, at
    d = min(e, max_range_px), the analytic ``log norm(d)`` of
    :func:`lut_log_weights_reference` and ``1 / max(d, 1)``; a LUT entry e
    reads row min(e, last)."""
    entries = math.ceil(q.m) + 1
    d = torch.clamp(torch.arange(entries, dtype=torch.float32, device=device), max=q.m)
    return torch.stack([_log_norm(q, d), 1.0 / torch.clamp(d, min=1.0)], dim=1)


def _window_log_weights(q: LUTQuery, lut_flat, start, frac, obs_px, oob,
                        norm_table: torch.Tensor | None = None) -> torch.Tensor:
    """The beam model and beam sum of every particle's window, read from
    flat LUT index ``start`` (N,) onward, against one scan (R,) or each
    particle's own (N, R). With ``norm_table`` the normaliser is read from
    it as the kernels do: a (rows, 2) normaliser table by LUT entry (no
    sub-bin lerp), a (rows, 4) sub-bin table at the lerped range."""
    idx = start[:, None] + q.beam_offsets.to(device=start.device, dtype=torch.int64)[None, :]
    d = _read_lut(lut_flat, idx)
    subbin_table = norm_table is not None and norm_table.shape[1] == 4
    if norm_table is not None and not subbin_table:
        if frac is not None:
            raise ValueError("the sub-bin lerp has no integer table index")
        log_norm = norm_table[torch.clamp(d.to(torch.int64), max=norm_table.shape[0] - 1), 0]
    if frac is not None:
        # x0 + f * (x1 - x0), three float32 ops as the kernel's lerp
        d = d + frac[:, None] * (_read_lut(lut_flat, idx + 1) - d)

    m = q.m
    obs = torch.clamp(obs_px.to(torch.float32), max=m)
    if obs.dim() == 1:
        obs = obs[None, :]
    d = torch.clamp(d, max=m)
    z = obs - d
    p = q.gauss_coef * torch.exp(-(z * z) * q.inv2s2)
    p = p + torch.where(obs < d, q.short2 * (d - obs) / torch.clamp(d, min=1.0), 0.0)
    p = p + torch.where(obs >= m, q.z_max, 0.0)
    p = p + torch.where(obs < m, q.rand_term, 0.0)
    if subbin_table:
        log_norm = subbin_log_norm(norm_table, d)
    elif norm_table is None:
        log_norm = _log_norm(q, d)
    logp = torch.log(torch.clamp(p, min=LOG_TINY)) - log_norm
    # summed in double, as the kernel does, then rounded to float32
    logw = q.inv_squash * logp.sum(dim=1, dtype=torch.float64).to(torch.float32)
    return torch.where(oob, OOB_LOG_WEIGHT, logw)


def lut_log_weights_reference(
    q: LUTQuery, lut_flat, particles, obs_px, row_map=None, tables: FleetTables | None = None,
    norm_table: torch.Tensor | None = None,
) -> torch.Tensor:
    """Plain PyTorch version of ``csrc/lut_likelihood.cu``: the same
    float32 address math and analytic beam model (and the sub-bin lerp
    with ``q.subbin``), as one (N, R) gather, and the beam sum accumulated
    in double. The CPU path and the kernel's reference in the tests and on
    the card. A fleet query takes its ``tables``
    (:meth:`LUTQuery.fleet_tables`) and (F, R) scans. ``norm_table``
    (:func:`log_norm_table`, or with ``q.subbin`` :func:`subbin_norm_table`)
    reads the normaliser from it instead of evaluating it per beam."""
    if q.fleet:
        if tables is None:
            raise ValueError("a fleet query needs its tables (LUTQuery.fleet_tables)")
        start, frac, oob, member = fleet_window_start(q, particles, tables, row_map)
        return _window_log_weights(q, lut_flat, start, frac, obs_px[member], oob, norm_table)
    row, b0, frac, oob = window_start(q, particles, row_map)
    start = row * q.row_stride + b0.to(torch.int64)
    return _window_log_weights(q, lut_flat, start, frac, obs_px, oob, norm_table)


def dedup_keys(q: LUTQuery, particles, row_map=None) -> torch.Tensor:
    """Every particle's window key, int64: its first subrow, ``row *
    (row_stride / eps) + b0 // eps`` (0 off the map)."""
    row, b0, _, oob = window_start(q, particles, row_map)
    return torch.where(
        oob, 0, row * (q.row_stride // q.eps) + torch.div(b0, q.eps, rounding_mode="floor")
    )


def window_keys(q: LUTQuery, particles, row_map=None):
    """Plain version of ``window_key_kernel`` (``csrc/lut_dedup.cu``):
    (keys (N,) int32, the window's flat start // eps and 0 off the map;
    starts (N,) int64, -1 off the map; fracs (N,) float32 with
    ``q.subbin`` else None). Raises where a key is past int32."""
    row, b0, frac, oob = window_start(q, particles, row_map)
    start = row * q.row_stride + b0.to(torch.int64)
    if bool((start // q.eps > INT32_MAX).any()):
        raise ValueError("window keys past 2^31 - 1 do not fit int32")
    keys = torch.where(oob, 0, start // q.eps).to(torch.int32)
    starts = torch.where(oob, -1, start)
    fracs = None if frac is None else torch.where(oob, 0.0, frac)
    return keys, starts, fracs


def dedup_plan(q: LUTQuery, particles, row_map=None, slots: int | None = None):
    """The unique-window kernel's tables, as torch ops on the particles'
    device with no host sync (``pallas_lut.py`` query :951-978).

    Every particle's window key is its first subrow (:func:`dedup_keys`).
    The particles are sorted by key
    (``perm``), the sorted order is cut into blocks of ``q.block``, and
    ``rank`` is each particle's 0-based rank among its block's distinct
    keys. ``slot_y0`` (nb * S,) int64 holds each block's first S distinct
    keys: a scatter-amax whose writers of one slot share one key; ranks
    >= S go to a spare slot that is dropped. Returns (perm (N,) int64,
    rank (N,) int32, slot_y0, overflow), ``overflow`` the 0-d count of
    blocks with more than S distinct keys.
    """
    slots = q.dedup_slots if slots is None else int(slots)
    if slots < 1:
        raise ValueError(f"dedup_plan needs slots >= 1, got {slots}")
    key = dedup_keys(q, particles, row_map)
    n, bsz = key.shape[0], q.block
    key_sorted, perm = torch.sort(key, stable=True)
    pos = torch.arange(n, device=key.device)
    first = pos - pos % bsz
    new = pos == first
    new[1:] |= key_sorted[1:] != key_sorted[:-1]
    c = torch.cumsum(new, 0, dtype=torch.int32)
    rank = c - c[first]
    nb = -(-n // bsz)
    spare = nb * slots
    idx = torch.where(rank < slots, (pos // bsz) * slots + rank, spare)
    slot_y0 = torch.zeros(spare + 1, dtype=torch.int64, device=key.device)
    slot_y0 = slot_y0.scatter_reduce_(0, idx, key_sorted, "amax")[:spare].contiguous()
    last = torch.clamp(torch.arange(1, nb + 1, device=key.device) * bsz, max=n) - 1
    overflow = (rank[last] >= slots).sum()
    return perm, rank, slot_y0, overflow


def lut_dedup_reference(
    q: LUTQuery, lut_flat, particles, obs_px, row_map=None, slots: int | None = None
):
    """Plain PyTorch version of ``csrc/lut_dedup.cu``: every particle
    reads its beams through the slot table of :func:`dedup_plan`, from
    ``slot_y0[block, rank] * eps + b0 % eps``, and from its own window
    only where its rank is >= S. With a right plan this is
    :func:`lut_log_weights_reference` bit for bit. Returns (log weights
    (N,), the 0-d count of overflowed blocks)."""
    slots = q.dedup_slots if slots is None else int(slots)
    perm, rank, slot_y0, overflow = dedup_plan(q, particles, row_map, slots)
    row, b0, frac, oob = window_start(q, particles, row_map)
    own = row * q.row_stride + b0.to(torch.int64)
    rem = (b0 % q.eps).to(torch.int64)
    pos = torch.arange(own.shape[0], device=own.device)
    slot = (pos // q.block) * slots + rank.clamp(max=slots - 1)
    via_slot = slot_y0[slot] * q.eps + rem[perm]
    start = torch.empty_like(own)
    start[perm] = torch.where(rank < slots, via_slot, own[perm])
    return _window_log_weights(q, lut_flat, start, frac, obs_px, oob), overflow
