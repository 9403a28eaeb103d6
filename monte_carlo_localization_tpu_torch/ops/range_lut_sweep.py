"""The shear sweep of the range-LUT builders: one bin group's backward
sweep over the grid lines, written into the LUT (``csrc/range_lut_sweep.cu``
on a card, :func:`sweep_group_reference` on the CPU).

It replaces the JAX package's ``_sweep_group`` (an XLA ``lax.scan``,
``mapping/range_lut_device.py:35-77``): for each physical bin b of the
group, with the driving axis first (``occupied`` or its transpose),

    D_p[q] = occupied(p, q) ? 0 : D_{p+d}[q + rel[p, b]] + 1   (0 off the line)
    px     = clip(D_p[q] * step_len[b] - 1, 0, max_range_px)

and ``(px + 0.5)`` truncated to the LUT's type is stored at
``(row_base + row) * row_stride + bins[b]``, where ``row`` is the cell
(``y * W + x``), or ``row_map[cell]`` for a row-compacted LUT, whose row 0
(the shared far row) is never written. The sweep runs forward (p = 0, 1,
...) when the group's direction is negative, backward otherwise.

:data:`sweep` launches the kernel on CUDA tensors, adding one to its
``launch_count``, and runs the plain version on CPU tensors. The kernel
sweeps the group in blocks of one tile of adjacent physical bins
(:func:`tile_plan`: a 32 B piece of each LUT row) by one chunk of lines
(:func:`chunk_lines`), keeping D saturated at ``max_range_px + 1`` so a
chunk can start from a warm-up of that many lines; the host makes both
plans and the cell words in line order (:func:`line_cells`). Two lines of
D sit in a block's shared memory up to ``MAX_LINE_CELLS`` cells a line;
a longer line keeps them in a global scratch of two lines a resident
block (:func:`line_layout`), so every grid line the card can hold is
swept by the kernel.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch
import torch.nn.functional as F

# a block's shared memory on an H100 (opt-in): two lines of D at `words`
# 4 B words a cell with a zero cell at each end, and two lines of cell
# words (:func:`smem_bytes`, the kernel's own formula)
SMEM_BYTES = 232_448
LINE_WORDS = (8, 4, 2, 1)  # D words a cell: a tile of 32, 16, 8 or 4 B of a LUT row
# the longest grid line whose two lines of D fit a block's shared memory
# (one word a cell); a longer one keeps D in global memory
MAX_LINE_CELLS = (SMEM_BYTES - 16) // 16
# the most global scratch a launch with D in global memory takes: it caps
# the blocks resident at once (two lines of D each)
SCRATCH_BYTES = 256 << 20
MAX_THREADS = 1024
OCCUPIED = -(2**31)  # a cell word's flag (bit 31); the low bits are its LUT row
# cost of a warm-up line against a stored line, for the chunk plan: a
# warm-up line updates D and stores nothing, about a third of the
# instructions of a stored one
WARM_COST = 0.3


def smem_bytes(q_len: int, words: int) -> int:
    """Dynamic shared memory of a block sweeping lines of ``q_len`` cells
    at ``words`` words a cell, D in shared memory."""
    return 8 * words * (q_len + 2) + 8 * q_len


def d_bytes(q_len: int, words: int) -> int:
    """Two lines of D for lines of ``q_len`` cells at ``words`` words a
    cell: a block's global scratch where D lies in global memory."""
    return 8 * words * (q_len + 2)


def line_words(q_len: int) -> int:
    """D words a cell for lines of ``q_len`` cells: the widest tile whose
    two lines fit a block's shared memory; 0 when none does."""
    return next((w for w in LINE_WORDS if smem_bytes(q_len, w) <= SMEM_BYTES), 0)


def line_layout(q_len: int) -> tuple[int, bool]:
    """(D words a cell, D in global memory) of the kernel's blocks for
    lines of ``q_len`` cells, decided from the length alone before any
    launch: :func:`line_words` in shared memory, else the widest tile with
    D in global memory."""
    words = line_words(q_len)
    return (words, False) if words else (LINE_WORDS[0], True)


def tile_plan(bins: np.ndarray, lanes: int) -> np.ndarray:
    """(n, 4) int32 tiles of a group's physical ``bins`` (ascending, as
    ``shear_groups`` gives them) at ``lanes`` bins a tile: each row is
    (group index of its first bin, base physical bin, lo, hi), the tile
    holding bins ``base + lo .. base + hi - 1``, with ``base`` a multiple
    of ``lanes``. A tile is one run of adjacent bins cut at multiples of
    ``lanes``, so its bins are one contiguous, aligned piece of each LUT
    row."""
    b = np.asarray(bins, dtype=np.int64)
    if b.size == 0:
        return np.zeros((0, 4), np.int32)
    cut = np.ones(b.size, bool)
    cut[1:] = (b[1:] != b[:-1] + 1) | (b[1:] // lanes != b[:-1] // lanes)
    first = np.nonzero(cut)[0]
    count = np.diff(np.append(first, b.size))
    base = b[first] // lanes * lanes
    lo = b[first] - base
    return np.stack([first, base, lo, lo + count], 1).astype(np.int32)


def chunk_lines(p_len: int, n_tiles: int, sat: int, slots: int) -> int:
    """Stored lines a chunk: the chunk count that minimises the launch's
    waves (``n_tiles`` blocks a chunk, ``slots`` blocks resident on the
    card at once) times a block's lines, a warm-up line (``sat`` of them
    before every chunk but the first) costing WARM_COST of a stored one."""
    best = (math.inf, p_len)
    for n in range(1, min(p_len, max(1, 8 * slots // max(n_tiles, 1))) + 1):
        lines = -(-p_len // n)
        chunks = -(-p_len // lines)
        warm = min(sat, (chunks - 1) * lines)
        cost = -(-n_tiles * chunks // slots) * (lines + WARM_COST * warm)
        if cost < best[0]:
            best = (cost, lines)
    return best[1]


def warm_lines(p_len: int, lines: int, sat: int) -> int:
    """Warm-up lines a tile's chunks sweep before they store (``sat``
    before every chunk, fewer before one that starts closer to the
    sweep's first line)."""
    return sum(min(sat, first) for first in range(0, p_len, lines))


def warm_share(p_len: int, lines: int, sat: int) -> float:
    """Warm-up lines over all lines a launch's blocks sweep."""
    warm = warm_lines(p_len, lines, sat)
    return warm / (warm + p_len)


def line_cells(occupied: torch.Tensor, row_map, row_major: bool) -> torch.Tensor:
    """(P, Q) int32 cell words in line order: the cell's LUT row (its
    index ``y * W + x``, or ``row_map[cell]``), with OCCUPIED set where the
    cell is occupied; a column group's lines are the map's columns."""
    h, w = occupied.shape
    rows = (torch.arange(h * w, dtype=torch.int32, device=occupied.device)
            if row_map is None else row_map)
    cells = torch.where(occupied.reshape(-1), rows | OCCUPIED, rows).view(h, w)
    return cells if row_major else cells.t().contiguous()


def _store(vals: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """float32 ``px + 0.5`` truncated toward zero into ``dtype``; uint16
    through int16 bits (few uint16 ops exist)."""
    v = vals.to(torch.int32)
    if dtype == torch.uint16:
        return v.to(torch.int16)
    return v.to(dtype)


def sweep_group_reference(occupied, rel, step_len, bins, forward: bool, row_major: bool,
                          max_range_px: int, out, row_stride: int, row_map=None,
                          row_base: int = 0) -> None:
    """Plain version of the sweep kernel, in place on ``out`` (flat LUT),
    one line at a time: ``occupied`` (H, W) bool, ``rel`` (P, B) int8,
    ``step_len`` (B,) float32, ``bins`` (B,) physical bins (on any
    device), ``row_map`` (H*W,) int32 or None (dense)."""
    w = occupied.shape[1]
    dev = occupied.device
    occ_p = occupied if row_major else occupied.t()
    p_len, q_len = occ_p.shape
    step = step_len[:, None]
    maxr = float(max_range_px)
    lut = (out.view(torch.int16) if out.dtype == torch.uint16 else out).view(-1, row_stride)
    cols = torch.as_tensor(bins).to(device=dev, dtype=torch.int64)[None, :]
    q = torch.arange(q_len, device=dev)
    d_prev = torch.zeros((rel.shape[1], q_len), dtype=torch.float32, device=dev)
    for p in (range(p_len) if forward else range(p_len - 1, -1, -1)):
        r = rel[p].to(torch.int32)[:, None]
        left = F.pad(d_prev[:, 1:], (0, 1))
        right = F.pad(d_prev[:, :-1], (1, 0))
        nxt = torch.where(r == 1, left, torch.where(r == -1, right, d_prev))
        d_prev = torch.where(occ_p[p][None, :], 0.0, nxt + 1.0)
        vals = _store(torch.clamp(d_prev * step - 1.0, 0.0, maxr) + 0.5, out.dtype).t()
        rows = p * w + q if row_major else q * w + p
        if row_map is not None:
            rows = row_map[rows].to(torch.int64)
            keep = rows > 0  # row 0, the shared far row, is never written
            rows, vals = rows[keep], vals[keep]
        lut[(rows + row_base)[:, None], cols] = vals


def _check(t: torch.Tensor, dtype: torch.dtype, name: str, dev: torch.device) -> None:
    if t.dtype != dtype or t.device != dev or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {dtype} tensor on {dev}, got "
                         f"{t.dtype} on {t.device}")


class RangeLUTSweep:
    """The sweep kernel's wrapper. On CUDA tensors every call is one
    launch, counted in ``launch_count`` and planned by :meth:`plan`; on
    CPU tensors the plain version runs. ``bins`` is read on the host,
    where the tile plan is made (a CUDA tensor costs a sync). A kernel
    that does not build or launch raises; so does a line past
    ``MAX_LINE_CELLS``, where D goes to a global scratch, if that scratch
    cannot be allocated."""

    def __init__(self):
        self.launch_count = 0
        self._occupancy: dict[tuple, int] = {}  # blocks an SM, by launch shape

    def __call__(self, occupied, rel, step_len, bins, forward: bool, row_major: bool,
                 max_range_px: int, out, row_stride: int, row_map=None,
                 row_base: int = 0) -> None:
        if occupied.device.type == "cpu":
            sweep_group_reference(occupied, rel, step_len, bins, forward, row_major,
                                  max_range_px, out, row_stride, row_map, row_base)
            return
        dev = occupied.device
        if out.dtype not in (torch.uint8, torch.uint16):
            raise ValueError(f"LUT dtype {out.dtype} is not uint8/uint16")
        _check(occupied, torch.bool, "occupied", dev)
        _check(rel, torch.int8, "rel", dev)
        _check(step_len, torch.float32, "step_len", dev)
        _check(out, out.dtype, "out", dev)
        if row_map is not None:
            _check(row_map, torch.int32, "row_map", dev)
        bins = np.asarray(bins.cpu() if isinstance(bins, torch.Tensor) else bins, np.int64)
        h, w = occupied.shape
        p_len, q_len = (h, w) if row_major else (w, h)
        b = rel.shape[1]
        if rel.shape != (p_len, b) or step_len.shape != (b,) or bins.shape != (b,):
            raise ValueError(f"rel {tuple(rel.shape)}, step_len {tuple(step_len.shape)} and "
                             f"bins {tuple(bins.shape)} do not fit {p_len} lines of {b} bins")
        itemsize = out.element_size()
        if h * w >= 2**31:
            raise ValueError(f"a map of {h} x {w} cells exceeds the cell words' 2^31 rows")
        from monte_carlo_localization_tpu_torch.ops._cuda_build import load_library
        from monte_carlo_localization_tpu_torch.utils.device import upload

        plan = self.plan(p_len, q_len, bins, itemsize, max_range_px, dev)
        lib = load_library().libs["range_lut_sweep"]
        fn = lib.mcl_range_lut_sweep_u16 if itemsize == 2 else lib.mcl_range_lut_sweep_u8
        cells = line_cells(occupied, row_map, row_major)
        vec_ok = (row_stride * itemsize) % 4 == 0 and out.data_ptr() % 4 == 0
        # two lines of D a resident block, freed to the stream's allocator
        # once the launch is queued
        scratch = (torch.empty(plan["scratch_bytes"] // 4, dtype=torch.int32, device=dev)
                   if plan["global_d"] else None)
        err = fn(cells.data_ptr(), None if scratch is None else scratch.data_ptr(),
                 rel.data_ptr(), step_len.data_ptr(),
                 upload(plan["tile_table"], dev, torch.int32).data_ptr(), plan["tiles"],
                 plan["blocks"], p_len, q_len, b, plan["words"].bit_length() - 1, plan["lines"],
                 int(forward), int(row_map is not None), int(max_range_px) + 1,
                 float(max_range_px), int(vec_ok), row_stride, row_base, plan["grid"],
                 plan["threads"], out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"range_lut_sweep launch failed: CUDA error {err} "
                               f"({load_library().error_string(err)})")
        self.launch_count += 1

    def plan(self, p_len: int, q_len: int, bins, itemsize: int, max_range_px: int,
             device: torch.device) -> dict:
        """The launch of one group on ``device``: its tiles (``tile_table``,
        ``tiles``, ``words`` a cell), where D lies (``global_d``,
        :func:`line_layout`), ``threads`` a block, the ``slots`` an SM
        count and occupancy give (and, for D in global memory, the
        scratch cap), the chunk ``lines``, ``chunks``, ``blocks`` (the
        (tile, chunk) items), the ``grid`` that sweeps them (``blocks``,
        or at most ``slots`` blocks that loop over them), its
        ``scratch_bytes`` and the ``warm_share`` of swept lines. Raises
        ``ValueError`` where the range does not fit the kernel,
        ``RuntimeError`` where its library did not build."""
        words, global_d = line_layout(q_len)
        sat = int(max_range_px) + 1  # D saturates here, in a lane of the LUT's width
        if sat >= 1 << (8 * itemsize):
            raise ValueError(f"max_range_px {max_range_px} does not fit the sweep's "
                             f"{8 * itemsize}-bit distances (at most {(1 << 8 * itemsize) - 2})")
        from monte_carlo_localization_tpu_torch.ops._cuda_build import load_library

        built = load_library()
        lib = built.libs.get("range_lut_sweep")
        if lib is None:
            raise RuntimeError("the range_lut_sweep kernel library was not built "
                               f"(built: {sorted(built.libs)})")
        tiles = tile_plan(np.asarray(bins), words * 4 // itemsize)
        threads = min(MAX_THREADS, -(-q_len * words // 32) * 32)
        key = (itemsize, threads, q_len, words, int(global_d))
        if key not in self._occupancy:
            n = ctypes.c_int(0)
            err = lib.mcl_range_lut_sweep_occupancy(*key, ctypes.byref(n))
            if err != 0 or n.value < 1:
                raise RuntimeError(f"range_lut_sweep occupancy query failed: CUDA error {err} "
                                   f"({built.error_string(err)}), {n.value} blocks an SM")
            self._occupancy[key] = n.value
        slots = torch.cuda.get_device_properties(device).multi_processor_count * self._occupancy[key]
        if global_d:
            slots = max(1, min(slots, SCRATCH_BYTES // d_bytes(q_len, words)))
        lines = chunk_lines(p_len, len(tiles), sat, slots)
        chunks = -(-p_len // lines)
        blocks = len(tiles) * chunks
        grid = min(blocks, slots) if global_d else blocks
        return dict(tile_table=tiles, tiles=len(tiles), words=words, tile_bytes=4 * words,
                    global_d=global_d, threads=threads, slots=slots, lines=lines, chunks=chunks,
                    blocks=blocks, grid=grid,
                    scratch_bytes=grid * d_bytes(q_len, words) if global_d else 0, p_len=p_len,
                    warm_lines=warm_lines(p_len, lines, sat),
                    warm_share=warm_share(p_len, lines, sat))


# the one wrapper the LUT builders launch through
sweep = RangeLUTSweep()
