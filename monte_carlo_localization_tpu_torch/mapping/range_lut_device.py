"""Range-LUT builders on the map's device, as in the JAX package's
``mapping/range_lut_device.py``: only the occupancy grid (and, for a
row-compacted LUT, its row map) goes to the card; the LUT is written there.

Bins are grouped by (driving axis, sweep direction) into up to four
groups; within a group the per-line shear drift is in {-1, 0, +1}. The
drift tables ``rel`` (P, B) int8 and the per-bin ``step_len`` (B,) float32
are computed on the host in float64 exactly as the JAX package computes
them (:func:`shear_groups`), and each group is one sweep
(``ops/range_lut_sweep.py``: the CUDA kernel on a card, its plain version
on the CPU). The results equal the JAX device builders and the native
host builder bit for bit.

Rows may be padded to ``row_stride`` entries with angle-wraparound
content: physical bin b carries the angle of logical bin ``b % t_bins``
and is swept as a bin of its own.

Row compaction (giant maps, Spielberg scale): a cell whose clearance is at
least ``max_range_px + FAR_ROW_MARGIN`` sees max_range in every direction,
so all such cells share one constant far row (row 0); the others get real
rows through an (H*W,) int32 row map. The compact LUT is flat,
``(K + 1) * row_stride`` entries, the layout the port's LUT kernels read.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

# margin over max_range_px for the shared far row: +1 for the reference's
# -1 px DDA bias, +1 for the shear-scan DP's <= 0.5-cell lateral snap
FAR_ROW_MARGIN = 2

SPAN = 512  # bytes of one LUT subrow: 512 u8 or 256 u16 entries


def compact_row_map(clearance: np.ndarray, max_range_px: int):
    """(row_map (H*W,) int32, row_cells (K,) int64): row 0 is the shared
    far row; cells with clearance < max_range_px + margin get rows 1..K."""
    near = np.asarray(clearance).reshape(-1) < max_range_px + FAR_ROW_MARGIN
    row_cells = np.nonzero(near)[0]
    row_map = np.zeros(near.shape[0], np.int32)
    row_map[row_cells] = np.arange(1, len(row_cells) + 1, dtype=np.int32)
    return row_map, row_cells


def _group_bins_padded(t_bins: int, row_stride: int):
    """({(row_major, direction): physical bins}, cos, sin) over
    ``row_stride`` physical bins, bin b at the angle of logical bin
    ``b % t_bins`` (the JAX package's ``_group_bins_padded``)."""
    thetas = 2.0 * np.pi * (np.arange(row_stride) % t_bins) / t_bins
    c, s = np.cos(thetas), np.sin(thetas)
    row_major = np.abs(s) >= np.abs(c)
    sp = np.where(row_major, np.sign(s), np.sign(c)).astype(np.int64)
    sp[sp == 0] = 1
    groups = {}
    for rm in (True, False):
        for d in (1, -1):
            idx = np.nonzero(row_major == rm)[0]
            idx = idx[sp[idx] == d]
            if len(idx):
                groups[(rm, d)] = idx
    return groups, c, s


@dataclass(frozen=True)
class ShearGroup:
    """One sweep: bins with one driving axis and direction."""

    row_major: bool  # lines are rows (driving axis y); else columns
    forward: bool  # sweep p = 0, 1, ... (direction negative)
    bins: np.ndarray  # (B,) int64 physical bins
    rel: np.ndarray  # (P, B) int8 drift between line p and line p + d
    step_len: np.ndarray  # (B,) float32 px advanced per line


def shear_groups(height: int, width: int, t_bins: int, row_stride: int = 0) -> list[ShearGroup]:
    """The bin groups of an (H, W) map over ``row_stride or t_bins``
    physical bins, with their shear tables (JAX ``range_lut_device.py``
    :122-138 and :314-324, float64 as there)."""
    groups, c, s = _group_bins_padded(t_bins, row_stride or t_bins)
    out = []
    for (rm, d), idx in groups.items():
        denom = np.abs(s[idx]) if rm else np.abs(c[idx])
        delta = (c[idx] if rm else s[idx]) / denom
        p = np.arange(height if rm else width)
        shift = np.rint(delta[None, :] * d * p[:, None])
        shift_n = np.rint(delta[None, :] * d * (p[:, None] + d))
        out.append(ShearGroup(
            row_major=rm, forward=d < 0, bins=idx,
            rel=(shift_n - shift).astype(np.int8),
            step_len=(1.0 / denom).astype(np.float32),
        ))
    return out


def torch_lut_dtype(max_range_px: int, lut_dtype=None) -> torch.dtype:
    """The LUT's torch dtype: ``lut_dtype`` (u8 or u16), else uint8 up to
    254 px and uint16 beyond."""
    from monte_carlo_localization_tpu_torch.mapping.range_lut import lut_dtype as pick

    dt = np.dtype(pick(max_range_px) if lut_dtype is None else lut_dtype)
    if dt.itemsize not in (1, 2):
        raise ValueError(f"unsupported LUT dtype {dt} (u8/u16 only)")
    return torch.uint8 if dt.itemsize == 1 else torch.uint16


def _sweep_all(occupied: torch.Tensor, t_bins: int, max_range_px: int, stride: int,
               out: torch.Tensor, row_map: torch.Tensor | None, row_base: int,
               plain: bool) -> None:
    from monte_carlo_localization_tpu_torch.ops.range_lut_sweep import (
        sweep,
        sweep_group_reference,
    )
    from monte_carlo_localization_tpu_torch.utils.device import upload

    h, w = occupied.shape
    dev = occupied.device
    groups = shear_groups(h, w, t_bins, stride)
    # every table goes up before the first launch: nothing waits on the card
    tables = [(upload(g.rel, dev, torch.int8), upload(g.step_len, dev)) for g in groups]
    for g, (rel, step_len) in zip(groups, tables):
        (sweep_group_reference if plain else sweep)(
            occupied, rel, step_len, g.bins, g.forward, g.row_major, max_range_px, out,
            stride, row_map, row_base,
        )


def _occupied_tensor(occupied) -> torch.Tensor:
    """(H, W) contiguous bool tensor; a host array stays on the CPU."""
    if not isinstance(occupied, torch.Tensor):
        return torch.from_numpy(np.array(occupied, dtype=bool))
    return occupied.to(torch.bool).contiguous()


def build_range_lut_device(occupied, t_bins: int, max_range_px: int, row_stride: int = 0,
                           lut_dtype=None, *, out: torch.Tensor | None = None,
                           row_base: int = 0, plain: bool = False) -> torch.Tensor:
    """(H, W, row_stride or T) dense u8/u16 range LUT, built on
    ``occupied``'s device (JAX ``build_range_lut_jax``). u8 up to 254 px
    and u16 beyond unless ``lut_dtype`` says. With ``out`` (a flat LUT
    buffer) the rows go in place from row ``row_base`` on, and ``out`` is
    returned: the stacked or tight member LUTs of a batched map.
    ``plain`` runs the sweep's plain version on any device (to hold the
    kernel against it)."""
    occ = _occupied_tensor(occupied)
    h, w = occ.shape
    stride = row_stride or t_bins
    if stride < t_bins:
        raise ValueError(f"row_stride {stride} < t_bins {t_bins}")
    dtype = torch_lut_dtype(max_range_px, lut_dtype)
    if out is None:
        out = torch.empty(h * w * stride, dtype=dtype, device=occ.device)
        view = True
    else:
        view = False
        if out.dtype != dtype or out.device != occ.device:
            raise ValueError(f"buffer {out.dtype} on {out.device} != {dtype} on {occ.device}")
        if row_base < 0 or (row_base + h * w) * stride > out.numel():
            raise ValueError(f"LUT block [{row_base}, {row_base + h * w}) exceeds the "
                             f"buffer's {out.numel() // stride} rows")
    _sweep_all(occ, t_bins, max_range_px, stride, out, None, row_base, plain)
    return out.view(h, w, stride) if view else out


def build_compact_range_lut_device(
    occupied,
    clearance,
    t_bins: int,
    max_range_px: int,
    row_stride: int,
    *,
    out: torch.Tensor | None = None,
    row_base: int = 0,
    lut_dtype=np.uint8,
    plain: bool = False,
):
    """Row-compacted range LUT built on ``occupied``'s device (JAX
    ``build_compact_range_lut_jax``): returns (lut, row_map (H*W,)
    np.int32), the LUT flat with ``(K + 1) * row_stride`` u8/u16 entries,
    row 0 the far row filled with ``max_range_px``.

    With ``out`` (a flat buffer, pre-filled with ``max_range_px``: far
    rows are never written) the block [row_base, row_base + K + 1) is
    written in place and ``out`` returned: every member of
    ``GridMap.with_member_compact_luts`` goes into one buffer. ``plain``
    as in :func:`build_range_lut_device`."""
    dtype = torch_lut_dtype(max_range_px, lut_dtype)
    itemsize = 1 if dtype == torch.uint8 else 2
    span = SPAN // itemsize  # entries of one 512 B subrow
    if row_stride % span != 0:
        raise ValueError(f"row_stride must be a multiple of {span}")
    occ = _occupied_tensor(occupied)
    row_map, row_cells = compact_row_map(clearance, max_range_px)
    k_rows = len(row_cells)
    if out is None:
        out = torch.full(((k_rows + 1) * row_stride,), max_range_px, dtype=dtype,
                         device=occ.device)
    else:
        # a miscomputed member base would overwrite the previous member's
        # rows: validate up front
        rows = out.numel() // row_stride if out.dim() == 1 else out.shape[0]
        if row_base < 0 or row_base + k_rows + 1 > rows:
            raise ValueError(
                f"member LUT block [{row_base}, {row_base + k_rows + 1}) exceeds the "
                f"buffer's {rows} rows"
            )
        if out.dim() not in (1, 2) or out.numel() % row_stride or (
                out.dim() == 2 and out.shape[1] != row_stride):
            raise ValueError(
                f"buffer shape {tuple(out.shape)} is not whole rows of row_stride "
                f"{row_stride}"
            )
        if out.dtype != dtype:
            raise ValueError(f"buffer dtype {out.dtype} != {dtype}")
    if k_rows:
        rm = torch.from_numpy(row_map).to(occ.device)
        _sweep_all(occ, t_bins, max_range_px, row_stride, out.view(-1), rm, row_base, plain)
    return out, row_map
