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
``launch_count``, and runs the plain version on CPU tensors.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# the kernel keeps two lines of D in shared memory: 2 * Q floats of a
# block's 227 KB (232,448 B)
MAX_LINE_CELLS = 232_448 // 8


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
    ``step_len`` (B,) float32, ``bins`` (B,) int32 physical bins,
    ``row_map`` (H*W,) int32 or None (dense)."""
    w = occupied.shape[1]
    dev = occupied.device
    occ_p = occupied if row_major else occupied.t()
    p_len, q_len = occ_p.shape
    step = step_len[:, None]
    maxr = float(max_range_px)
    lut = (out.view(torch.int16) if out.dtype == torch.uint16 else out).view(-1, row_stride)
    cols = bins.to(torch.int64)[None, :]
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
    launch, counted in ``launch_count``; on CPU tensors the plain
    version runs. A kernel that does not build or launch raises."""

    def __init__(self):
        self.launch_count = 0

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
        _check(bins, torch.int32, "bins", dev)
        _check(out, out.dtype, "out", dev)
        if row_map is not None:
            _check(row_map, torch.int32, "row_map", dev)
        h, w = occupied.shape
        p_len, q_len = (h, w) if row_major else (w, h)
        b = rel.shape[1]
        if rel.shape != (p_len, b) or step_len.shape != (b,) or bins.shape != (b,):
            raise ValueError(f"rel {tuple(rel.shape)}, step_len {tuple(step_len.shape)} and "
                             f"bins {tuple(bins.shape)} do not fit {p_len} lines of {b} bins")
        if q_len > MAX_LINE_CELLS:
            raise ValueError(f"a grid line of {q_len} cells exceeds the sweep kernel's "
                             f"{MAX_LINE_CELLS} (two lines in shared memory)")
        from monte_carlo_localization_tpu_torch.ops._cuda_build import load_library

        built = load_library()
        lib = built.libs.get("range_lut_sweep")
        if lib is None:
            raise RuntimeError("the range_lut_sweep kernel library was not built "
                               f"(built: {sorted(built.libs)})")
        fn = lib.mcl_range_lut_sweep_u16 if out.dtype == torch.uint16 else lib.mcl_range_lut_sweep_u8
        p_stride, q_stride = (w, 1) if row_major else (1, w)
        err = fn(occupied.data_ptr(), rel.data_ptr(), step_len.data_ptr(), bins.data_ptr(),
                 None if row_map is None else row_map.data_ptr(), p_len, q_len, b, p_stride,
                 q_stride, int(forward), float(max_range_px), row_stride, row_base,
                 out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"range_lut_sweep launch failed: CUDA error {err} "
                               f"({built.error_string(err)})")
        self.launch_count += 1


# the one wrapper the LUT builders launch through
sweep = RangeLUTSweep()
