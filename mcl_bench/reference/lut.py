"""The range LUT's entries by their definition, worked out per (cell, bin).

The LUT holds, for every cell and theta bin, the range in pixels to the
first occupied cell along a sheared grid line (the shear-scan dynamic
program of the upstream's range LUT family). For a bin, lines run along
the driving axis (rows where |sin| >= |cos|, else columns); from line p
to the next line the lateral position moves by
``rint(delta * d * (p + d)) - rint(delta * d * p)`` cells (``delta`` the
direction's lateral slope, ``d`` the sweep's sign). An entry counts the
free cells from its own along that path until an occupied cell or the
map's edge, then is ``trunc(clamp(count * step_len - 1, 0, max) + 0.5)``
in float32, ``step_len`` = 1 / |driving component|.

Here each entry a query needs is marched on its own (no sweep), and the
entries are cached for the run.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def theta_bins(beam_angles: np.ndarray, target: int = 1440) -> int:
    """T near ``target`` with one beam step an integer number of bins."""
    a = np.asarray(beam_angles, np.float64)
    inc = np.median(np.abs(np.diff(a)))
    k = max(1, int(round(inc * target / (2.0 * math.pi))))
    return max(8, int(round(2.0 * math.pi * k / inc)))


def beam_offsets(beam_angles: np.ndarray, t_bins: int) -> tuple[int, np.ndarray]:
    """(base, offsets): beam j reads bin ``(b0 + offsets[j]) % T`` of a
    particle whose heading bin, shifted by ``base``, is b0."""
    delta = 2.0 * math.pi / t_bins
    bins = np.round(np.asarray(beam_angles, np.float64) / delta).astype(np.int64)
    r = len(bins)
    k = max(1, int(round((bins[-1] - bins[0]) / (r - 1)))) if r > 1 else 1
    e = bins - bins[0] - k * np.arange(r, dtype=np.int64)
    base = int(bins[0] + e.min())
    return base, k * np.arange(r, dtype=np.int64) + (e - e.min())


class RangeOracle:
    """Entries of the (H, W, T) range LUT of ``occupied``, on ``device``."""

    def __init__(self, occupied: np.ndarray, t_bins: int, max_range_px: int, device):
        h, w = occupied.shape
        self.t, self.maxr, self.dev = int(t_bins), int(max_range_px), torch.device(device)
        b = np.arange(t_bins)
        th = 2.0 * np.pi * b / t_bins
        c, s = np.cos(th), np.sin(th)
        rm = np.abs(s) >= np.abs(c)
        sp = np.where(rm, np.sign(s), np.sign(c)).astype(np.int64)
        sp[sp == 0] = 1
        denom = np.where(rm, np.abs(s), np.abs(c))
        delta = np.where(rm, c, s) / denom
        p = np.arange(max(h, w) + 1)[:, None]
        dd = delta[None, :] * sp[None, :]
        rel = np.rint(dd * (p + sp[None, :])) - np.rint(dd * p)
        to = lambda x, dt: torch.as_tensor(x, dtype=dt, device=self.dev)  # noqa: E731
        self.occ = to(np.ascontiguousarray(occupied), torch.bool)
        self.h, self.w = h, w
        self.rm = to(rm, torch.bool)
        self.sp = to(sp, torch.int64)
        self.step = to(denom, torch.float64).reciprocal().to(torch.float32)
        self.rel = to(rel.astype(np.int8), torch.int64)
        dtype = torch.int16 if max_range_px > 254 else torch.uint8
        self.unknown = -1 if dtype == torch.int16 else 255
        self.cache = torch.full((h * w * self.t,), self.unknown, dtype=dtype, device=self.dev)

    def entries(self, gy: torch.Tensor, gx: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """float64 entries of cells (gy, gx) in bins b (any equal shapes)."""
        key = (gy.to(torch.int64) * self.w + gx.to(torch.int64)) * self.t + b.to(torch.int64)
        key = key.to(self.dev)
        got = self.cache[key]
        miss = torch.unique(key[got == self.unknown])
        if miss.numel():
            self.cache[miss] = self._march(miss).to(self.cache.dtype)
            got = self.cache[key]
        return got.to(torch.float64)

    def _march(self, key: torch.Tensor) -> torch.Tensor:
        b = key % self.t
        cell = key // self.t
        y, x = cell // self.w, cell % self.w
        rm = self.rm[b]
        p = torch.where(rm, y, x)
        q = torch.where(rm, x, y)
        n_p = torch.where(rm, self.h, self.w)
        n_q = torch.where(rm, self.w, self.h)
        step_p = torch.where(self.sp[b] < 0, -1, 1)  # the line the DP reads from
        count = torch.zeros_like(key)
        alive = torch.ones_like(key, dtype=torch.bool)
        for _ in range(self.maxr + 2):
            yy = torch.where(rm, p, q).clamp(0, self.h - 1)
            xx = torch.where(rm, q, p).clamp(0, self.w - 1)
            alive &= ~self.occ[yy, xx]
            count += alive.to(count.dtype)
            q = q + self.rel[p.clamp(0, self.rel.shape[0] - 1), b]
            p = p + step_p
            alive &= (p >= 0) & (p < n_p) & (q >= 0) & (q < n_q)
            if not bool(alive.any()):
                break
        px = count.to(torch.float32) * self.step[b] - 1.0
        return (torch.clamp(px, 0.0, float(self.maxr)) + 0.5).to(torch.int32)
