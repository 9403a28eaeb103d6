"""Grid ray casting in plain PyTorch: the JAX package's ``ops/raycast.py``
``cast_rays_dda`` (the reference-exact oracle that tests use to make
scans) and ``cast_rays_sphere`` (EDT sphere marching, which config #4
uses to synthesize its scans). No kernel: each is a loop of a few
elementwise ops over all rays, on the map's device.

Queries are (Q, 3) float32 world-space (x, y, absolute ray angle);
results are (Q,) float32 ranges in meters. World-to-grid casts truncate
toward zero like the reference's ``static_cast<int>``. Divisions go
through ``utils/geometry.py`` ``div`` (IEEE on the card too).
"""

from __future__ import annotations

import torch

from monte_carlo_localization_tpu_torch.mapping.grid_map import GridMap
from monte_carlo_localization_tpu_torch.utils.geometry import div

# The reference's cast_ray returns ``step * resolution`` with the 0-based
# step of the check after advancing, one cell short of the crossing; the
# sphere marcher subtracts this bias to agree with the oracle.
DDA_BIAS_PX = 1.0


def _cells(gm: GridMap, gx: torch.Tensor, gy: torch.Tensor):
    """(outside the map, flat index of the nearest cell)."""
    h, w = gm.height, gm.width
    oob = (gx < 0) | (gx >= w) | (gy < 0) | (gy >= h)
    idx = gy.clamp(0, h - 1).to(torch.int64) * w + gx.clamp(0, w - 1).to(torch.int64)
    return oob, idx


def cast_rays_dda(grid_map: GridMap, queries: torch.Tensor) -> torch.Tensor:
    """Reference-exact fixed-step march (JAX ``cast_rays_dda``): up to
    ``max_range_px`` steps of one resolution along the ray; the range is
    ``step * resolution`` at the first step outside the map or on an
    occupied cell, else ``max_range_meters``."""
    gm = grid_map
    res = gm.resolution
    occ = gm.occupied.reshape(-1)
    x0, y0, ang = queries[:, 0], queries[:, 1], queries[:, 2]
    dx = torch.cos(ang) * res
    dy = torch.sin(ang) * res
    sentinel = gm.max_range_px
    hit = torch.full(x0.shape, sentinel, dtype=torch.int32, device=x0.device)
    for step in range(gm.max_range_px):
        cx = x0 + dx * float(step + 1)
        cy = y0 + dy * float(step + 1)
        gx = div(cx - gm.origin_x, res).to(torch.int32)
        gy = div(cy - gm.origin_y, res).to(torch.int32)
        oob, idx = _cells(gm, gx, gy)
        blocked = oob | occ[idx]
        hit = torch.where((hit == sentinel) & blocked, step, hit)
    return torch.where(
        hit < sentinel,
        hit.to(queries.dtype) * res,
        torch.tensor(gm.max_range_meters, dtype=queries.dtype, device=x0.device),
    )


def cast_rays_sphere(
    grid_map: GridMap, queries: torch.Tensor, num_iters: int = 48
) -> torch.Tensor:
    """EDT sphere marching (JAX ``cast_rays_sphere``): each of
    ``num_iters`` iterations advances a ray by ``max(clearance - 1.5, 1)``
    px until it reaches a cell of zero clearance or ``max_range_px``; the
    range is the travelled distance less the DDA bias, clipped to the
    maximum range."""
    gm = grid_map
    res = gm.resolution
    max_px = float(gm.max_range_px)
    clearance = gm.clearance.reshape(-1)
    px0 = div(queries[:, 0] - gm.origin_x, res)
    py0 = div(queries[:, 1] - gm.origin_y, res)
    ux = torch.cos(queries[:, 2])
    uy = torch.sin(queries[:, 2])
    t = torch.zeros_like(px0)
    done = torch.zeros(px0.shape, dtype=torch.bool, device=px0.device)
    for _ in range(num_iters):
        gx = (px0 + ux * t).to(torch.int32)
        gy = (py0 + uy * t).to(torch.int32)
        oob, idx = _cells(gm, gx, gy)
        c = torch.where(oob, 0.0, clearance[idx])
        newly_done = (c <= 0.0) | (t >= max_px)
        step = torch.clamp(c - 1.5, min=1.0)
        t = torch.where(done | newly_done, t, t + step)
        done = done | newly_done
    t = torch.clamp(t - DDA_BIAS_PX, 0.0, max_px)
    return torch.clamp(t * res, max=gm.max_range_meters)
