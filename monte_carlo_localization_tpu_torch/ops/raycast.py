"""Grid ray casting in plain PyTorch, the JAX package's ``ops/raycast.py``
(XLA there, no Pallas): ``cast_rays_dda`` (the reference-exact fixed-step
march, the tests' oracle), ``cast_rays_sphere`` (EDT sphere marching),
``cast_rays_lut`` and ``lut_expected_px`` (one read of the precomputed
range LUT per ray: the ``lut`` likelihood method), and the ``cast_rays``
dispatch. Each is a few elementwise ops (a loop of them for the marchers)
over all rays, on the map's device.

Queries are (..., Q, 3) float32 world-space (x, y, absolute ray angle);
results are (..., Q) float32 ranges in meters. On a batched map (M maps,
``parallel.stack_maps``) the leading query axis is the map: queries
(M, Q, 3), map m's rays on map m (the JAX fleet vmaps over it). World-to-
grid casts truncate toward zero like the reference's ``static_cast<int>``.
Divisions go through ``utils/geometry.py`` ``div`` (IEEE on the card too).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from monte_carlo_localization_tpu_torch.mapping.grid_map import GridMap
from monte_carlo_localization_tpu_torch.utils.geometry import div

# The reference's cast_ray returns ``step * resolution`` with the 0-based
# step of the check after advancing, one cell short of the crossing; the
# sphere marcher subtracts this bias to agree with the oracle.
DDA_BIAS_PX = 1.0


def _origin(gm: GridMap, points: torch.Tensor):
    """The map's origin for (..., 3) ``points``; on a batched map (M, 1)
    per-map origins, the points' leading axis being the map."""
    if gm.is_batched:
        if points.dim() < 3 or points.shape[0] != gm.num_maps:
            raise ValueError(f"points {tuple(points.shape)} on a batched map of "
                             f"{gm.num_maps} maps need the map axis first: (M, Q, 3)")
        return gm.origin_x[:, None], gm.origin_y[:, None]
    return gm.origin_x, gm.origin_y


def _cells(gm: GridMap, gx: torch.Tensor, gy: torch.Tensor):
    """(outside the map, flat index of the nearest cell); on a batched
    map the index runs over all maps' cells, map m's rays in map m."""
    h, w = gm.height, gm.width
    oob = (gx < 0) | (gx >= w) | (gy < 0) | (gy >= h)
    idx = gy.clamp(0, h - 1).to(torch.int64) * w + gx.clamp(0, w - 1).to(torch.int64)
    if gm.is_batched:
        member = torch.arange(gm.num_maps, device=idx.device).view(-1, *([1] * (idx.dim() - 1)))
        idx = idx + member * (h * w)
    return oob, idx


def cast_rays_dda(grid_map: GridMap, queries: torch.Tensor) -> torch.Tensor:
    """Reference-exact fixed-step march (JAX ``cast_rays_dda``): up to
    ``max_range_px`` steps of one resolution along the ray; the range is
    ``step * resolution`` at the first step outside the map or on an
    occupied cell, else ``max_range_meters``."""
    gm = grid_map
    res = gm.resolution
    occ = gm.occupied.reshape(-1)
    ox, oy = _origin(gm, queries)
    x0, y0, ang = queries[..., 0], queries[..., 1], queries[..., 2]
    dx = torch.cos(ang) * res
    dy = torch.sin(ang) * res
    sentinel = gm.max_range_px
    hit = torch.full(x0.shape, sentinel, dtype=torch.int32, device=x0.device)
    for step in range(gm.max_range_px):
        cx = x0 + dx * float(step + 1)
        cy = y0 + dy * float(step + 1)
        gx = div(cx - ox, res).to(torch.int32)
        gy = div(cy - oy, res).to(torch.int32)
        oob, idx = _cells(gm, gx, gy)
        blocked = oob | occ[idx]
        hit = torch.where((hit == sentinel) & blocked, step, hit)
    # the maximum range as a Python number: no host-to-device copy, which a
    # captured step may not make (it rounds to the queries' type)
    return torch.where(hit < sentinel, hit.to(queries.dtype) * res, gm.max_range_meters)


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
    ox, oy = _origin(gm, queries)
    px0 = div(queries[..., 0] - ox, res)
    py0 = div(queries[..., 1] - oy, res)
    ux = torch.cos(queries[..., 2])
    uy = torch.sin(queries[..., 2])
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


def _lut_rows(gm: GridMap, points: torch.Tensor):
    """(outside the map, LUT row) of (..., 3) world points: the cell the
    point truncates to (clipped onto the map), through the row map of a
    compacted LUT; on a batched map's stacked LUT, map m's rows."""
    if gm.range_lut is None:
        raise ValueError("GridMap has no range LUT — call grid_map.with_range_lut() first")
    if gm.lut_member_base is not None:
        raise ValueError(
            "the lut method reads a dense or compact LUT (with_range_lut), not tight "
            "member blocks (with_member_luts / with_member_compact_luts)"
        )
    ox, oy = _origin(gm, points)
    res = gm.resolution
    gx = div(points[..., 0] - ox, res).to(torch.int32)
    gy = div(points[..., 1] - oy, res).to(torch.int32)
    oob, cell = _cells(gm, gx, gy)
    if gm.lut_row_map is not None:  # compacted LUT (giant maps)
        cell = gm.lut_row_map[cell].to(torch.int64)
    return oob, cell


def _lut_bins(gm: GridMap, ang: torch.Tensor) -> torch.Tensor:
    """round(angle / (2 pi / T)) floor-mod T, for any sign and any turn:
    the JAX ``jnp.round(...).astype(int32) % t`` (half to even, then a
    floor-mod), with T / 2 pi rounded to float32 as the JAX constant is."""
    t = gm.lut_theta_bins
    scale = float(np.float32(t / (2.0 * math.pi)))
    return torch.round(ang * scale).to(torch.int64) % t


def _read_entries(lut: torch.Tensor, row: torch.Tensor, b: torch.Tensor,
                  stride: int) -> torch.Tensor:
    """LUT entries ``lut[row * stride + b]`` as float32, int64 addresses
    (Spielberg-scale LUTs pass 2^31 entries); uint16 through int16 bits."""
    idx = row * stride + b
    if lut.dtype == torch.uint16:
        return (lut.view(torch.int16)[idx].to(torch.int32) & 0xFFFF).to(torch.float32)
    return lut[idx].to(torch.float32)


def cast_rays_lut(grid_map: GridMap, queries: torch.Tensor) -> torch.Tensor:
    """Precomputed-LUT ray cast (JAX ``cast_rays_lut``): one LUT read per
    query. The angle rounds to the nearest of T bins, the origin snaps
    to its cell; a query outside the map returns 0 (an immediate border
    hit, as DDA from an outside origin). Needs ``with_range_lut``."""
    gm = grid_map
    oob, row = _lut_rows(gm, queries)
    px = _read_entries(gm.range_lut, row, _lut_bins(gm, queries[..., 2]), gm.row_stride)
    r = torch.where(oob, 0.0, px * gm.resolution)
    return torch.clamp(r, max=gm.max_range_meters)


def lut_expected_px(grid_map: GridMap, particles: torch.Tensor,
                    beam_angles: torch.Tensor) -> torch.Tensor:
    """Expected ranges in pixels of every (particle, beam) pair (JAX
    ``lut_expected_px``): particles (..., N, 3), beams (R,) -> (..., N, R)
    float32 read straight from the LUT, no query matrix; a particle off
    the map reads 0 px on every beam."""
    gm = grid_map
    oob, row = _lut_rows(gm, particles)
    b = _lut_bins(gm, particles[..., 2:3] + beam_angles)
    px = _read_entries(gm.range_lut, row[..., None], b, gm.row_stride)
    return torch.where(oob[..., None], 0.0, px)


def cast_rays(grid_map: GridMap, queries: torch.Tensor, method: str = "sphere",
              num_iters: int = 48) -> torch.Tensor:
    """Dispatch on the method (JAX ``cast_rays``): (..., Q, 3) queries ->
    (..., Q) ranges in meters, the reference's ``calc_range_many``."""
    if method == "dda":
        return cast_rays_dda(grid_map, queries)
    if method == "sphere":
        return cast_rays_sphere(grid_map, queries, num_iters=num_iters)
    if method == "lut":
        return cast_rays_lut(grid_map, queries)
    raise ValueError(f"Unknown raycast method: {method!r}")
