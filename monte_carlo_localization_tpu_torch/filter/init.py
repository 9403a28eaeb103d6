"""Particle initialization, as in the JAX package's ``filter/init.py``:
uniform over free space (a free cell, then a heading in [0, 2pi)), or a
Gaussian cloud around a pose (sigma 0.5 m in x/y, 0.4 rad in heading)."""

from __future__ import annotations

import math

import torch

from monte_carlo_localization_tpu_torch.mapping.grid_map import GridMap
from monte_carlo_localization_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device
from monte_carlo_localization_tpu_torch.utils.geometry import normalize_angle


def initialize_global(
    generator: torch.Generator,
    grid_map: GridMap,
    num_particles: int,
    dtype=torch.float32,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Uniform particles over ``free_cells[:num_free]``. Returns
    (particles (N, 3), log_weights (N,)) on the map's device."""
    dev = grid_map.device
    cell_idx = torch.randint(
        0, grid_map.num_free, (num_particles,), generator=generator, device=dev
    )
    cells = grid_map.free_cells[cell_idx]  # (N, 2) row, col
    x = cells[:, 1].to(dtype) * grid_map.resolution + grid_map.origin_x
    y = cells[:, 0].to(dtype) * grid_map.resolution + grid_map.origin_y
    theta = torch.rand(num_particles, generator=generator, dtype=dtype, device=dev)
    theta = theta * (2.0 * math.pi)
    particles = torch.stack([x, y, theta], dim=1)
    return particles, torch.zeros(num_particles, dtype=dtype, device=dev)


def initialize_pose(
    generator: torch.Generator,
    pose,
    num_particles: int,
    sigma_xy: float = 0.5,
    sigma_theta: float = 0.4,
    dtype=torch.float32,
    device: torch.device | str = DEFAULT_DEVICE,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Gaussian cloud around a seed pose (3,), or one cloud per pose of an
    (F, 3) fleet. Returns (particles (..., N, 3), log_weights (..., N))."""
    device = resolve_device(device)
    pose = torch.as_tensor(pose, dtype=dtype, device=device)
    shape = (*pose.shape[:-1], num_particles)
    noise = torch.randn((*shape, 3), generator=generator, dtype=dtype, device=device)
    pose = pose[..., None, :]
    particles = torch.stack(
        [
            pose[..., 0] + noise[..., 0] * sigma_xy,
            pose[..., 1] + noise[..., 1] * sigma_xy,
            normalize_angle(pose[..., 2] + noise[..., 2] * sigma_theta),
        ],
        dim=-1,
    )
    return particles, torch.zeros(shape, dtype=dtype, device=device)
