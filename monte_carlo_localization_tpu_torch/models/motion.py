"""Stochastic arc motion model, as in the JAX package's
``models/motion.py``: the reference's dt/velocity reconstruction from the
displacement action, exact arc integration per particle in the
sin-half-angle chord form, and iid Gaussian noise per axis.

On a card, motion is one launch of ``csrc/motion.cu`` (``ops/motion.py``
:data:`MOTION_KERNEL`), bit for bit the PyTorch code below, which is its
plain version and serves the CPU."""

from __future__ import annotations

import torch

from monte_carlo_localization_tpu_torch.ops.motion import MOTION_KERNEL
from monte_carlo_localization_tpu_torch.utils.geometry import div, normalize_angle


def gather_rows(particles: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """Rows ``indices`` (M,) of particles (N, 3), or each member's rows
    ``indices`` (F, M) of a fleet's (F, N, 3)."""
    if particles.dim() == 3:
        return torch.gather(particles, 1, indices.long()[..., None].expand(-1, -1, 3))
    return particles[indices]


def reconstruct_velocity(action: torch.Tensor):
    """(dt, v, omega) from action [d_forward, 0, d_theta]."""
    fwd = action[..., 0]
    dth = action[..., 2]
    afwd = torch.abs(fwd)

    dt_moving = torch.where(afwd < 0.1, div(afwd, 1.0), div(afwd, 5.0))
    dt_moving = torch.clamp(dt_moving, 0.001, 0.1)
    has_fwd = afwd > 0.001
    dt = torch.where(has_fwd, dt_moving, 0.01)
    v = torch.where(has_fwd, fwd / dt, 0.0)
    omega = torch.where(torch.abs(dth) > 0.001, dth / dt, 0.0)
    return dt, v, omega


def motion_model(
    particles: torch.Tensor,
    action: torch.Tensor,
    dispersion_x: float = 0.05,
    dispersion_y: float = 0.025,
    dispersion_theta: float = 0.25,
    exact_dt_heuristic: bool = True,
    generator: torch.Generator | None = None,
    noise: torch.Tensor | None = None,
    indices: torch.Tensor | None = None,
) -> torch.Tensor:
    """Propagate particles (N, 3) by one action (3,), adding Gaussian noise;
    or a fleet's (F, N, 3) by per-member actions (F, 3).

    ``indices`` (M,) or (F, M), the resampler's source rows, moves
    ``gather_rows(particles, indices)`` instead (fused into the kernel's
    launch on a card, whose wrapper takes contiguous float32 particles
    and raises ``ValueError`` on anything else). ``noise`` is an
    optional draw of N(0, 1) shaped like the moved rows (the tests feed
    the JAX package's own draws); without it the noise comes from
    ``generator``. With
    ``exact_dt_heuristic=False`` the displacements are taken from the
    action directly.
    """
    if particles.is_cuda:  # the kernel's wrapper refuses what it does not take
        return MOTION_KERNEL(particles, action, noise,
                             (dispersion_x, dispersion_y, dispersion_theta),
                             exact_dt_heuristic, indices, generator)
    MOTION_KERNEL.plain_launch_count += 1
    if indices is not None:
        particles = gather_rows(particles, indices)
    return motion_model_plain(particles, action, dispersion_x, dispersion_y, dispersion_theta,
                              exact_dt_heuristic, generator, noise)


def motion_model_plain(
    particles: torch.Tensor,
    action: torch.Tensor,
    dispersion_x: float = 0.05,
    dispersion_y: float = 0.025,
    dispersion_theta: float = 0.25,
    exact_dt_heuristic: bool = True,
    generator: torch.Generator | None = None,
    noise: torch.Tensor | None = None,
) -> torch.Tensor:
    """:func:`motion_model` of the rows as given, in PyTorch ops on any
    device: the kernel's plain version."""
    x = particles[..., 0]
    y = particles[..., 1]
    theta = particles[..., 2]
    act = action[..., None, :]  # broadcasts over the particle axis

    if exact_dt_heuristic:
        dt, v, omega = reconstruct_velocity(act)
        ds = v * dt
        dtheta = omega * dt
        omega_for_branch = omega
    else:
        ds = act[..., 0]
        dtheta = act[..., 2]
        omega_for_branch = dtheta

    x_straight = x + ds * torch.cos(theta)
    y_straight = y + ds * torch.sin(theta)

    # radius*(sin(t+d)-sin(t)) written as the chord 2 sin(d/2)/d * ds along
    # t + d/2: the same value, without the f32 cancellation at small d
    safe_dtheta = torch.where(torch.abs(dtheta) < 1e-12, 1.0, dtheta)
    chord = ds * (2.0 * torch.sin(dtheta / 2.0) / safe_dtheta)
    mid = theta + dtheta / 2.0
    x_arc = x + chord * torch.cos(mid)
    y_arc = y + chord * torch.sin(mid)

    straight = torch.abs(omega_for_branch) < 1e-6
    new_x = torch.where(straight, x_straight, x_arc)
    new_y = torch.where(straight, y_straight, y_arc)
    new_theta = torch.where(straight, theta, theta + dtheta)

    if noise is None:
        noise = torch.randn(
            particles.shape, generator=generator, dtype=particles.dtype,
            device=particles.device,
        )
    elif noise.shape != particles.shape:
        raise ValueError(f"noise shape {tuple(noise.shape)} != {tuple(particles.shape)}")
    new_x = new_x + noise[..., 0] * dispersion_x
    new_y = new_y + noise[..., 1] * dispersion_y
    new_theta = normalize_angle(new_theta + noise[..., 2] * dispersion_theta)

    return torch.stack([new_x, new_y, new_theta], dim=-1)
