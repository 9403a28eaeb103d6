"""Stochastic arc motion model, as in the JAX package's
``models/motion.py``: the reference's dt/velocity reconstruction from the
displacement action, exact arc integration per particle in the
sin-half-angle chord form, and iid Gaussian noise per axis."""

from __future__ import annotations

import torch

from monte_carlo_localization_tpu_torch.utils.geometry import normalize_angle


def reconstruct_velocity(action: torch.Tensor):
    """(dt, v, omega) from action [d_forward, 0, d_theta]."""
    fwd = action[..., 0]
    dth = action[..., 2]
    afwd = torch.abs(fwd)

    dt_moving = torch.where(afwd < 0.1, afwd / 1.0, afwd / 5.0)
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
) -> torch.Tensor:
    """Propagate particles (N, 3) by one action (3,), adding Gaussian noise;
    or a fleet's (F, N, 3) by per-member actions (F, 3).

    ``noise`` is an optional draw of N(0, 1) shaped like ``particles``
    (the tests feed the JAX package's own draws); without it the noise
    comes from ``generator``. With ``exact_dt_heuristic=False`` the
    displacements are taken from the action directly.
    """
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
