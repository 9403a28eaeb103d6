"""Chained corrections through the mega step, as the JAX package's
``filter/mega.py``: one launch of ``csrc/mega_step.cu`` per correction.

The draws, the displacement form, the observation clipping and the pose
arithmetic run outside the kernel, vectorized over the K steps of a
chain. The random draws are taken before the chain, step by step, in the
classic step's order (u0, then the motion noise), so a mega chain and a
classic chain with one seed consume identical draws. No host
synchronization inside the chain.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from monte_carlo_localization_tpu_torch.config import MCLConfig
from monte_carlo_localization_tpu_torch.filter.core import MCLState, lut_query_kwargs
from monte_carlo_localization_tpu_torch.mapping.grid_map import GridMap
from monte_carlo_localization_tpu_torch.models.motion import reconstruct_velocity
from monte_carlo_localization_tpu_torch.models.sensor import SensorModel
from monte_carlo_localization_tpu_torch.ops.mega_step import NUM_SUMS, MegaStep


def mega_supported(grid_map: GridMap, cfg: MCLConfig) -> bool:
    """The mega step serves dense-LUT single maps on the analytic,
    systematic path (the JAX package's conditions)."""
    return (
        grid_map.occupancy.ndim == 2
        and grid_map.lut_row_map is None
        and cfg.sensor_model_mode == "analytic"
        and cfg.resample_method == "systematic"
        and not cfg.pallas_subbin
        and cfg.pallas_dedup_slots <= 0
    )


class MegaStepper:
    """Owns the :class:`MegaStep` of one map and beam set; the filter's
    ``step_many`` dispatches here when ``cfg.pallas_mega`` is on."""

    def __init__(
        self,
        grid_map: GridMap,
        beam_angles: np.ndarray,
        cfg: MCLConfig,
        num_particles: int,
        sensor: SensorModel,
    ):
        if grid_map.range_lut is None or grid_map.lut_row_map is not None:
            raise ValueError("the mega step needs the kernel-stride dense LUT attached")
        self.cfg = cfg
        self.sensor = sensor
        self.n = int(num_particles)
        self.grid_map = grid_map
        self.mega = MegaStep(
            grid_map.lut_theta_bins,
            np.asarray(beam_angles, np.float32),
            motion_dispersion=(
                cfg.motion_dispersion_x,
                cfg.motion_dispersion_y,
                cfg.motion_dispersion_theta,
            ),
            **lut_query_kwargs(grid_map, cfg),
        )

    def step_many(self, state: MCLState, actions, observed_m, u0=None, noise=None):
        """K chained corrections: ``actions`` (K, 3), ``observed_m`` (K, R),
        optional draws ``u0`` (K,) and ``noise`` (K, N, 3). Returns
        (state, poses (K, 3))."""
        dev = self.mega.device
        n = self.n
        if state.num_particles != n:
            raise ValueError(f"state has {state.num_particles} particles, the mega step {n}")
        actions = torch.as_tensor(actions, dtype=torch.float32, device=dev)
        observed_m = torch.as_tensor(observed_m, dtype=torch.float32, device=dev)
        k = actions.shape[0]
        if k == 0:
            return state, torch.zeros((0, 3), dtype=torch.float32, device=dev)
        gen = state.generator
        if u0 is None or noise is None:
            u0s, noises = [], []
            for _ in range(k):
                if u0 is None:
                    u0s.append(torch.rand((), generator=gen, device=dev))
                if noise is None:
                    noises.append(torch.randn((n, 3), generator=gen, dtype=torch.float32, device=dev))
            u0 = torch.stack(u0s) if u0 is None else u0
            noise = torch.stack(noises) if noise is None else noise
        u0 = torch.as_tensor(u0, dtype=torch.float32, device=dev)
        noise = torch.as_tensor(noise, dtype=torch.float32, device=dev).contiguous()

        # the displacement form after the dt heuristic, for all K at once
        if self.cfg.exact_dt_heuristic:
            dt, v, omega = reconstruct_velocity(actions)
            ds, dth = v * dt, omega * dt
            straight = (torch.abs(omega) < 1e-6).to(torch.float32)
        else:
            ds, dth = actions[:, 0], actions[:, 2]
            straight = (torch.abs(dth) < 1e-6).to(torch.float32)
        zeros = torch.zeros_like(u0)
        scalars = torch.stack([ds, dth, straight, u0, zeros, zeros, zeros, zeros], dim=1)
        m = float(self.sensor.max_range_px)
        obs = torch.clamp(self.sensor.to_pixel_index(observed_m).to(torch.float32), max=m)

        lut = self.grid_map.range_lut
        sums = torch.empty((k, NUM_SUMS), dtype=torch.float32, device=dev)
        # two ping-pong output pairs: a step's inputs are never its outputs,
        # and the caller's state is never written
        bufs = [
            (torch.empty((n, 3), dtype=torch.float32, device=dev),
             torch.empty(n, dtype=torch.float32, device=dev))
            for _ in range(min(k, 2))
        ]
        parts = state.particles.contiguous()
        logw = state.log_weights.contiguous()
        for i in range(k):
            out_p, out_w = bufs[i % 2]
            self.mega(lut, parts, logw, noise[i], obs[i], scalars[i], out_p, out_w, sums[i])
            parts, logw = out_p, out_w

        z = sums[:, 4]
        poses = torch.stack(
            [sums[:, 0] / z, sums[:, 1] / z, torch.atan2(sums[:, 2], sums[:, 3])], dim=1
        )
        log_quality = sums[-1, 5] + torch.log(z[-1]) - math.log(n)
        return MCLState(particles=parts, log_weights=logw, generator=gen,
                        log_quality=log_quality), poses
