"""The MCL correction in PyTorch, as in the JAX package's
``filter/core.py``:

    systematic resample -> motion -> fused LUT likelihood
    -> log-quality and max-shift normalization -> weighted-mean pose

PyTorch runs eagerly, so a step is a sequence of device launches with no
host synchronization; :meth:`ParticleFilter.step_many` chains K of them.
Random draws come from a ``torch.Generator`` carried in the state. The
streams differ from jax.random's, so :func:`mcl_step` also takes the
resample offset ``u0`` and the motion noise from outside (the parity
tests feed the JAX package's own draws).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import torch

from monte_carlo_localization_tpu_torch.config import MCLConfig, resolve_raycast_method
from monte_carlo_localization_tpu_torch.filter.init import initialize_global, initialize_pose
from monte_carlo_localization_tpu_torch.mapping.grid_map import GridMap
from monte_carlo_localization_tpu_torch.mapping.range_lut import lut_dtype
from monte_carlo_localization_tpu_torch.models.motion import motion_model
from monte_carlo_localization_tpu_torch.models.sensor import SensorModel
from monte_carlo_localization_tpu_torch.ops.lut_query import (
    LUTQuery,
    required_row_stride,
    suggest_theta_bins,
)
from monte_carlo_localization_tpu_torch.ops.resample import resample_indices


@dataclass(frozen=True)
class MCLState:
    """Filter state carried between steps. ``generator`` is advanced in
    place by every draw, so a state's successor shares it."""

    particles: torch.Tensor  # (N, 3) [x, y, theta]
    log_weights: torch.Tensor  # (N,) unnormalized logits
    generator: torch.Generator
    # log mean measurement likelihood of the latest correction, taken
    # before the max-shift (Augmented MCL's w_avg); 0 before the first
    log_quality: torch.Tensor | None = field(default=None)

    def __post_init__(self):
        if self.log_quality is None:
            object.__setattr__(
                self, "log_quality",
                torch.zeros((), dtype=torch.float32, device=self.particles.device),
            )

    @property
    def num_particles(self) -> int:
        return self.particles.shape[0]

    @classmethod
    def from_numpy(
        cls, particles, log_weights, seed: int, device: torch.device | str = "cpu"
    ) -> "MCLState":
        """A state from host arrays (e.g. the JAX filter's particles and
        log weights) with a fresh generator seeded by ``seed``."""
        gen = torch.Generator(device=device)
        gen.manual_seed(int(seed))
        return cls(
            particles=torch.tensor(np.asarray(particles, np.float32), device=device),
            log_weights=torch.tensor(np.asarray(log_weights, np.float32), device=device),
            generator=gen,
        )

    def to_numpy(self) -> tuple[np.ndarray, np.ndarray]:
        """(particles (N, 3), log_weights (N,)) as float32 numpy arrays."""
        return self.particles.cpu().numpy(), self.log_weights.cpu().numpy()


def expected_pose(particles: torch.Tensor, log_weights: torch.Tensor) -> torch.Tensor:
    """Weighted mean x/y and circular-mean heading."""
    w = torch.softmax(log_weights, dim=0)
    x = torch.sum(w * particles[:, 0])
    y = torch.sum(w * particles[:, 1])
    s = torch.sum(w * torch.sin(particles[:, 2]))
    c = torch.sum(w * torch.cos(particles[:, 2]))
    return torch.stack([x, y, torch.atan2(s, c)])


def mcl_step(
    state: MCLState,
    action: torch.Tensor,
    obs_px: torch.Tensor,
    likelihood_fn,
    *,
    resample_method: str = "systematic",
    motion_dispersion: tuple[float, float, float] = (0.05, 0.025, 0.25),
    exact_dt_heuristic: bool = True,
    u0=None,
    noise: torch.Tensor | None = None,
) -> tuple[MCLState, torch.Tensor]:
    """One MCL correction. Returns (new_state, inferred_pose).

    The reference's phase order: resample from the old weights, then
    motion, then the likelihood ``likelihood_fn(particles, obs_px)`` of
    the (R,) observed ranges in pixels; the pose comes from the new
    particles and weights. ``u0`` (systematic resampling offset) and
    ``noise`` ((N, 3) N(0, 1) motion noise) replace the generator's draws
    when given.
    """
    gen = state.generator
    idx = resample_indices(
        state.log_weights, method=resample_method, generator=gen, u0=u0
    )
    proposal = state.particles[idx]
    proposal = motion_model(
        proposal,
        action,
        dispersion_x=motion_dispersion[0],
        dispersion_y=motion_dispersion[1],
        dispersion_theta=motion_dispersion[2],
        exact_dt_heuristic=exact_dt_heuristic,
        generator=gen,
        noise=noise,
    )
    log_w = likelihood_fn(proposal, obs_px)
    # log(mean_i w_i) before the shift: linear space underflows at 1080 beams
    log_quality = torch.logsumexp(log_w, dim=0) - math.log(log_w.shape[0])
    log_w = log_w - torch.max(log_w)
    new_state = MCLState(
        particles=proposal, log_weights=log_w, generator=gen,
        log_quality=log_quality.to(torch.float32),
    )
    return new_state, expected_pose(proposal, log_w)


def _reject_unported(cfg: MCLConfig) -> None:
    """Raise for JAX-package options whose kernels are not ported yet."""
    unported = {
        "pallas_subbin (kernel K3)": cfg.pallas_subbin,
        "pallas_dedup_slots (kernels K4/K5)": cfg.pallas_dedup_slots > 0,
        "pallas_dedup_matmul (kernel K5)": cfg.pallas_dedup_matmul,
        "pallas_mega (kernel K6)": cfg.pallas_mega,
    }
    on = [name for name, set_ in unported.items() if set_]
    if on:
        raise NotImplementedError(
            f"{', '.join(on)} not ported to PyTorch yet; see ROADMAP.md"
        )


def build_lut_likelihood(
    grid_map: GridMap, beam_angles: np.ndarray, cfg: MCLConfig
) -> tuple[GridMap, LUTQuery]:
    """Attach the LUT the fused likelihood reads (dense, or row-compacted
    past ``MCL_LUT_DENSE_MAX``) and build the query for this beam set.
    Returns (grid_map_with_lut, query). An unsupported beam geometry
    raises."""
    dtype = lut_dtype(grid_map.max_range_px)
    beams = np.asarray(beam_angles, np.float32)
    t = suggest_theta_bins(beams)
    stride = required_row_stride(t, beams, itemsize=dtype.itemsize)
    grid_map = grid_map.with_kernel_lut(t, stride, dtype.itemsize)
    query = LUTQuery(
        grid_map.lut_theta_bins,
        beams,
        height=grid_map.height,
        width=grid_map.width,
        resolution=grid_map.resolution,
        origin_x=grid_map.origin_x,
        origin_y=grid_map.origin_y,
        max_range_px=grid_map.max_range_px,
        row_stride=grid_map.row_stride,
        z_hit=cfg.z_hit,
        z_short=cfg.z_short,
        z_max=cfg.z_max,
        z_rand=cfg.z_rand,
        sigma_hit=cfg.sigma_hit,
        inv_squash=cfg.inv_squash_factor,
        lut_dtype=dtype,
        device=grid_map.device,
    )
    return grid_map, query


class ParticleFilter:
    """Single-filter facade: owns the map, config, sensor model and the
    fused likelihood. Everything lives on ``device`` (default: the map's).
    """

    def __init__(
        self,
        grid_map: GridMap,
        config: MCLConfig | None = None,
        beam_angles: np.ndarray | None = None,
        device: torch.device | str | None = None,
    ):
        cfg = config or MCLConfig()
        cfg = cfg.replace(raycast_method=resolve_raycast_method(cfg.raycast_method))
        if cfg.resample_method not in ("systematic", "multinomial"):
            raise ValueError(f"Unknown resample method: {cfg.resample_method!r}")
        if cfg.sensor_model_mode not in ("analytic", "table"):
            raise ValueError(f"Unknown sensor model mode: {cfg.sensor_model_mode!r}")
        if cfg.reinit_mode not in ("reinit", "inject"):
            raise ValueError(f"Unknown reinit mode: {cfg.reinit_mode!r}")
        _reject_unported(cfg)
        self.config = cfg
        self.device = torch.device(device) if device is not None else grid_map.device
        self.grid_map = grid_map.to(self.device)
        self.sensor = SensorModel.create(
            max_range_px=grid_map.max_range_px,
            resolution=grid_map.resolution,
            z_hit=cfg.z_hit,
            z_short=cfg.z_short,
            z_max=cfg.z_max,
            z_rand=cfg.z_rand,
            sigma_hit=cfg.sigma_hit,
            squash_factor=cfg.squash_factor,
            device=self.device,
        )
        self.beam_angles: torch.Tensor | None = None
        self.likelihood: LUTQuery | None = None
        if beam_angles is not None:
            self.set_beam_angles(beam_angles)

    def set_beam_angles(self, beam_angles: np.ndarray) -> None:
        """Set the (downsampled) beam angles; attaches the LUT matched to
        this beam set and rebuilds the likelihood query."""
        beams = np.asarray(beam_angles, np.float32)
        self.grid_map, self.likelihood = build_lut_likelihood(
            self.grid_map, beams, self.config
        )
        self.beam_angles = torch.as_tensor(beams, device=self.device)

    def _generator(self, seed: int | None) -> torch.Generator:
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.config.seed if seed is None else int(seed))
        return gen

    def init_global(self, seed: int | None = None) -> MCLState:
        gen = self._generator(seed)
        particles, log_w = initialize_global(gen, self.grid_map, self.config.max_particles)
        return MCLState(particles=particles, log_weights=log_w, generator=gen)

    def init_pose(self, pose, seed: int | None = None) -> MCLState:
        gen = self._generator(seed)
        particles, log_w = initialize_pose(
            gen, pose, self.config.max_particles, device=self.device
        )
        return MCLState(particles=particles, log_weights=log_w, generator=gen)

    def _likelihood_fn(self, particles: torch.Tensor, obs_px: torch.Tensor) -> torch.Tensor:
        gm = self.grid_map
        return self.likelihood(gm.range_lut, particles, obs_px, row_map=gm.lut_row_map)

    def _obs_px(self, observed_m) -> torch.Tensor:
        obs = torch.as_tensor(observed_m, dtype=torch.float32, device=self.device)
        return self.sensor.to_pixel_index(obs).to(torch.float32)

    def _step(self, state, action, obs_px, u0, noise):
        cfg = self.config
        return mcl_step(
            state, action, obs_px, self._likelihood_fn,
            resample_method=cfg.resample_method,
            motion_dispersion=(
                cfg.motion_dispersion_x,
                cfg.motion_dispersion_y,
                cfg.motion_dispersion_theta,
            ),
            exact_dt_heuristic=cfg.exact_dt_heuristic,
            u0=u0,
            noise=noise,
        )

    def _require_beams(self) -> None:
        if self.likelihood is None:
            raise RuntimeError("beam_angles not set — call set_beam_angles() first")

    def step(
        self, state: MCLState, action, observed_m, u0=None, noise=None
    ) -> tuple[MCLState, torch.Tensor]:
        """One MCL correction, launched without waiting for the device.
        Optional draws: ``u0`` (scalar) and ``noise`` (N, 3)."""
        self._require_beams()
        action = torch.as_tensor(action, dtype=torch.float32, device=self.device)
        if noise is not None:
            noise = torch.as_tensor(noise, dtype=torch.float32, device=self.device)
        return self._step(state, action, self._obs_px(observed_m), u0, noise)

    def step_many(
        self, state: MCLState, actions, observed_m, u0=None, noise=None
    ) -> tuple[MCLState, torch.Tensor]:
        """K sequential corrections with no host synchronization between
        them: ``actions`` (K, 3), ``observed_m`` (K, R). Optional draws:
        ``u0`` (K,) and ``noise`` (K, N, 3). Returns (state, poses (K, 3))."""
        self._require_beams()
        actions = torch.as_tensor(actions, dtype=torch.float32, device=self.device)
        obs_px = self._obs_px(observed_m)
        k = actions.shape[0]
        if obs_px.shape[0] != k:
            raise ValueError(f"{k} actions but {obs_px.shape[0]} scans")
        if u0 is not None:
            u0 = torch.as_tensor(u0, dtype=torch.float32, device=self.device)
            if u0.shape != (k,):
                raise ValueError(f"u0 shape {tuple(u0.shape)} != ({k},)")
        if noise is not None:
            noise = torch.as_tensor(noise, dtype=torch.float32, device=self.device)
            if noise.shape != (k, state.num_particles, 3):
                raise ValueError(
                    f"noise shape {tuple(noise.shape)} != ({k}, {state.num_particles}, 3)"
                )
        poses = []
        for i in range(k):
            state, pose = self._step(
                state, actions[i], obs_px[i],
                None if u0 is None else u0[i],
                None if noise is None else noise[i],
            )
            poses.append(pose)
        return state, torch.stack(poses)

    def log_quality(self, state: MCLState) -> float:
        """log mean (squashed) measurement likelihood of the latest
        correction, before the max-shift: Augmented MCL's w_avg."""
        return float(state.log_quality)
