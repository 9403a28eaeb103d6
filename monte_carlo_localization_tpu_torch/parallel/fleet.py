"""Fleet filtering: F independent MCL filters (e.g. 64 cars x 4000
particles) stepped as one batch, as the JAX package's
``parallel/fleet.py`` ``FleetFilter`` does on its ``lut_pallas`` path
without a mesh.

Every phase of a correction carries a leading member axis, so a fleet
correction issues the launches of one filter's, whatever F is: the
resampler scatters all members into one buffer, motion and the pose
broadcast over members, and one launch of the fleet LUT kernel
(``csrc/lut_likelihood.cu``) serves all F * N particles, each member
reading its own scan. Members may run on different maps: ``stack_maps``
batches the maps, the LUT holds one tight block per map, and
``map_assignment`` lets many members share a map's block (64 cars over 4
circuits store 4 blocks, not 64).

The ``sphere``, ``dda`` and ``lut`` methods (``filter/core.py``
``sensor_update_px``) run over the member axis too, on a shared map or
on a stacked map of one map per member (the JAX fleet vmaps
``mcl_step`` over both); ``lut`` reads a stacked dense LUT
(``GridMap.with_range_lut`` of the batched map). ``map_assignment``
needs ``lut_pallas``, as in the JAX fleet.

``MCLConfig.pallas_mega`` serves a single filter: a fleet ignores it and
runs the classic fleet step, as the JAX fleet does (it never reads the
flag), so one config file can drive both.

Not ported: a mesh or particle axis (torch.distributed, ROADMAP.md queue
1, item 8). It raises; the filter never runs another path.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Sequence

import numpy as np
import torch

from monte_carlo_localization_tpu_torch.config import MCLConfig, resolve_raycast_method
from monte_carlo_localization_tpu_torch.filter.core import (
    build_lut_likelihood,
    correct,
    sensor_update_px,
)
from monte_carlo_localization_tpu_torch.filter.init import initialize_pose
from monte_carlo_localization_tpu_torch.mapping.grid_map import OCC_OCCUPIED, GridMap
from monte_carlo_localization_tpu_torch.models.sensor import SensorModel
from monte_carlo_localization_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device, upload


@dataclass(frozen=True)
class FleetState:
    """Batched filter state; the leading axis is the fleet member.
    ``generator`` is advanced in place by every draw."""

    particles: torch.Tensor  # (F, N, 3)
    log_weights: torch.Tensor  # (F, N)
    generator: torch.Generator
    # per-member log mean likelihood of the latest correction (0 before)
    log_quality: torch.Tensor | None = field(default=None)

    def __post_init__(self):
        if self.log_quality is None:
            object.__setattr__(
                self, "log_quality",
                torch.zeros(self.particles.shape[0], dtype=torch.float32,
                            device=self.particles.device),
            )

    @property
    def fleet_size(self) -> int:
        return self.particles.shape[0]

    @classmethod
    def from_numpy(
        cls, particles, log_weights, seed: int,
        device: torch.device | str = DEFAULT_DEVICE,
    ) -> "FleetState":
        """A state from host arrays (e.g. the JAX fleet's) with a fresh
        generator seeded by ``seed``."""
        device = resolve_device(device)
        gen = torch.Generator(device=device)
        gen.manual_seed(int(seed))
        return cls(
            particles=torch.tensor(np.asarray(particles, np.float32), device=device),
            log_weights=torch.tensor(np.asarray(log_weights, np.float32), device=device),
            generator=gen,
        )

    def to_numpy(self) -> tuple[np.ndarray, np.ndarray]:
        """(particles (F, N, 3), log_weights (F, N)) as float32 numpy arrays."""
        return self.particles.cpu().numpy(), self.log_weights.cpu().numpy()


def stack_maps(maps: Sequence[GridMap]) -> GridMap:
    """Stack maps into one batched GridMap (JAX ``stack_maps``).

    Grids are padded bottom/right to the common shape: occupancy pads as
    occupied and clearance as 0, so padded space behaves like the map
    border. Free cells pad by repeating the first; each map samples under
    its own ``num_free``. ``member_dims`` keeps the true shapes, so the
    LUT can hold tight blocks. The maps must share resolution and
    max_range_px."""
    if not maps:
        raise ValueError("need at least one map")
    res, mrp = maps[0].resolution, maps[0].max_range_px
    for m in maps:
        if m.is_batched:
            raise ValueError(f"{m.name} is already batched")
        if abs(m.resolution - res) > 1e-9 or m.max_range_px != mrp:
            raise ValueError(
                "fleet maps must share resolution and max_range_px "
                f"({m.name}: res {m.resolution} vs {res}, max_range_px "
                f"{m.max_range_px} vs {mrp})"
            )
    h = max(m.height for m in maps)
    w = max(m.width for m in maps)
    k = max(m.free_cells.shape[0] for m in maps)

    def pad(a, fill):
        a = a.cpu().numpy()
        out = np.full((h, w), fill, dtype=a.dtype)
        out[: a.shape[0], : a.shape[1]] = a
        return out

    free_cells = np.zeros((len(maps), k, 2), np.int32)
    for i, m in enumerate(maps):
        fc = m.free_cells.cpu().numpy()
        free_cells[i, : fc.shape[0]] = fc
        free_cells[i, fc.shape[0]:] = fc[0]
    return GridMap.from_numpy(
        occupancy=np.stack([pad(m.occupancy, OCC_OCCUPIED) for m in maps]),
        free_cells=free_cells,
        num_free=np.array([m.num_free for m in maps], np.int32),
        clearance=np.stack([pad(m.clearance, 0.0) for m in maps]),
        origin_x=np.array([m.origin_x for m in maps], np.float32),
        origin_y=np.array([m.origin_y for m in maps], np.float32),
        origin_yaw=np.array([m.origin_yaw for m in maps], np.float32),
        resolution=res,
        max_range_px=mrp,
        max_range_meters=maps[0].max_range_meters,
        name="fleet:" + ",".join(m.name for m in maps),
        member_dims=np.array([[m.height, m.width] for m in maps], np.int32),
        device=maps[0].device,
    )


def is_batched_map(grid_map: GridMap) -> bool:
    return grid_map.is_batched


class FleetFilter:
    """F independent filters stepped as one batch over one shared map or a
    stacked map (``stack_maps``), everything on ``device`` (default: the
    map's).

    ``map_assignment`` (F,) int maps each member to a map of a stacked
    ``grid_map``, so members share its LUT block. Without it a stacked
    map must hold one map per member."""

    def __init__(
        self,
        grid_map: GridMap,
        fleet_size: int,
        config: MCLConfig | None = None,
        beam_angles: np.ndarray | None = None,
        mesh=None,
        particle_axis: str | None = None,
        map_assignment: np.ndarray | None = None,
        device: torch.device | str | None = None,
    ):
        if mesh is not None or particle_axis is not None:
            raise NotImplementedError(
                "FleetFilter over a device mesh (mesh / particle_axis) is not "
                "ported yet; see ROADMAP.md queue 1, item 8 (torch.distributed)"
            )
        cfg = config or MCLConfig()
        cfg = cfg.replace(raycast_method=resolve_raycast_method(cfg.raycast_method))
        if cfg.resample_method not in ("systematic", "multinomial"):
            raise ValueError(f"Unknown resample method: {cfg.resample_method!r}")
        if cfg.sensor_model_mode not in ("analytic", "table"):
            raise ValueError(f"Unknown sensor model mode: {cfg.sensor_model_mode!r}")
        if fleet_size < 1:
            raise ValueError(f"fleet_size {fleet_size} < 1")
        self.map_assignment = None
        if map_assignment is not None:
            asg = np.asarray(map_assignment, np.int32)
            if cfg.raycast_method != "lut_pallas" or not grid_map.is_batched:
                raise ValueError(
                    "map_assignment requires raycast_method='lut_pallas' "
                    "and a stacked (batched) grid_map"
                )
            if asg.shape != (fleet_size,):
                raise ValueError(f"map_assignment must be ({fleet_size},), got {asg.shape}")
            if asg.min() < 0 or asg.max() >= grid_map.num_maps:
                raise ValueError(f"map_assignment values must be in [0, {grid_map.num_maps})")
            self.map_assignment = asg
        elif grid_map.is_batched and grid_map.num_maps != fleet_size:
            raise ValueError(
                f"stacked grid_map has {grid_map.num_maps} maps for "
                f"fleet_size={fleet_size}; pass map_assignment to share maps "
                "between members"
            )
        self.config = cfg
        self.fleet_size = int(fleet_size)
        self.device = torch.device(device) if device is not None else grid_map.device
        self.map = grid_map.to(self.device)
        if cfg.raycast_method == "lut":
            self.map = self.map.with_range_lut(cfg.lut_theta_bins)
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
        # each member's map (None on a shared map)
        self._member_map = None
        if grid_map.is_batched:
            members = self.map_assignment if self.map_assignment is not None else np.arange(fleet_size)
            self._member_map = torch.as_tensor(members, dtype=torch.int32, device=self.device)
        self.beam_angles: torch.Tensor | None = None
        self.likelihood = None
        if beam_angles is not None:
            self.set_beam_angles(beam_angles)

    def set_beam_angles(self, beam_angles: np.ndarray) -> None:
        """Set the beam angles; under ``lut_pallas`` this attaches the LUT
        for this beam set (tight per-map blocks on a stacked map) and
        builds the fleet query."""
        beams = np.asarray(beam_angles, np.float32)
        if self.config.raycast_method == "lut_pallas":
            self.map, self.likelihood = build_lut_likelihood(
                self.map, beams, self.config, num_members=self.fleet_size
            )
        self.beam_angles = torch.as_tensor(beams, device=self.device)

    def _generator(self, seed: int | None) -> torch.Generator:
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.config.seed if seed is None else int(seed))
        return gen

    def init_global(self, seed: int | None = None) -> FleetState:
        """Each member uniform over its own map's free cells (under that
        map's ``num_free``), headings uniform in [0, 2pi)."""
        gen = self._generator(seed)
        gm, f, n = self.map, self.fleet_size, self.config.max_particles
        dev = self.device
        if gm.is_batched:
            maps = self._member_map.long()
            num_free = gm.num_free.to(torch.int64)[maps]
            # 62 random bits mod the count: a bias below 2^-40
            cell = torch.randint(0, 1 << 62, (f, n), generator=gen, device=dev) % num_free[:, None]
            cells = gm.free_cells[maps[:, None], cell]
            ox, oy = gm.origin_x[maps][:, None], gm.origin_y[maps][:, None]
        else:
            cell = torch.randint(0, gm.num_free, (f, n), generator=gen, device=dev)
            cells = gm.free_cells[cell]
            ox, oy = gm.origin_x, gm.origin_y
        x = cells[..., 1].to(torch.float32) * gm.resolution + ox
        y = cells[..., 0].to(torch.float32) * gm.resolution + oy
        theta = torch.rand((f, n), generator=gen, device=dev) * (2.0 * math.pi)
        particles = torch.stack([x, y, theta], dim=-1)
        return FleetState(particles=particles, log_weights=torch.zeros((f, n), device=dev),
                          generator=gen)

    def init_pose(self, poses, seed: int | None = None) -> FleetState:
        """A Gaussian cloud around each member's pose; ``poses`` (F, 3)."""
        poses = torch.as_tensor(poses, dtype=torch.float32, device=self.device)
        if tuple(poses.shape) != (self.fleet_size, 3):
            raise ValueError(f"poses shape {tuple(poses.shape)} != ({self.fleet_size}, 3)")
        gen = self._generator(seed)
        particles, log_w = initialize_pose(
            gen, poses, self.config.max_particles, device=self.device
        )
        return FleetState(particles=particles, log_weights=log_w, generator=gen)

    def _likelihood_fn(self, particles: torch.Tensor, obs_px: torch.Tensor) -> torch.Tensor:
        gm, (f, n), cfg = self.map, particles.shape[:2], self.config
        if self.likelihood is None:
            return sensor_update_px(
                particles, obs_px, self.beam_angles, gm, self.sensor,
                raycast_method=cfg.raycast_method, sphere_march_iters=cfg.sphere_march_iters,
                sensor_mode=cfg.sensor_model_mode,
            )
        fleet = {}
        if gm.is_batched:
            fleet = dict(
                origins=(gm.origin_x, gm.origin_y), map_of=self._member_map,
                dims=gm.member_dims, lut_bases=gm.lut_member_base,
                row_map_bases=gm.lut_row_map_base,
            )
        logw = self.likelihood(
            gm.range_lut, particles.reshape(f * n, 3), obs_px, row_map=gm.lut_row_map, **fleet
        )
        return logw.view(f, n)

    def _require_beams(self) -> None:
        if self.beam_angles is None:
            raise RuntimeError("beam_angles not set — call set_beam_angles() first")

    def _as(self, x, shape: tuple, name: str) -> torch.Tensor | None:
        if x is None:
            return None
        x = upload(x, self.device)
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} shape {tuple(x.shape)} != {shape}")
        return x

    def _step(self, state, actions, obs_px, u0, noise):
        cfg = self.config
        particles, log_w, log_quality, poses = correct(
            state.particles, state.log_weights, state.generator, actions, obs_px,
            self._likelihood_fn,
            resample_method=cfg.resample_method,
            motion_dispersion=(
                cfg.motion_dispersion_x, cfg.motion_dispersion_y, cfg.motion_dispersion_theta,
            ),
            exact_dt_heuristic=cfg.exact_dt_heuristic,
            u0=u0,
            noise=noise,
        )
        new_state = FleetState(particles=particles, log_weights=log_w,
                               generator=state.generator, log_quality=log_quality)
        return new_state, poses

    def step(self, state: FleetState, actions, scans, u0=None, noise=None):
        """One correction of every member, launched without waiting for the
        device (host inputs go up through pinned memory): ``actions``
        (F, 3), ``scans`` (F, R) in meters. Optional
        draws: ``u0`` (F,) and ``noise`` (F, N, 3). Returns (state, poses
        (F, 3))."""
        self._require_beams()
        f, n = self.fleet_size, state.particles.shape[1]
        actions = self._as(actions, (f, 3), "actions")
        scans = upload(scans, self.device)
        obs_px = self.sensor.to_pixel_index(scans).to(torch.float32)
        return self._step(state, actions, obs_px, self._as(u0, (f,), "u0"),
                          self._as(noise, (f, n, 3), "noise"))

    def step_many(self, state: FleetState, actions, scans, u0=None, noise=None):
        """K chained corrections with no host synchronization between them:
        ``actions`` (K, F, 3), ``scans`` (K, F, R). Optional draws: ``u0``
        (K, F) and ``noise`` (K, F, N, 3). Returns (state, poses (K, F, 3))."""
        self._require_beams()
        f, n = self.fleet_size, state.particles.shape[1]
        actions = upload(actions, self.device)
        k = actions.shape[0]
        actions = self._as(actions, (k, f, 3), "actions")
        scans = upload(scans, self.device)
        if scans.shape[:2] != (k, f):
            raise ValueError(f"scans shape {tuple(scans.shape)} != ({k}, {f}, R)")
        obs_px = self.sensor.to_pixel_index(scans).to(torch.float32)
        u0 = self._as(u0, (k, f), "u0")
        noise = self._as(noise, (k, f, n, 3), "noise")
        poses = []
        for i in range(k):
            state, p = self._step(
                state, actions[i], obs_px[i],
                None if u0 is None else u0[i], None if noise is None else noise[i],
            )
            poses.append(p)
        return state, torch.stack(poses)
