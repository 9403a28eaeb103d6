"""Fleet filtering: F independent MCL filters (e.g. 64 cars x 4000
particles) stepped as one batch, as the JAX package's
``parallel/fleet.py`` ``FleetFilter`` does, on one process or over the
processes of a mesh.

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

Over a ``DeviceMesh`` (``mesh=``, ``fleet_axis=``) the members are
block-split over the fleet axis's processes: each steps its own F / D
members, with no collective, and returns their rows (state and poses;
``parallel/multihost.py`` ``MultiHostFleet.gather_poses`` assembles the
table). ``lut_pallas`` needs D to divide F, and every process holds the
whole LUT. With a ``particle_axis`` as well (a 2-D fleet x particle
mesh; the ``sphere``, ``dda`` and ``lut`` methods only, as in JAX), each
member's particles are split over that axis too, and a correction
all-gathers a member's particles and weights to resample it, as the
gathers XLA inserts for the JAX fleet do; the max shift, log quality and
pose are reduced over the axis. A meshed fleet draws from a generator of
its own per fleet shard (seeded from the seed and the shard), each
member's full draws on every process of its particle axis.

``step`` and ``step_many`` are programs (``utils/graphs.py``, the JAX
fleet's ``jax.jit`` and ``lax.scan``): a CUDA graph replay on a card
without a mesh, over a 1-D fleet mesh (no collective a correction,
whatever the backend), and over a particle axis of NCCL or of one
process; eager over a gloo particle axis, whose collectives copy through
the host.
"""

from __future__ import annotations

import dataclasses
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
from monte_carlo_localization_tpu_torch.models.motion import motion_model
from monte_carlo_localization_tpu_torch.models.sensor import SensorModel
from monte_carlo_localization_tpu_torch.ops.resample import resample_indices
from monte_carlo_localization_tpu_torch.parallel.collectives import Collectives, shard_seed
from monte_carlo_localization_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device, upload
from monte_carlo_localization_tpu_torch.utils.graphs import Programs, run_eager, shape_of


def _validate_parallel_config(cfg: MCLConfig, who: str, allow_pallas: bool = False) -> None:
    """Fail at construction on config values the batched or sharded
    filters cannot serve (JAX ``_validate_parallel_config``)."""
    if cfg.raycast_method == "lut_pallas" and not allow_pallas:
        raise ValueError(
            f"{who} supports raycast_method='lut_pallas' (shared or "
            "heterogeneous maps) only without a particle mesh axis, and "
            "with fleet_size divisible over a 1-D fleet mesh; use 'lut'"
        )
    if cfg.raycast_method not in ("sphere", "dda", "lut", "lut_pallas"):
        raise ValueError(f"Unknown raycast method: {cfg.raycast_method!r}")
    if cfg.resample_method not in ("systematic", "multinomial"):
        raise ValueError(f"Unknown resample method: {cfg.resample_method!r}")
    if cfg.sensor_model_mode not in ("analytic", "table"):
        raise ValueError(f"Unknown sensor model mode: {cfg.sensor_model_mode!r}")


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


def _select_maps(gm: GridMap, maps) -> GridMap:
    """The maps ``maps`` of a stacked map, as a stacked map without a LUT
    (a fleet shard's own members' maps)."""
    idx = torch.as_tensor(np.asarray(maps), dtype=torch.long, device=gm.device)
    fields = {
        name: getattr(gm, name)[idx]
        for name in ("occupancy", "occupied", "permissible", "clearance", "free_cells",
                     "num_free", "origin_x", "origin_y", "origin_yaw", "member_dims")
    }
    return dataclasses.replace(gm, **fields, range_lut=None, lut_row_map=None,
                               lut_theta_bins=0, lut_row_stride=0, lut_member_base=None,
                               lut_row_map_base=None)


class FleetFilter:
    """F independent filters stepped as one batch over one shared map or a
    stacked map (``stack_maps``), everything on ``device`` (default: the
    map's).

    ``map_assignment`` (F,) int maps each member to a map of a stacked
    ``grid_map``, so members share its LUT block. Without it a stacked
    map must hold one map per member.

    Over ``mesh`` (a ``DeviceMesh`` with ``fleet_axis``, and
    ``particle_axis`` for a 2-D mesh) this process holds the members
    ``local_members`` (and, with a particle axis, the particle columns
    ``local_particles`` of each); states, draws and poses are its rows."""

    def __init__(
        self,
        grid_map: GridMap,
        fleet_size: int,
        config: MCLConfig | None = None,
        beam_angles: np.ndarray | None = None,
        mesh=None,
        fleet_axis: str = "fleet",
        particle_axis: str | None = None,
        map_assignment: np.ndarray | None = None,
        device: torch.device | str | None = None,
    ):
        cfg = config or MCLConfig()
        cfg = cfg.replace(raycast_method=resolve_raycast_method(cfg.raycast_method))
        if fleet_size < 1:
            raise ValueError(f"fleet_size {fleet_size} < 1")
        if particle_axis is not None and mesh is None:
            raise ValueError("particle_axis needs a mesh")
        self._fleet_comm = Collectives.of_mesh(mesh, fleet_axis)
        self._particle_comm = Collectives.of_mesh(mesh if particle_axis else None, particle_axis)
        shards = self._fleet_comm.size
        # the fused kernel serves the fleet as one flattened particle batch
        # with per-member scans; over a 1-D fleet mesh each process runs it
        # on its F / D members. A particle axis stays on the XLA-style paths
        pallas_ok = (cfg.raycast_method == "lut_pallas" and particle_axis is None
                     and fleet_size % shards == 0)
        _validate_parallel_config(cfg, "FleetFilter", allow_pallas=pallas_ok)
        if fleet_size % shards:
            raise ValueError(f"fleet_size={fleet_size} must divide over {shards} fleet shards")
        if cfg.max_particles % self._particle_comm.size:
            raise ValueError(
                f"max_particles ({cfg.max_particles}) must divide evenly over "
                f"{self._particle_comm.size} particle shards"
            )
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
        self.mesh, self.fleet_axis, self.particle_axis = mesh, fleet_axis, particle_axis
        local_f = self.fleet_size // shards
        m0 = self._fleet_comm.axis_index * local_f
        self.local_members = range(m0, m0 + local_f)
        n_local = cfg.max_particles // self._particle_comm.size
        p0 = self._particle_comm.axis_index * n_local
        self.local_particles = range(p0, p0 + n_local)
        self.device = torch.device(device) if device is not None else grid_map.device
        self.map = grid_map.to(self.device)
        # each member's map in the stacked map (None on a shared map)
        member_maps = None
        if grid_map.is_batched:
            member_maps = (self.map_assignment if self.map_assignment is not None
                           else np.arange(fleet_size))
            if mesh is not None and cfg.raycast_method != "lut_pallas":
                # the XLA-style paths read one map per member: keep this
                # shard's members' maps (the LUT kernel keeps every map's block)
                self.map = _select_maps(self.map, member_maps[m0:m0 + local_f])
                member_maps = np.arange(fleet_size) - m0
        if cfg.raycast_method == "lut":
            self.map = self.map.with_range_lut(cfg.lut_theta_bins)
        self._all_member_maps = member_maps
        self._member_map = None
        if member_maps is not None:
            self._member_map = torch.as_tensor(member_maps[m0:m0 + local_f], dtype=torch.int32,
                                               device=self.device)
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
        self.likelihood = None
        self.programs = Programs(self.device)
        if beam_angles is not None:
            self.set_beam_angles(beam_angles)

    @property
    def num_local_members(self) -> int:
        return len(self.local_members)

    def set_beam_angles(self, beam_angles: np.ndarray) -> None:
        """Set the beam angles; under ``lut_pallas`` this attaches the LUT
        for this beam set (tight per-map blocks on a stacked map) and
        builds the fleet query."""
        beams = np.asarray(beam_angles, np.float32)
        if self.config.raycast_method == "lut_pallas":
            self.map, self.likelihood = build_lut_likelihood(
                self.map, beams, self.config, num_members=self.num_local_members
            )
        self.beam_angles = torch.as_tensor(beams, device=self.device)
        # graphs read the LUT, the query and the beams by address
        self.programs = Programs(self.device)

    def _generator(self, seed: int | None) -> torch.Generator:
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.config.seed if seed is None else int(seed))
        return gen

    def place_state(self, state: FleetState) -> FleetState:
        """This process's rows of a whole fleet ``state`` (F members, N
        particles) on its device; a meshed fleet then draws from its
        shard's own generator, seeded from the state's seed and the fleet
        shard. Without a mesh: the state on the fleet's device."""
        f, n = state.particles.shape[:2]
        if (f, n) != (self.fleet_size, self.config.max_particles):
            raise ValueError(
                f"state holds {f} members x {n} particles, fleet expects "
                f"{self.fleet_size} x {self.config.max_particles}"
            )
        gen = state.generator
        if self.mesh is not None or gen.device.type != self.device.type:
            seed = gen.initial_seed()
            if self.mesh is not None:
                seed = shard_seed(seed, self._fleet_comm.axis_index)
            gen = self._generator(seed)
        members = slice(self.local_members.start, self.local_members.stop)
        cols = slice(self.local_particles.start, self.local_particles.stop)
        return FleetState(
            particles=state.particles[members, cols].to(self.device),
            log_weights=state.log_weights[members, cols].to(self.device),
            generator=gen,
            log_quality=state.log_quality[members].to(self.device),
        )

    def init_global(self, seed: int | None = None) -> FleetState:
        """Each member uniform over its own map's free cells (under that
        map's ``num_free``), headings uniform in [0, 2pi). Over a mesh
        every process draws the whole fleet and keeps its rows."""
        gen = self._generator(seed)
        gm, f, n = self.map, self.fleet_size, self.config.max_particles
        dev = self.device
        if gm.is_batched:
            # a meshed fleet on the XLA-style paths holds only its own
            # members' maps: other members' rows are drawn on some map
            # (the same random bits) and dropped by place_state
            maps = torch.as_tensor(self._all_member_maps, dtype=torch.long,
                                   device=dev).clamp(0, gm.num_maps - 1)
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
        state = FleetState(particles=particles, log_weights=torch.zeros((f, n), device=dev),
                           generator=gen)
        return state if self.mesh is None else self.place_state(state)

    def init_pose(self, poses, seed: int | None = None) -> FleetState:
        """A Gaussian cloud around each member's pose; ``poses`` (F, 3).
        Over a mesh every process draws the whole fleet and keeps its rows."""
        poses = torch.as_tensor(poses, dtype=torch.float32, device=self.device)
        if tuple(poses.shape) != (self.fleet_size, 3):
            raise ValueError(f"poses shape {tuple(poses.shape)} != ({self.fleet_size}, 3)")
        gen = self._generator(seed)
        particles, log_w = initialize_pose(
            gen, poses, self.config.max_particles, device=self.device
        )
        state = FleetState(particles=particles, log_weights=log_w, generator=gen)
        return state if self.mesh is None else self.place_state(state)

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

    def _as(self, x, shape: tuple, name: str, axis: int = 0) -> torch.Tensor | None:
        """``x`` checked to have ``shape`` (local members on ``axis``); a
        meshed fleet also takes the whole fleet's rows and keeps its own
        (on the device). Host values stay on the host until a program
        copies them in."""
        if x is None:
            return None
        local_f = self.num_local_members
        if self.mesh is not None:
            x = upload(x, self.device)
            if x.dim() > axis and x.shape[axis] == self.fleet_size and local_f != self.fleet_size:
                x = x.narrow(axis, self.local_members.start, local_f)
        if shape_of(x) != shape:
            raise ValueError(f"{name} shape {shape_of(x)} != {shape}")
        return x

    def _gather_columns(self, x: torch.Tensor) -> torch.Tensor:
        """A member-major (F_l, n_local, ...) tensor's whole particle axis,
        all-gathered over the particle axis in shard order."""
        return self._particle_comm.all_gather(x.transpose(0, 1).contiguous()).transpose(0, 1)

    def _step_particle_axis(self, state, actions, obs_px, u0, noise):
        """One correction on a 2-D mesh: a member's particles and weights
        are all-gathered to resample it, its full draws made on every
        process of the particle axis, and the max shift, log quality and
        pose reduced over the axis."""
        cfg, comm, gen = self.config, self._particle_comm, state.generator
        cols = slice(self.local_particles.start, self.local_particles.stop)
        log_w_all = self._gather_columns(state.log_weights)
        idx = resample_indices(log_w_all, method=cfg.resample_method, generator=gen, u0=u0)
        # the gather's (F, n, 3) is a transposed view: the motion kernel reads it contiguous
        particles_all = self._gather_columns(state.particles).contiguous()
        if noise is None:
            noise = torch.randn(particles_all.shape, generator=gen, device=self.device)
        proposal = motion_model(
            particles_all, actions,
            dispersion_x=cfg.motion_dispersion_x, dispersion_y=cfg.motion_dispersion_y,
            dispersion_theta=cfg.motion_dispersion_theta,
            exact_dt_heuristic=cfg.exact_dt_heuristic, noise=noise[:, cols],
            indices=idx[:, cols],
        )
        log_w = self._likelihood_fn(proposal, obs_px)
        mq = comm.pmax(torch.amax(log_w, dim=-1))
        zq = comm.psum(torch.sum(torch.exp(log_w - mq[:, None]), dim=-1))
        log_quality = (mq + torch.log(zq) - math.log(cfg.max_particles)).to(torch.float32)
        log_w = log_w - mq[:, None]
        e = torch.exp(log_w)
        sums = comm.psum(torch.stack([
            torch.sum(e, -1), torch.sum(e * proposal[..., 0], -1), torch.sum(e * proposal[..., 1], -1),
            torch.sum(e * torch.sin(proposal[..., 2]), -1),
            torch.sum(e * torch.cos(proposal[..., 2]), -1),
        ], dim=-1))
        poses = torch.stack([sums[:, 1] / sums[:, 0], sums[:, 2] / sums[:, 0],
                             torch.atan2(sums[:, 3], sums[:, 4])], dim=-1)
        return proposal, log_w, log_quality, poses

    def _step(self, state, actions, obs_px, u0, noise):
        cfg = self.config
        if self.particle_axis is not None:
            particles, log_w, log_quality, poses = self._step_particle_axis(
                state, actions, obs_px, u0, noise)
        else:
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

    def _run(self, key: tuple, state: FleetState, inputs: dict, many: bool):
        """``step`` (``many`` False) or ``step_many`` on validated inputs:
        on a card one replay of the program's graph. A correction calls no
        collective but the particle axis's (none over a 1-D fleet mesh, any
        backend); where those stage through the host (gloo), the program
        runs eagerly, decided before any capture."""
        draws = [name for name in ("u0", "noise") if name in inputs]

        def program(b, gen):
            obs_px = self.sensor.to_pixel_index(b["scans"]).to(torch.float32)
            st = FleetState(particles=b["particles"], log_weights=b["log_weights"],
                            generator=gen)
            if not many:
                st, poses = self._step(st, b["actions"], obs_px, b.get("u0"), b.get("noise"))
            else:
                poses = []
                for i in range(b["actions"].shape[0]):
                    st, p = self._step(st, b["actions"][i], obs_px[i],
                                       *(b[name][i] if name in b else None
                                         for name in ("u0", "noise")))
                    poses.append(p)
                poses = torch.stack(poses)
            return dict(particles=st.particles, log_weights=st.log_weights,
                        log_quality=st.log_quality, poses=poses)

        inputs = dict(particles=state.particles, log_weights=state.log_weights, **inputs)
        if self._particle_comm.stages_on_host:
            out = run_eager(program, inputs, state.generator, self.device)
        else:
            out = self.programs((*key, *draws), program, inputs, state.generator,
                                keep=(self.map, self.sensor, self.beam_angles, self.likelihood,
                                      self._member_map))
        return FleetState(particles=out["particles"], log_weights=out["log_weights"],
                          generator=state.generator, log_quality=out["log_quality"]), out["poses"]

    def step(self, state: FleetState, actions, scans, u0=None, noise=None):
        """One correction of every member (of this process's members over a
        mesh), launched without waiting for the device (host inputs go up
        through pinned memory); on a card one replay of the fleet step's
        graph (eager over a gloo particle axis): ``actions`` (F, 3),
        ``scans`` (F, R) in meters. Optional draws: ``u0`` (F,) and ``noise`` (F, N, 3). Over a
        mesh each takes this process's members' rows, or those rows alone
        (F / D of them). Returns (state, poses (F, 3), or this process's
        (F / D, 3))."""
        self._require_beams()
        f, n = self.num_local_members, self.config.max_particles
        inputs = dict(actions=self._as(actions, (f, 3), "actions"),
                      scans=self._as(scans, (f, self.beam_angles.shape[0]), "scans"),
                      u0=self._as(u0, (f,), "u0"), noise=self._as(noise, (f, n, 3), "noise"))
        return self._run(("fleet_step",), state,
                         {name: v for name, v in inputs.items() if v is not None}, many=False)

    def step_many(self, state: FleetState, actions, scans, u0=None, noise=None):
        """K chained corrections with no host synchronization between them,
        on a card one replay of the K-correction graph (eager over a gloo
        particle axis):
        ``actions`` (K, F, 3), ``scans`` (K, F, R). Optional draws: ``u0``
        (K, F) and ``noise`` (K, F, N, 3). Returns (state, poses (K, F, 3));
        over a mesh, as :meth:`step`."""
        self._require_beams()
        f, n = self.num_local_members, self.config.max_particles
        k = shape_of(actions)[0]
        inputs = dict(actions=self._as(actions, (k, f, 3), "actions", axis=1),
                      scans=self._as(scans, (k, f, self.beam_angles.shape[0]), "scans", axis=1),
                      u0=self._as(u0, (k, f), "u0", axis=1),
                      noise=self._as(noise, (k, f, n, 3), "noise", axis=1))
        return self._run(("fleet_step_many",), state,
                         {name: v for name, v in inputs.items() if v is not None}, many=True)
