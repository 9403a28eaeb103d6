"""Giant-N global localization: one MCL filter with its particle axis
sharded over the processes of a mesh axis, as the JAX package's
``parallel/sharded.py`` does over devices.

One process holds one shard, ``N / D`` particles, on its device:

* motion and the likelihood are local (the ``lut_pallas`` kernel runs on
  this rank's ``n_local`` particles against its own LUT; the other
  methods run ``sensor_update_px``);
* the weights are normalized by a global max (``pmax``) and sum
  (``psum``);
* the systematic resampler needs the global CDF: each shard's prefix sum
  (the port's float64 doubling sum) is placed in the global one by the
  all-gathered shard totals, and ancestor rows cross shards through the
  bucketed exchange of ``ops/resample.py``
  ``distributed_systematic_resample_rows``: O(fringe + D) bytes a
  correction instead of the O(N) all-gather of the particles. Where a
  covered source lands beyond its fringe, the exact overflow flag sends
  the correction through the all-gather path; the rows are the same
  either way;
* the pose is a psum-weighted mean and circular mean.

The collectives are ``parallel/collectives.py``'s over the axis's process
group. ``step`` and ``step_many`` are programs (``utils/graphs.py``, the
counterpart of the JAX filter's ``jax.jit`` of its ``shard_map`` step and
its ``lax.scan`` of K steps): on a card one CUDA graph replay over a
one-shard world or an NCCL group; eager on the CPU, under
``disable_graphs()``, and over gloo, whose every collective is a host
copy (``Collectives.stages_on_host``).

JAX branches on the overflow flag on the device, per correction
(``lax.cond``). The flag is an exact global psum, so every rank takes the
same branch; the port runs a chunk (one ``step``, or the K corrections of
``step_many``) on the bucketed path, ORs each correction's flag into one
device flag, and reads it once after the chunk (``overflow_reads``, one
a chunk). Where it is set, the chunk runs again through the all-gather
path from the same inputs and the generator states saved before it
(``fallbacks`` counts these re-run chunks). Bucketed and all-gather rows
are bit-equal wherever no correction overflows, so the chunk's result is
the per-correction ``lax.cond``'s, bit for bit.

Random draws follow the JAX key discipline with two generators: the
resample offset u0 is the same on every rank (drawn from ``generator``,
identical on every rank), the motion noise differs per shard
(``motion_generator``, seeded from the seed and the shard). ``step``
takes external draws too: ``u0`` and the (N, 3) ``noise`` in global
particle order, of which each rank takes its rows.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from monte_carlo_localization_tpu_torch.config import MCLConfig, resolve_raycast_method
from monte_carlo_localization_tpu_torch.filter.core import (
    MCLState,
    build_lut_likelihood,
    sensor_update_px,
)
from monte_carlo_localization_tpu_torch.filter.init import initialize_global
from monte_carlo_localization_tpu_torch.mapping.grid_map import GridMap
from monte_carlo_localization_tpu_torch.models.motion import motion_model
from monte_carlo_localization_tpu_torch.models.sensor import SensorModel
from monte_carlo_localization_tpu_torch.ops.resample import (
    distributed_systematic_resample_rows,
    prefix_sum_doubling,
    systematic_invert_cdf_window,
)
from monte_carlo_localization_tpu_torch.parallel.collectives import (
    Collectives,
    shard_seed,
    world_mesh,
)
from monte_carlo_localization_tpu_torch.parallel.fleet import _validate_parallel_config
from monte_carlo_localization_tpu_torch.utils.graphs import Programs, run_eager, shape_of


@dataclass(frozen=True)
class ShardedState(MCLState):
    """This rank's rows of a sharded filter's state: ``particles``
    (n_local, 3) and ``log_weights`` (n_local,); ``log_quality`` is the
    global one. ``generator`` draws u0, the same on every rank;
    ``motion_generator`` this shard's motion noise."""

    motion_generator: torch.Generator | None = None


class ShardedParticleFilter:
    """One MCL filter with particles sharded over mesh axis ``axis``.

    ``mesh`` is a ``DeviceMesh`` with ``axis`` among its
    ``mesh_dim_names``; without one, the filter spans every process of
    the initialized ``torch.distributed`` world, or is a one-shard world
    when it is not initialized. Everything lives on ``device`` (default:
    the map's)."""

    def __init__(
        self,
        grid_map: GridMap,
        config: MCLConfig | None = None,
        mesh=None,
        axis: str = "p",
        beam_angles: np.ndarray | None = None,
        device: torch.device | str | None = None,
    ):
        cfg = config or MCLConfig()
        cfg = cfg.replace(raycast_method=resolve_raycast_method(cfg.raycast_method))
        _validate_parallel_config(cfg, "ShardedParticleFilter", allow_pallas=True)
        self.config = cfg
        self.mesh = world_mesh(axis) if mesh is None else mesh
        self.axis = axis
        self.comm = Collectives.of_mesh(self.mesh, axis)
        self.num_devices = self.comm.size
        self.shard = self.comm.axis_index
        if cfg.max_particles % self.num_devices != 0:
            raise ValueError(
                f"max_particles ({cfg.max_particles}) must divide evenly over "
                f"{self.num_devices} devices"
            )
        if cfg.sharded_resample not in ("bucketed", "allgather"):
            raise ValueError(f"Unknown sharded_resample: {cfg.sharded_resample!r}")
        self.n_local = cfg.max_particles // self.num_devices
        # fringe of the bucketed exchange: how far (in slots) a source's
        # first slot may stray from its shard's window before the
        # correction takes the all-gather path. Resampling rebalances the
        # shards every correction; n_local / 8 (at least 64) absorbs
        # ordinary imbalance and keeps the exchange O(C)
        self._fringe = cfg.sharded_fringe or max(64, self.n_local // 8)
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
        self.beam_angles: torch.Tensor | None = None
        self.likelihood = None  # this rank's LUTQuery under lut_pallas
        self.overflow_reads = 0  # host reads of a chunk's overflow flag: one sync each
        self.fallbacks = 0  # chunks the overflow ran again through the all-gather
        self.programs = Programs(self.device)
        if beam_angles is not None:
            self.set_beam_angles(beam_angles)

    def set_beam_angles(self, beam_angles: np.ndarray) -> None:
        """Set the beam angles; under ``lut_pallas`` this rank attaches the
        LUT for this beam set on its device and builds its query."""
        beams = np.asarray(beam_angles, np.float32)
        if self.config.raycast_method == "lut_pallas":
            self.map, self.likelihood = build_lut_likelihood(self.map, beams, self.config)
        self.beam_angles = torch.as_tensor(beams, device=self.device)
        # graphs read the LUT, the query and the beams by address
        self.programs = Programs(self.device)

    def _require_beams(self) -> None:
        if self.beam_angles is None:
            raise RuntimeError("beam_angles not set — call set_beam_angles() first")

    def _generators(self, generator: torch.Generator) -> tuple[torch.Generator, torch.Generator]:
        """(u0 generator on this device, this shard's motion generator)."""
        seed = generator.initial_seed()
        if generator.device.type != self.device.type:
            generator = torch.Generator(device=self.device)
            generator.manual_seed(seed)
        motion = torch.Generator(device=self.device)
        motion.manual_seed(shard_seed(seed, self.shard))
        return generator, motion

    def init_global(self, seed: int | None = None) -> ShardedState:
        """Uniform particles over the free cells, the same draw on every
        rank (one generator seeded by ``seed``), of which each keeps its
        rows."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.config.seed if seed is None else int(seed))
        particles, log_w = initialize_global(gen, self.map, self.config.max_particles)
        return self.place_state(MCLState(particles=particles, log_weights=log_w, generator=gen))

    def place_state(self, state: MCLState) -> ShardedState:
        """This rank's rows of a whole ``state`` (N particles) on its device:
        used by ``init_global`` and by checkpoint restore
        (``runtime.checkpoint.load_state(path, place=spf.place_state)``), so
        a checkpoint written at one D resumes at another. The state's
        generator goes on drawing u0; the motion generator is seeded from
        its seed and the shard."""
        if state.num_particles != self.config.max_particles:
            raise ValueError(
                f"state holds {state.num_particles} particles, filter "
                f"expects {self.config.max_particles}"
            )
        rows = slice(self.shard * self.n_local, (self.shard + 1) * self.n_local)
        gen, motion = self._generators(state.generator)
        return ShardedState(
            particles=state.particles[rows].to(self.device),
            log_weights=state.log_weights[rows].to(self.device),
            generator=gen,
            log_quality=state.log_quality.to(self.device),
            motion_generator=motion,
        )

    def gather_state(self, state: ShardedState) -> MCLState:
        """The whole state (N particles) on every rank, e.g. to write a
        checkpoint: the shards' rows all-gathered in shard order."""
        return MCLState(
            particles=self.comm.all_gather(state.particles),
            log_weights=self.comm.all_gather(state.log_weights),
            generator=state.generator,
            log_quality=state.log_quality,
        )

    def _likelihood_fn(self, particles: torch.Tensor, obs_px: torch.Tensor) -> torch.Tensor:
        gm, cfg = self.map, self.config
        if self.likelihood is not None:
            return self.likelihood(gm.range_lut, particles, obs_px, row_map=gm.lut_row_map)
        return sensor_update_px(
            particles, obs_px, self.beam_angles, gm, self.sensor,
            raycast_method=cfg.raycast_method, sphere_march_iters=cfg.sphere_march_iters,
            sensor_mode=cfg.sensor_model_mode,
        )

    def _full_gather(self, particles, cdf, u0) -> torch.Tensor:
        """The all-gather path: the whole particle matrix and CDF, inverted
        for this shard's slot window. O(N) bytes; the bucketed path's
        overflow escape and the ``sharded_resample='allgather'`` mode."""
        all_particles = self.comm.all_gather(particles)
        all_cdf = self.comm.all_gather(cdf)
        src = systematic_invert_cdf_window(
            all_cdf, u0, self.config.max_particles, self.shard * self.n_local, self.n_local
        )
        return all_particles[src.long()]

    def _resample(self, state: ShardedState, u0, bucketed: bool):
        """This shard's resampled rows, and the bucketed exchange's global
        overflow flag (a device bool; None on the all-gather path)."""
        comm = self.comm
        m = comm.pmax(torch.amax(state.log_weights).reshape(1))
        w_local = torch.exp(state.log_weights - m)
        w = w_local / comm.psum(torch.sum(w_local).reshape(1))  # global softmax, local slice
        local_cdf = prefix_sum_doubling(w.to(torch.float64))
        totals = comm.all_gather(local_cdf[-1:])  # (D,)
        cdf = (local_cdf + torch.sum(totals[:self.shard])).to(torch.float32)
        if u0 is None:
            # one global offset: the same generator state on every rank
            u0 = torch.rand((), generator=state.generator, device=self.device)
        if bucketed:
            return distributed_systematic_resample_rows(
                state.particles, cdf, u0, self.config.max_particles, comm, self.num_devices,
                self._fringe)
        return self._full_gather(state.particles, cdf, u0), None

    def _step(self, state: ShardedState, action, obs_px, u0, noise, bucketed: bool):
        cfg, comm = self.config, self.comm
        rows, overflow = self._resample(state, u0, bucketed)
        proposal = motion_model(
            rows,
            action,
            dispersion_x=cfg.motion_dispersion_x,
            dispersion_y=cfg.motion_dispersion_y,
            dispersion_theta=cfg.motion_dispersion_theta,
            exact_dt_heuristic=cfg.exact_dt_heuristic,
            generator=state.motion_generator,
            noise=noise,
        )
        log_w = self._likelihood_fn(proposal, obs_px)
        # global log mean likelihood before the shift (Augmented MCL's
        # w_avg), by a distributed logsumexp
        mq = comm.pmax(torch.amax(log_w).reshape(1))
        zq = comm.psum(torch.sum(torch.exp(log_w - mq)).reshape(1))
        log_quality = (mq + torch.log(zq) - math.log(cfg.max_particles))[0]
        log_w = log_w - mq
        e = torch.exp(log_w)
        sums = comm.psum(torch.stack([
            torch.sum(e), torch.sum(e * proposal[:, 0]), torch.sum(e * proposal[:, 1]),
            torch.sum(e * torch.sin(proposal[:, 2])), torch.sum(e * torch.cos(proposal[:, 2])),
        ]))
        pose = torch.stack([sums[1] / sums[0], sums[2] / sums[0], torch.atan2(sums[3], sums[4])])
        new_state = ShardedState(
            particles=proposal, log_weights=log_w, generator=state.generator,
            log_quality=log_quality.to(torch.float32), motion_generator=state.motion_generator,
        )
        return new_state, pose, overflow

    def _chunk(self, b: dict, gens, bucketed: bool) -> dict:
        """The program of a chunk of K corrections on this rank's buffers:
        ``particles``, ``log_weights``, ``actions`` (K, 3), ``scans`` (K,
        R), optional ``u0`` (K,) and ``noise`` (K, n_local, 3); ``gens``
        the (u0, motion) generators. With ``bucketed`` every correction
        takes the bucketed exchange and ORs its overflow flag into
        ``overflow``, which the caller reads once after the chunk."""
        u0_gen, motion_gen = gens
        obs_px = self.sensor.to_pixel_index(b["scans"]).to(torch.float32)
        state = ShardedState(particles=b["particles"], log_weights=b["log_weights"],
                             generator=u0_gen, motion_generator=motion_gen)
        overflow = torch.zeros((), dtype=torch.bool, device=self.device)
        poses = []
        for i in range(b["actions"].shape[0]):
            state, pose, flag = self._step(
                state, b["actions"][i], obs_px[i], b["u0"][i] if "u0" in b else None,
                b["noise"][i] if "noise" in b else None, bucketed)
            if flag is not None:
                overflow = overflow | flag
            poses.append(pose)
        return dict(particles=state.particles, log_weights=state.log_weights,
                    log_quality=state.log_quality, poses=torch.stack(poses), overflow=overflow)

    def _program(self, key: tuple, inputs: dict, gens, bucketed: bool) -> dict:
        """One chunk: a graph replay, or eagerly where the collectives
        stage through the host (gloo), decided before any capture."""
        def fn(b, g):
            return self._chunk(b, g, bucketed)

        if self.comm.stages_on_host:
            return run_eager(fn, inputs, gens, self.device)
        return self.programs((*key, "bucketed" if bucketed else "allgather"), fn, inputs, gens,
                             keep=(self.map, self.sensor, self.beam_angles, self.likelihood))

    def _run(self, key: tuple, state: ShardedState, inputs: dict):
        """A chunk on the bucketed path with one host read of its overflow
        flag, run again through the all-gather from the same inputs and
        the generator states saved before it where the flag is set; the
        all-gather alone at D = 1 and under ``sharded_resample='allgather'``."""
        gens = (state.generator, state.motion_generator)
        inputs = dict(particles=state.particles, log_weights=state.log_weights, **inputs)
        bucketed = self.config.sharded_resample == "bucketed" and self.num_devices > 1
        saved = [g.get_state() for g in gens] if bucketed else None
        out = self._program(key, inputs, gens, bucketed)
        if bucketed:
            self.overflow_reads += 1
            if bool(out["overflow"]):  # the global flag: every rank re-runs
                self.fallbacks += 1
                for g, st in zip(gens, saved):
                    g.set_state(st)
                out = self._program(key, inputs, gens, bucketed=False)
        new_state = ShardedState(
            particles=out["particles"], log_weights=out["log_weights"],
            generator=state.generator, log_quality=out["log_quality"],
            motion_generator=state.motion_generator,
        )
        return new_state, out["poses"]

    def _my_rows(self, x, axis: int = 0):
        """This shard's rows of ``x`` along its global particle ``axis``."""
        rows = slice(self.shard * self.n_local, (self.shard + 1) * self.n_local)
        x = x if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)
        return x[(slice(None),) * axis + (rows,)]

    def step(self, state: ShardedState, action, scan, u0=None, noise=None):
        """One sharded correction: ``action`` (3,), ``scan`` (R,) in meters,
        the same on every rank. Optional draws: ``u0`` (scalar) and
        ``noise`` (N, 3) in global particle order. Returns (this rank's
        state, the global pose (3,), the same on every rank); on a card
        one replay of the step's graph, except over gloo."""
        self._require_beams()
        n = self.config.max_particles
        if noise is not None and shape_of(noise) != (n, 3):
            raise ValueError(f"noise shape {shape_of(noise)} != ({n}, 3)")
        draws = dict(u0=u0, noise=None if noise is None else self._my_rows(noise))
        inputs = {name: _one(v) for name, v in dict(actions=action, scans=scan, **draws).items()
                  if v is not None}
        state, poses = self._run(("sharded_step", *sorted(k for k, v in draws.items()
                                                          if v is not None)), state, inputs)
        return state, poses[0]

    def step_many(self, state: ShardedState, actions, scans, u0=None, noise=None):
        """K chained sharded corrections: ``actions`` (K, 3), ``scans``
        (K, R); optional draws ``u0`` (K,) and ``noise`` (K, N, 3). Equal
        to K calls of :meth:`step`; on a card one replay of the chunk's
        graph (the JAX filter's ``lax.scan``), except over gloo. Returns
        (state, poses (K, 3))."""
        self._require_beams()
        n = self.config.max_particles
        k = shape_of(actions)[0]
        if shape_of(scans)[0] != k:
            raise ValueError(f"{k} actions but {shape_of(scans)[0]} scans")
        if u0 is not None and shape_of(u0) != (k,):
            raise ValueError(f"u0 shape {shape_of(u0)} != ({k},)")
        if noise is not None and shape_of(noise) != (k, n, 3):
            raise ValueError(f"noise shape {shape_of(noise)} != ({k}, {n}, 3)")
        draws = dict(u0=u0, noise=None if noise is None else self._my_rows(noise, axis=1))
        draws = {name: v for name, v in draws.items() if v is not None}
        return self._run(("sharded_step_many", *sorted(draws)), state,
                         dict(actions=actions, scans=scans, **draws))

    def log_quality(self, state: ShardedState) -> float:
        """Global log mean measurement likelihood of the latest correction
        (Augmented MCL's w_avg), as ``ParticleFilter.log_quality``."""
        return float(state.log_quality)


def _one(x):
    """``x`` with a leading axis of one: one correction as a chunk of one."""
    return x[None] if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)[None]
