"""Fleet robot loop: per-member dual-rate tracking around
:class:`~monte_carlo_localization_tpu_torch.parallel.FleetFilter`, as the
JAX package's ``runtime/fleet_node.py``.

It gives a fleet the robot-loop surface :class:`~.node.MCLNode` gives
one car:

* one :class:`~.tracker.OdometryTracker` per member (anchor + delta dead
  reckoning at odometry rate, reference src/particle_filter.cpp:988-1013);
* per-member scan ingest: the first scan of any member derives the beam
  set of all of them (one fleet likelihood serves one lidar model,
  reference :297-313), and a later scan of another geometry raises;
* a tick (``update``) that builds the (F, 3) actions from every member's
  latest twist and launches one fused fleet correction;
* an async pipeline (``async_correction``) with up to ``async_depth``
  fleet corrections in flight: each correction's poses start back to
  pinned host memory at dispatch, behind a CUDA event the harvest probes
  (``MCLNode``'s ``_Readback``), and each member's anchor is refreshed
  with the harvest's measured staleness;
* per-member pose priority chains and the sink topics ``fleet_tf``,
  ``fleet_pose`` and ``fleet_particles``, each carrying the (F, ...)
  batch.

:class:`~.loop.LiveRunner` drives a FleetNode unchanged (the duck-typed
``update``, ``publish_tick`` and ``publish_correction``).
"""

from __future__ import annotations

import collections
import time
from typing import Callable

import numpy as np
import torch

from monte_carlo_localization_tpu_torch.config import MCLConfig
from monte_carlo_localization_tpu_torch.mapping.grid_map import GridMap
from monte_carlo_localization_tpu_torch.parallel.fleet import FleetFilter, FleetState
from monte_carlo_localization_tpu_torch.runtime.node import _Readback
from monte_carlo_localization_tpu_torch.runtime.sinks import Sink
from monte_carlo_localization_tpu_torch.runtime.tracker import OdometryTracker
from monte_carlo_localization_tpu_torch.utils.geometry import apply_vehicle_offset
from monte_carlo_localization_tpu_torch.utils.timing import TimingStats
from monte_carlo_localization_tpu_torch.utils.validation import is_pose_valid


class FleetNode:
    """Robot-loop shell for a fleet of independent MCL filters.

    ``draws`` (optional) supplies the filter's random draws, to hold the
    node against another implementation on the same stream, as
    ``MCLNode``'s does:

    * ``draws.init(kind, seed, poses)`` -> (particles (F, N, 3),
      log_weights (F, N)) numpy, the clouds of ``init_global`` (kind
      ``"global"``, poses None) or ``init_pose`` (kind ``"pose"``, poses
      (F, 3)) with that seed;
    * ``draws.step()`` -> a dict of ``FleetFilter.step``'s draws for the
      next correction: ``u0`` (F,) and ``noise`` (F, N, 3).
    """

    def __init__(
        self,
        grid_map: GridMap,
        fleet_size: int,
        config: MCLConfig | None = None,
        map_assignment: np.ndarray | None = None,
        rng_seed: int | None = None,
        log: Callable[[str], None] = lambda s: None,
        draws=None,
    ):
        self.config = config or MCLConfig()
        if self.config.live_chunk > 1:
            raise ValueError(
                "FleetNode has no micro-chunked dispatch: a fleet step is "
                "big enough to amortize its own dispatch; use live_chunk=1"
            )
        self.fleet_size = int(fleet_size)
        self.log = log
        self.draws = draws
        self.filter = FleetFilter(
            grid_map,
            fleet_size=fleet_size,
            config=self.config,
            map_assignment=map_assignment,
        )
        self.map = self.filter.map
        self.trackers = [
            OdometryTracker(self.config.max_pose_range)
            for _ in range(self.fleet_size)
        ]
        self.stats = TimingStats()
        seed = self.config.seed if rng_seed is None else rng_seed
        self.rng = np.random.default_rng(seed)
        self.state: FleetState | None = self._init_state("global", seed, None)
        self.inferred_poses: np.ndarray | None = None  # (F, 3)
        self.sinks: list[Sink] = []
        self.iters = 0
        self.lidar_initialized = False
        # latest FULL row per member, swapped by reference (never written
        # in place): an ingest thread racing update() can then never tear
        # a row across two scans; update() snapshots the list and stacks
        self._scan_rows: list[np.ndarray | None] = [None] * self.fleet_size
        self._num_beams_down = 0
        self._beam_sig: tuple[float, float, int] | None = None
        self._have_scan = np.zeros(self.fleet_size, bool)
        self._odom_seen = np.zeros(self.fleet_size, bool)
        self._last_update_time: float | None = None
        self._last_dispatch_mono: float | None = None
        self._last_harvest_mono: float | None = None
        # dispatched corrections in flight as (readback, dispatch time)
        self._inflight_q: collections.deque = collections.deque()

    @property
    def device(self) -> torch.device:
        return self.filter.device

    def _init_state(self, kind: str, seed: int, poses) -> FleetState:
        if self.draws is not None:
            particles, log_w = self.draws.init(kind, seed, poses)
            return FleetState.from_numpy(particles, log_w, seed=seed, device=self.device)
        if kind == "global":
            return self.filter.init_global(seed=seed)
        return self.filter.init_pose(poses, seed=seed)

    # ----- per-member ingest -----
    def on_scan(
        self,
        member: int,
        ranges: np.ndarray,
        angle_min: float | None = None,
        angle_increment: float | None = None,
        beam_angles: np.ndarray | None = None,
    ) -> None:
        """Latest scan for one member. The first scan (any member) derives
        the shared beam set (reference src/particle_filter.cpp:297-313
        derives beams once for its one car), so every member's scan must
        share the geometry: a member with another angle_min, increment or
        beam count raises at once instead of scoring its scan against the
        wrong beam angles."""
        ranges = np.asarray(ranges, dtype=np.float32)
        if not self.lidar_initialized:
            if beam_angles is None:
                if angle_min is None or angle_increment is None:
                    raise ValueError(
                        "first scan needs beam_angles or angle_min/increment"
                    )
                beam_angles = angle_min + np.arange(len(ranges)) * angle_increment
            beam_angles = np.asarray(beam_angles, np.float32)
            down = beam_angles[:: self.config.angle_step]
            self.filter.set_beam_angles(down)
            self.lidar_initialized = True
            self._num_beams_down = len(down)
            self._beam_sig = (
                float(beam_angles[0]),
                float(beam_angles[1] - beam_angles[0]) if len(beam_angles) > 1 else 0.0,
                len(beam_angles),
            )
            self.log(
                f"Fleet LiDAR initialized - {len(down)} angles x "
                f"{self.fleet_size} members"
            )
        else:
            self._check_beam_geometry(
                member, len(ranges), angle_min, angle_increment, beam_angles
            )
        down_r = ranges[:: self.config.angle_step]
        if down_r.shape[0] != self._num_beams_down:
            raise ValueError(
                f"member {member} scan has {down_r.shape[0]} beams, fleet "
                f"expects {self._num_beams_down}"
            )
        # reference swap: never write into a row update() may be reading
        self._scan_rows[member] = np.ascontiguousarray(down_r)
        self._have_scan[member] = True

    def _check_beam_geometry(
        self,
        member: int,
        num_ranges: int,
        angle_min: float | None,
        angle_increment: float | None,
        beam_angles: np.ndarray | None,
    ) -> None:
        """Fail fast on a heterogeneous lidar: the fleet's beam set is
        fixed by the first scan."""
        sig = self._beam_sig
        if sig is None:
            return
        a0, inc, n = sig
        if num_ranges != n:
            raise ValueError(
                f"member {member} lidar has {num_ranges} beams; the fleet "
                f"kernel was compiled for {n} — heterogeneous beam sets "
                "are unsupported (one FleetNode = one lidar model)"
            )
        if beam_angles is not None:
            ba = np.asarray(beam_angles, np.float64)
            got0 = float(ba[0])
            got_inc = float(ba[1] - ba[0]) if len(ba) > 1 else 0.0
        elif angle_min is not None and angle_increment is not None:
            got0, got_inc = float(angle_min), float(angle_increment)
        else:
            return  # ranges only: the geometry is asserted implicitly
        if abs(got0 - a0) > 1e-6 or abs(got_inc - inc) > 1e-9:
            raise ValueError(
                f"member {member} lidar geometry (angle_min {got0:.6f}, "
                f"increment {got_inc:.9f}) differs from the compiled beam "
                f"set (angle_min {a0:.6f}, increment {inc:.9f}) — "
                "heterogeneous beam sets are unsupported in one FleetNode"
            )

    def on_odometry(
        self,
        member: int,
        x: float,
        y: float,
        theta: float,
        velocity: float,
        angular_velocity: float,
        stamp: float | None = None,
    ) -> None:
        self.trackers[member].on_odometry(x, y, theta, velocity, angular_velocity, stamp)
        self._odom_seen[member] = True

    # ----- (re)initialization -----
    def initialize_pose(self, poses: np.ndarray) -> None:
        """Seed every member at its own pose ((F, 3))."""
        poses = np.asarray(poses, np.float64).reshape(self.fleet_size, 3)
        self._flush_inflight()
        self.state = self._init_state("pose", int(self.rng.integers(2**31)), poses)
        for m, tr in enumerate(self.trackers):
            tr.anchor(poses[m], from_seed=True)
        self.inferred_poses = poses.copy()
        self.log(f"Fleet pose initialized ({self.fleet_size} members)")

    def initialize_global(self) -> None:
        self._flush_inflight()
        self.state = self._init_state("global", int(self.rng.integers(2**31)), None)
        for tr in self.trackers:
            tr.deactivate()
        self.inferred_poses = None
        self.log("Fleet global initialization")

    def _flush_inflight(self) -> None:
        """Drop queued corrections: after a re-initialization their poses
        describe the abandoned belief."""
        self._inflight_q.clear()
        self._last_dispatch_mono = None
        self._last_harvest_mono = None

    # ----- the tick -----
    def update(self, now: float | None = None) -> np.ndarray | None:
        """One fleet correction if possible; returns (F, 3) poses."""
        now = time.monotonic() if now is None else now
        if self._last_update_time is None:
            self._last_update_time = now
            return None
        dt = now - self._last_update_time
        self._last_update_time = now
        if dt > 1.0:  # the reference's huge-gap skip (:750-752)
            return None
        if not self.lidar_initialized or not self._have_scan.all():
            return None

        self.iters += 1
        # snapshot the row references before building the batch: ingest
        # threads swap whole rows, so every stacked row is one coherent scan
        scans = np.stack(list(self._scan_rows))
        actions = np.zeros((self.fleet_size, 3), np.float32)
        if dt >= 1e-4:
            for m, tr in enumerate(self.trackers):
                snap = tr.snapshot()
                if self._odom_seen[m] and (
                    abs(snap.velocity) > 1e-4 or abs(snap.angular_velocity) > 1e-4
                ):
                    actions[m, 0] = snap.velocity * dt
                    actions[m, 2] = snap.angular_velocity * dt

        if self.config.async_correction:
            return self._update_async(actions, scans, now)

        t0 = time.perf_counter()
        self.state, poses_dev = self._step(actions, scans)
        poses = poses_dev.cpu().numpy().astype(np.float64)  # waits for the step
        self.stats.total_mcl_time += (time.perf_counter() - t0) * 1e3
        self.stats.measurement_count += 1
        self._post_correction(poses)
        return poses

    def _step(self, actions, scans):
        """One fleet correction, with the next draws from ``draws`` when given."""
        draws = {} if self.draws is None else self.draws.step()
        return self.filter.step(self.state, actions, scans, **draws)

    def _update_async(self, actions, scans: np.ndarray, now: float) -> np.ndarray | None:
        """Pipelined fleet corrections (depth ``async_depth``), the fleet
        twin of ``MCLNode._update_async`` without chunking: dispatch first
        (the poses start back to the host at once), then harvest every
        finished correction, oldest first. Every harvested correction but
        the last is published here; the last is returned for the caller
        to publish."""
        if len(self._inflight_q) < self.config.async_depth:
            t_mono = time.monotonic()
            if self._last_dispatch_mono is not None:
                # motion since the last dispatch, not the last tick
                ddt = min(t_mono - self._last_dispatch_mono, 1.0)
                for m, tr in enumerate(self.trackers):
                    if self._odom_seen[m]:
                        snap = tr.snapshot()
                        actions[m] = (snap.velocity * ddt, 0.0, snap.angular_velocity * ddt)
            self._last_dispatch_mono = t_mono
            self.state, poses_dev = self._step(actions, scans)
            self._inflight_q.append((_Readback(poses_dev), t_mono))

        poses = None
        while self._inflight_q:
            readback, t_disp = self._inflight_q[0]
            if not readback.ready() and len(self._inflight_q) < self.config.async_depth:
                break
            if poses is not None:
                self.publish_correction(now, poses)
            poses = readback.wait()[0].astype(np.float64)
            self._inflight_q.popleft()
            t_now = time.monotonic()
            base = (
                t_disp
                if self._last_harvest_mono is None
                else max(t_disp, self._last_harvest_mono)
            )
            self._last_harvest_mono = t_now
            self.stats.total_mcl_time += (t_now - base) * 1e3
            self.stats.measurement_count += 1
            self._post_correction(poses, delay_ms=(t_now - t_disp) * 1e3, delay_factor=1.0)
        return poses

    def _post_correction(
        self,
        poses: np.ndarray,
        delay_ms: float | None = None,
        delay_factor: float | None = None,
    ) -> None:
        self.inferred_poses = poses
        for m, tr in enumerate(self.trackers):
            if self._odom_seen[m] and (
                tr.pose_initialized_from_seed
                or is_pose_valid(poses[m], self.config.max_pose_range)
            ):
                tr.anchor(
                    poses[m],
                    avg_mcl_ms=self.stats.avg_total_ms if delay_ms is None else delay_ms,
                    delay_compensation_factor=(
                        self.config.delay_compensation_factor
                        if delay_factor is None
                        else delay_factor
                    ),
                )
        if self.iters % 200 == 0:
            self.stats.print_stats(self.log)
            self.stats.reset()

    # ----- outputs -----
    def current_pose(self, member: int) -> np.ndarray:
        """The member's pose priority chain; its particle mean is read back
        from the card only when the chain reaches it."""
        state = self.state
        particle_mean = None if state is None else (
            lambda: state.particles[member].cpu().numpy().mean(axis=0)
        )
        inferred = None if self.inferred_poses is None else self.inferred_poses[member]
        return self.trackers[member].current_pose(inferred, particle_mean)

    def current_poses(self) -> np.ndarray:
        return np.stack([self.current_pose(m) for m in range(self.fleet_size)])

    def base_link_poses(self) -> np.ndarray:
        return apply_vehicle_offset(self.current_poses(), self.config.lidar_offset_x)

    def particle_clouds(self) -> np.ndarray:
        """(F, max_viz_particles, 3) weighted viz downsample per member,
        read back from the state's device."""
        state = self.state
        if state is None:
            raise RuntimeError("the node has no filter state")
        particles = state.particles.cpu().numpy()
        w = torch.softmax(state.log_weights, dim=-1).cpu().numpy()
        k = min(self.config.max_viz_particles, particles.shape[1])
        out = np.empty((self.fleet_size, k, 3), np.float64)
        for m in range(self.fleet_size):
            if particles.shape[1] > k:
                idx = self.rng.choice(particles.shape[1], k, p=w[m] / w[m].sum())
                out[m] = particles[m, idx]
            else:
                out[m] = particles[m, :k]
        return apply_vehicle_offset(out, self.config.lidar_offset_x)

    # ----- sinks (batched fleet topics) -----
    def add_sink(self, sink: Sink) -> None:
        self.sinks.append(sink)

    def close_sinks(self) -> None:
        for s in self.sinks:
            s.close()

    def _wants(self, topic: str) -> bool:
        return any(s.wants(topic) for s in self.sinks)

    def _publish(self, topic: str, t: float, payload: dict) -> None:
        for s in self.sinks:
            if s.wants(topic):
                s.publish(topic, t, payload)

    def publish_tick(self, t: float) -> None:
        if not self.sinks:
            return
        if self._wants("fleet_tf"):
            self._publish("fleet_tf", t, {"poses": self.base_link_poses()})

    def publish_correction(self, t: float, poses: np.ndarray) -> None:
        if not self.sinks or not self.config.viz:
            return
        if self._wants("fleet_particles"):
            self._publish("fleet_particles", t, {"clouds": self.particle_clouds()})
        if self._wants("fleet_pose"):
            self._publish("fleet_pose", t, {"poses": np.asarray(poses)})
