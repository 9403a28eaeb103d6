"""The MCL node — the reference's update-control + I/O shell, ROS-free —
on the port's :class:`~monte_carlo_localization_tpu_torch.filter.ParticleFilter`,
as the JAX package's ``runtime/node.py``.

Reproduces the behavior of the reference node (reference
src/particle_filter.cpp:19-170 constructor, :720-846 timer_update,
:295-352 sensor callbacks, :857-983 outputs) around the filter's step:

* scan ingest with first-scan beam derivation and ``angle_step``
  downsampling (reference :297-313),
* odometry ingest feeding the host tracker (reference :325-352),
* the update tick: dt from a monotonic clock, >1 s tick skip, action from
  the latest twist, decaying exploration noise for the first 15 iterations
  without odometry (reference :734-772),
* per-phase TimingStats and the every-200-iteration printout
  (reference :814-827), its phases the device times sampled from inside
  the step graphs, and spans of the tick and the chained replay
  (``utils/timing.py`` ``TRACER``),
* delay-compensated anchor refresh after each correction (reference
  :784-807),
* pose priority chain + lidar->base_link offset on outputs
  (reference :857-916), weighted particle-cloud downsampling to
  ``max_viz_particles`` (reference :967-983),
* the Augmented-MCL monitor: global re-initialization or injection.

I/O is abstracted: feed it callbacks (live mode) or a recorded
:class:`~monte_carlo_localization_tpu_torch.runtime.trace.Trace` (replay
mode). The filter's launches do not wait for the card. The synchronous
update blocks when it reads the pose back; with ``async_correction`` a
correction's pose and quality start back to pinned host memory at
dispatch, behind a CUDA event that the harvest probes, so nothing on the
tick path waits for the stream (host inputs go up through pinned memory
too; see ``utils/device.py`` ``upload``).
"""

from __future__ import annotations

import collections
import math
import threading
import time
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from monte_carlo_localization_tpu_torch.config import MCLConfig
from monte_carlo_localization_tpu_torch.filter.core import MCLState, ParticleFilter
from monte_carlo_localization_tpu_torch.mapping.grid_map import GridMap
from monte_carlo_localization_tpu_torch.runtime.sinks import Sink
from monte_carlo_localization_tpu_torch.runtime.trace import Trace, TraceReader, trace_actions
from monte_carlo_localization_tpu_torch.runtime.tracker import OdometryTracker
from monte_carlo_localization_tpu_torch.utils.geometry import (
    apply_vehicle_offset,
    trajectory_rmse,
)
from monte_carlo_localization_tpu_torch.utils.timing import TRACER, TimingStats
from monte_carlo_localization_tpu_torch.utils.validation import is_pose_valid

_UPDATE = TRACER.name("node.update")
_STEP = TRACER.name("filter.step")
_POSE_WAIT = TRACER.name("node.pose_wait")
_WAIT_POST = (_POSE_WAIT, TRACER.name("node.post"))
_REPLAY_CHAINED = TRACER.name("node.replay_chained")
_CHUNK_SYNC = TRACER.name("node.chunk_sync")
_READBACK = TRACER.name("node.readback")


@dataclass
class ReplayResult:
    times: np.ndarray  # (K,) correction timestamps
    poses: np.ndarray  # (K, 3) inferred (laser-frame) poses
    tracked: np.ndarray  # (K, 3) dual-rate current_pose at the same instants
    rmse_xy: float | None = None  # vs ground truth, if the trace has it
    rmse_theta: float | None = None
    updates_per_sec: float = 0.0
    stats: TimingStats | None = None

    @property
    def corrections(self) -> int:
        return len(self.times)


class _Readback:
    """Device-to-host copies started now: on a card, into pinned host
    buffers behind a CUDA event (``ready`` probes it, ``wait`` blocks on
    it); CPU tensors are already on the host."""

    def __init__(self, *tensors: torch.Tensor):
        self._event = None
        self._host = list(tensors)
        if tensors[0].device.type == "cuda":
            self._host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in tensors]
            for h, t in zip(self._host, tensors):
                h.copy_(t, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()

    def ready(self) -> bool:
        return self._event is None or self._event.query()

    def wait(self) -> list[np.ndarray]:
        if self._event is not None:
            self._event.synchronize()
        return [h.numpy() for h in self._host]


class MCLNode:
    """The node. ``draws`` (optional) supplies the filter's random draws,
    to hold the node against another implementation on the same stream:

    * ``draws.init(kind, seed, pose)`` -> (particles (N, 3), log_weights
      (N,)) numpy, the cloud of ``init_global`` (kind ``"global"``, pose
      None) or ``init_pose`` (kind ``"pose"``) with that seed;
    * ``draws.step(inject)`` -> a dict of ``ParticleFilter.step``'s draws
      for the next correction: ``u0`` and ``noise``, and with ``inject``
      ``mask_u`` and ``injected`` (a chunked dispatch stacks K of them).

    ``particle_filter`` (optional) is the filter to drive, in place of a
    new one on ``grid_map`` and ``config``.
    """

    def __init__(
        self,
        grid_map: GridMap,
        config: MCLConfig | None = None,
        rng_seed: int | None = None,
        log: Callable[[str], None] = lambda s: None,
        draws=None,
        particle_filter: ParticleFilter | None = None,
    ):
        self.config = config or MCLConfig()
        if self.config.live_chunk < 1:
            raise ValueError(
                f"live_chunk must be >= 1, got {self.config.live_chunk}"
            )
        if self.config.live_chunk > 1 and not self.config.async_correction:
            # chunking only exists on the async dispatch path; accepting
            # the combination silently would leave every tick paying the
            # full blocking dispatch the user asked to amortize
            raise ValueError(
                "live_chunk > 1 requires async_correction=True "
                f"(got live_chunk={self.config.live_chunk})"
            )
        self.map = grid_map
        self.log = log
        self.draws = draws
        self.filter = particle_filter or ParticleFilter(grid_map, self.config)
        self.tracker = OdometryTracker(self.config.max_pose_range)
        self.stats = TimingStats()
        seed = self.config.seed if rng_seed is None else rng_seed
        self.rng = np.random.default_rng(seed)

        self.state: MCLState | None = None
        self.inferred_pose: np.ndarray | None = None
        self.sinks: list[Sink] = []
        # Delay compensation projects the anchor forward by the measured
        # wall-time of the MCL step (reference :790-806) — meaningful only
        # when the clock driving update() is the same wall clock the stats
        # measure. Offline trace replay disables it.
        self.delay_compensation_enabled = True
        self.iters = 0
        self.lidar_initialized = False
        self.odom_initialized = False
        self.downsampled_ranges: np.ndarray | None = None
        self._last_update_time: float | None = None
        # async_correction pipeline: up to config.async_depth dispatched
        # corrections in flight as (readback, dispatch time, count)
        self._inflight_q: collections.deque = collections.deque()
        self._last_dispatch_mono: float | None = None
        self._last_harvest_mono: float | None = None
        # live_chunk > 1: per-tick (action, scan) pairs awaiting a chunked
        # step_many dispatch (see _update_async_chunked)
        self._chunk_buf: list[tuple[np.ndarray, np.ndarray]] = []
        self._in_replay = False  # replay drives sim time: always sync there

        # Augmented-MCL auto re-localization monitor (config.auto_reinit).
        # The reference has no detector — kidnapped-robot recovery there is
        # human-triggered via /clicked_point (reference :376-379).
        self._q_slow: float | None = None
        self._q_fast: float | None = None
        self._bad_count = 0
        self._reinit_holdoff = 0
        self.auto_reinits = 0
        # "inject" mode: the fraction of particles the NEXT correction
        # replaces with uniform free-space draws, refreshed by the monitor
        # after every harvested correction; inject_steps counts
        # corrections that actually injected
        self._inject_fraction = 0.0
        self.inject_steps = 0

        # Cross-thread re-initialization requests: a viewer's handler on
        # another thread must not re-initialize `self.state` while the live
        # loop steps it (the loop would commit the stepped OLD belief over
        # it). Requests queue here and apply at the top of the next
        # update() tick, on the live thread.
        self._reinit_lock = threading.Lock()
        self._pending_reinit: tuple[str, np.ndarray | None] | None = None

        # global init at startup, like the reference constructor (:151-152)
        self.state = self._init_state("global", seed, None)

    @property
    def device(self) -> torch.device:
        return self.filter.device

    def _init_state(self, kind: str, seed: int, pose) -> MCLState:
        if self.draws is not None:
            particles, log_w = self.draws.init(kind, seed, pose)
            return MCLState.from_numpy(particles, log_w, seed=seed, device=self.device)
        if kind == "global":
            return self.filter.init_global(seed=seed)
        return self.filter.init_pose(pose, seed=seed)

    # ----- scan ingest (reference lidarCB :295-323) -----
    def on_scan(
        self,
        ranges: np.ndarray,
        angle_min: float | None = None,
        angle_increment: float | None = None,
        beam_angles: np.ndarray | None = None,
    ) -> None:
        ranges = np.asarray(ranges, dtype=np.float32)
        if not self.lidar_initialized:
            if beam_angles is None:
                if angle_min is None or angle_increment is None:
                    raise ValueError(
                        "first scan needs beam_angles or angle_min/increment"
                    )
                beam_angles = angle_min + np.arange(len(ranges)) * angle_increment
            down = np.asarray(beam_angles, dtype=np.float32)[
                :: self.config.angle_step
            ]
            self.filter.set_beam_angles(down)
            self.lidar_initialized = True
            self.log(f"LiDAR initialized - {len(down)} angles")
        self.downsampled_ranges = ranges[:: self.config.angle_step]

    # ----- odom ingest (reference odomCB :325-352) -----
    def on_odometry(
        self,
        x: float,
        y: float,
        theta: float,
        velocity: float,
        angular_velocity: float,
        stamp: float | None = None,
    ) -> None:
        self.tracker.on_odometry(x, y, theta, velocity, angular_velocity, stamp)
        self.odom_initialized = True

    # ----- interactive init (reference clicked_pose/:355-379) -----
    def _flush_inflight(self) -> None:
        """Drop queued async corrections: after a re-initialization their
        poses describe the abandoned belief and must never re-anchor the
        tracker at it."""
        self._inflight_q.clear()
        self._chunk_buf.clear()
        self._last_dispatch_mono = None
        self._last_harvest_mono = None

    def initialize_pose(self, pose: np.ndarray) -> None:
        self._flush_inflight()
        self.state = self._init_state("pose", int(self.rng.integers(2**31)), pose)
        self.tracker.anchor(np.asarray(pose, dtype=np.float64), from_seed=True)
        self.inferred_pose = np.asarray(pose, dtype=np.float64)
        self._inject_fraction = 0.0  # a fresh belief starts clean
        self.log(f"Pose initialized at {np.round(pose, 3)}")

    def initialize_global(self) -> None:
        self._flush_inflight()
        self.state = self._init_state("global", int(self.rng.integers(2**31)), None)
        self.tracker.deactivate()
        self.inferred_pose = None
        self._inject_fraction = 0.0
        self.log("Global initialization")

    # ----- cross-thread re-init requests (any non-loop thread) -----
    def request_initialize_pose(self, pose: np.ndarray) -> None:
        """Thread-safe deferred :meth:`initialize_pose`: queued here, applied
        at the top of the next :meth:`update` tick on the loop thread, so a
        concurrent ``state = filter.step(state, ...)`` commit can never
        overwrite the re-initialization."""
        with self._reinit_lock:
            self._pending_reinit = ("pose", np.asarray(pose, np.float64))

    def request_initialize_global(self) -> None:
        """Thread-safe deferred :meth:`initialize_global` (see above)."""
        with self._reinit_lock:
            self._pending_reinit = ("global", None)

    def _apply_pending_reinit(self) -> None:
        with self._reinit_lock:
            req, self._pending_reinit = self._pending_reinit, None
        if req is None:
            return
        kind, pose = req
        if kind == "pose":
            self.initialize_pose(pose)
        else:
            self.initialize_global()

    # ----- the update tick (reference timer_update :720-846) -----
    def update(self, now: float | None = None) -> np.ndarray | None:
        """Run one MCL correction if possible; returns the inferred pose."""
        t_entry = time.perf_counter_ns()
        if self._pending_reinit is not None:
            self._apply_pending_reinit()
        now = time.monotonic() if now is None else now
        if self._last_update_time is None:
            self._last_update_time = now
            return None
        dt = now - self._last_update_time
        self._last_update_time = now
        if dt > 1.0:  # skip huge gaps (reference :750-752)
            return None
        if not self.lidar_initialized or self.downsampled_ranges is None:
            return None

        self.iters += 1
        snap = self.tracker.snapshot()
        action = np.zeros(3)
        if self.odom_initialized and dt >= 1e-4 and (
            abs(snap.velocity) > 1e-4 or abs(snap.angular_velocity) > 1e-4
        ):
            action[0] = snap.velocity * dt
            action[2] = snap.angular_velocity * dt
        elif (
            not self.odom_initialized
            and not self.tracker.pose_initialized_from_seed
            and self.iters < 15
        ):
            # decaying exploration noise (reference :767-772)
            nf = max(0.1, 1.0 - self.iters / 15.0)
            action[0] = self.rng.normal() * 0.02 * nf
            action[1] = self.rng.normal() * 0.01 * nf
            action[2] = self.rng.normal() * 0.05 * nf

        if self.config.async_correction and not self._in_replay:
            return self._update_async(action, now)
        return self._update_sync(action, t_entry)

    def _update_sync(self, action, t_entry: int) -> np.ndarray:
        """A correcting tick that waits for its pose: the ``TRACER`` span
        ``node.update`` from the tick's entry (``t_entry``; request: the
        iteration) over ``filter.step``, ``node.pose_wait`` and
        ``node.post``; its self time is the node's own host work.
        ``total_mcl_time`` takes ``filter.step`` and ``node.pose_wait``, the
        interval the anchor's delay compensation reads."""
        TRACER.request = self.iters
        token = TRACER.open(_UPDATE, t_entry)
        try:
            self.state, pose_dev = self._step_filter(action)
            t0 = time.perf_counter_ns()
            pose = pose_dev.cpu().numpy().astype(np.float64)  # waits for the step
            t1 = time.perf_counter_ns()
            self.stats.total_mcl_time += (_STEP.last_ns + t1 - t0) * 1e-6
            self.stats.measurement_count += 1
            self._post_correction(pose)
            TRACER.chain(_WAIT_POST, (t0, t1, time.perf_counter_ns()))
            return pose
        finally:
            TRACER.close(token)

    def _update_async(self, action, now: float) -> np.ndarray | None:
        """Pipelined corrections: dispatch without blocking, harvest poses
        as the device finishes them.

        The filter STATE advances at dispatch rate (every tick, up to
        ``async_depth`` corrections in flight — the bounded-queue analogue
        of the reference's try_lock skip); the pose READBACK for the
        anchor refresh lags by the device->host latency, the reference's
        own dual-rate shape. Dispatch happens BEFORE harvest so the
        readback overlaps the next corrections' compute.

        A tick can harvest several finished corrections; every one is
        processed (anchor/monitor/stats) and published to the node's
        sinks except the LAST, which is returned — the caller (e.g.
        LiveRunner) publishes the returned pose, so each correction
        reaches the sinks exactly once.
        """
        if self.config.live_chunk > 1:
            return self._update_async_chunked(action, now)
        # ---- dispatch first (if the queue has room) ----
        if (
            len(self._inflight_q) < self.config.async_depth
            and self.downsampled_ranges is not None
        ):
            t_mono = time.monotonic()
            if self._last_dispatch_mono is not None and self.odom_initialized:
                # motion since the LAST DISPATCH, not the last tick: ticks
                # that only polled must not drop odometry displacement.
                # Without odometry, keep the caller's action (the decaying
                # exploration noise of update(), reference :767-772).
                snap = self.tracker.snapshot()
                ddt = min(t_mono - self._last_dispatch_mono, 1.0)
                action = np.array(
                    [snap.velocity * ddt, 0.0, snap.angular_velocity * ddt]
                )
            self._last_dispatch_mono = t_mono
            # (update() already counted this tick in self.iters)
            self.state, pose_dev = self._step_filter(action)
            self._enqueue_dispatch(pose_dev, t_mono, 1)

        return self._harvest_inflight(now)

    def _step_filter(self, action):
        """One filter correction, carrying the Augmented-MCL injection
        fraction when ``reinit_mode == "inject"`` is active (the fraction
        may be 0.0: the step then draws its mask and poses and replaces
        nothing, as the JAX node's traced fraction does)."""
        cfg = self.config
        inject = cfg.auto_reinit and cfg.reinit_mode == "inject"
        draws = {} if self.draws is None else self.draws.step(inject)
        if inject:
            if self._inject_fraction > 0.0:
                self.inject_steps += 1
            return self.filter.step(
                self.state, action, self.downsampled_ranges,
                inject_fraction=self._inject_fraction, **draws,
            )
        return self.filter.step(self.state, action, self.downsampled_ranges, **draws)

    def _enqueue_dispatch(self, pose_dev: torch.Tensor, t_mono: float, count: int) -> None:
        """Queue one just-dispatched correction (or K-chunk) for harvest,
        with its quality scalar: both start back to the host now, so the
        round trips of consecutive readbacks overlap, and the monitor never
        reads a newer state's quality (or waits for it)."""
        self._inflight_q.append((_Readback(pose_dev, self.state.log_quality), t_mono, count))

    def _update_async_chunked(self, action, now: float) -> np.ndarray | None:
        """Micro-chunked pipelined corrections (``live_chunk`` = K > 1).

        Every tick buffers its (action, scan) pair host-side; once K are
        buffered (and the in-flight queue has room) they dispatch as ONE
        ``step_many(K)``, trading ≤ K-1 ticks of extra pose latency. The
        anchor's delay compensation measures that staleness exactly (the
        LAST scan of a chunk is fresh at dispatch, so now - t_dispatch is
        its true age at harvest). If the device falls behind the tick rate
        the two oldest buffered ticks MERGE (actions sum; the older scan
        drops), so odometry displacement is never lost and the buffer
        stays bounded at 2K.

        Augmented-MCL injection (``reinit_mode="inject"``) does not apply
        on this path: ``step_many`` carries no per-step fraction — use
        ``live_chunk=1`` when continuous injection matters.
        """
        K = int(self.config.live_chunk)
        if self.downsampled_ranges is not None:
            if len(self._chunk_buf) >= 2 * K:
                a_old, _ = self._chunk_buf.pop(0)
                a_next, s_next = self._chunk_buf[0]
                self._chunk_buf[0] = (a_old + a_next, s_next)
            self._chunk_buf.append(
                (
                    np.asarray(action, dtype=np.float32),
                    np.array(self.downsampled_ranges, dtype=np.float32),
                )
            )
        if (
            len(self._chunk_buf) >= K
            and len(self._inflight_q) < self.config.async_depth
        ):
            chunk, self._chunk_buf = self._chunk_buf[:K], self._chunk_buf[K:]
            actions = np.stack([c[0] for c in chunk])
            scans = np.stack([c[1] for c in chunk])
            t_mono = time.monotonic()
            self._last_dispatch_mono = t_mono
            self.state, poses_dev = self._step_many(self.state, actions, scans)
            self._enqueue_dispatch(poses_dev, t_mono, K)
        return self._harvest_inflight(now)

    def _step_many(self, state, actions, scans):
        """``filter.step_many`` with K draws from ``draws`` when given."""
        if self.draws is None:
            return self.filter.step_many(state, actions, scans)
        steps = [self.draws.step(False) for _ in range(len(actions))]
        return self.filter.step_many(
            state, actions, scans,
            u0=np.stack([np.float32(d["u0"]) for d in steps]),
            noise=np.stack([d["noise"] for d in steps]),
        )

    def _harvest_inflight(self, now: float) -> np.ndarray | None:
        """Harvest every finished in-flight dispatch, oldest first. An
        entry carries ``count`` corrections (1 for plain async, K for a
        chunk); all its poses reach the sinks, the freshest drives the
        anchor/monitor, and the overall freshest is returned."""
        pose = None
        while self._inflight_q:
            readback, t_disp, count = self._inflight_q[0]
            if not readback.ready() and len(self._inflight_q) < self.config.async_depth:
                break
            if pose is not None:
                # a previous iteration of THIS harvest loop produced a
                # pose the caller will never see — publish it here so
                # sinks receive every correction
                self.publish_correction(now, pose)
            arr, q_host = readback.wait()
            arr = arr.astype(np.float64)
            if count > 1:
                # intermediate corrections of the chunk: sinks only — the
                # chunk's final pose is the one that refreshes the anchor
                for mid in arr[:-1]:
                    self.publish_correction(now, mid)
                pose = arr[-1]
            else:
                pose = arr
            self._inflight_q.popleft()
            t_now = time.monotonic()
            # Two times per harvested dispatch: the MARGINAL time (from
            # max(dispatch, previous harvest) to now) is what this dispatch
            # added, the honest cost for TimingStats; the STALENESS (now
            # minus dispatch) is how old the freshest scan behind this pose
            # is, and drives the anchor's delay compensation.
            base = (
                t_disp
                if self._last_harvest_mono is None
                else max(t_disp, self._last_harvest_mono)
            )
            self._last_harvest_mono = t_now
            self.stats.total_mcl_time += (t_now - base) * 1e3
            self.stats.measurement_count += count
            self._post_correction(
                pose,
                log_q=float(q_host),
                delay_ms=(t_now - t_disp) * 1e3,
                # staleness is measured exactly, so no heuristic inflation
                # factor (the reference's 1.5x pads an ESTIMATED average
                # step time, reference :790-806)
                delay_factor=1.0,
            )
        return pose

    def _post_correction(
        self,
        pose: np.ndarray,
        log_q: float | None = None,
        delay_ms: float | None = None,
        delay_factor: float | None = None,
    ) -> None:
        """Anchor refresh + auto-reinit monitor + periodic logging — the
        tail of the reference's timer_update (:781-827). ``log_q``
        overrides the quality fed to the reinit monitor; ``delay_ms`` /
        ``delay_factor`` override the anchor's delay compensation (the
        async path passes the harvested correction's own quality scalar
        and exact measured staleness)."""
        self.inferred_pose = pose

        # anchor refresh with delay compensation (reference :781-807)
        if self.odom_initialized and (
            self.tracker.pose_initialized_from_seed
            or (self.iters > 0 and is_pose_valid(pose, self.config.max_pose_range))
        ):
            self.tracker.anchor(
                pose,
                avg_mcl_ms=(
                    (self.stats.avg_total_ms if delay_ms is None else delay_ms)
                    if self.delay_compensation_enabled
                    else 0.0
                ),
                delay_compensation_factor=(
                    self.config.delay_compensation_factor
                    if delay_factor is None
                    else delay_factor
                ),
            )

        # after the anchor refresh so a triggered re-init (which deactivates
        # the tracker) is not immediately re-anchored at the stale pose
        if self.config.auto_reinit:
            self._update_reinit_monitor(
                self.filter.log_quality(self.state) if log_q is None else log_q
            )

        if self.iters % 100 == 0:
            self.log(
                f"MCL iter {self.iters}: "
                f"[{pose[0]:.2f}, {pose[1]:.2f}, {pose[2]:.2f}]"
            )
        if self.iters % 200 == 0:
            self.stats.fill_device_phases(TRACER)
            self.stats.print_stats(self.log)
            self.stats.reset()

    # ----- auto re-localization (Augmented MCL w_fast/w_slow monitor) -----
    def _update_reinit_monitor(self, q: float) -> None:
        """Track short/long EMAs of the log measurement quality (compared
        in log space — the quantities underflow linear space at 1080
        beams). Two recovery modes (``config.reinit_mode``):

        * ``"reinit"``: a sustained collapse of the fast average below
          ``reinit_ratio_threshold`` × the slow average triggers a full
          global re-initialization — the automatic analogue of the
          reference's /clicked_point recovery (reference :376-379).
        * ``"inject"``: Augmented MCL (Probabilistic Robotics §8.3) —
          every correction replaces a ``max(0, 1 - w_fast/w_slow)``
          fraction of particles (gain-scaled, capped) with uniform
          free-space draws.
        """
        cfg = self.config
        if self._q_slow is None or self._q_fast is None:
            self._q_slow = self._q_fast = q
            return
        self._q_fast += cfg.reinit_alpha_fast * (q - self._q_fast)
        self._q_slow += cfg.reinit_alpha_slow * (q - self._q_slow)
        if cfg.reinit_mode == "inject":
            if self.iters < cfg.reinit_min_iters:
                return
            # EMAs live in log space: w_fast / w_slow = exp(diff)
            ratio = math.exp(min(self._q_fast - self._q_slow, 0.0))
            self._inject_fraction = min(
                cfg.reinit_inject_gain * (1.0 - ratio),
                cfg.reinit_inject_max,
            )
            return
        if self._reinit_holdoff > 0:
            self._reinit_holdoff -= 1
            return
        if self.iters < cfg.reinit_min_iters:
            return
        if self._q_fast < self._q_slow + math.log(cfg.reinit_ratio_threshold):
            self._bad_count += 1
        else:
            self._bad_count = 0
        if self._bad_count >= cfg.reinit_patience:
            self.log(
                "Auto re-localization: measurement quality collapsed "
                f"(fast {self._q_fast:.1f} vs slow {self._q_slow:.1f} nats)"
            )
            self.auto_reinits += 1
            self._bad_count = 0
            self._reinit_holdoff = cfg.reinit_cooldown
            self._q_slow = self._q_fast = None
            self.initialize_global()

    # ----- sinks (the ROS-free publication surface, reference :857-983) -----
    def add_sink(self, sink: Sink) -> None:
        self.sinks.append(sink)

    def close_sinks(self) -> None:
        for s in self.sinks:
            s.close()

    def _wants(self, topic: str) -> bool:
        """Subscriber-gating analogue (reference :928-934)."""
        return any(s.wants(topic) for s in self.sinks)

    def _publish(self, topic: str, t: float, payload: dict) -> None:
        for s in self.sinks:
            if s.wants(topic):
                s.publish(topic, t, payload)

    def publish_tick(self, t: float) -> None:
        """Per-tick outputs: TF + odom from the pose priority chain —
        published every tick whether or not MCL ran (reference :839-845,
        :857-889)."""
        if not self.sinks:
            return
        if self._wants("tf"):
            self._publish("tf", t, {"pose": self.base_link_pose()})
        if self.config.publish_odom and self._wants("odom"):
            snap = self.tracker.snapshot()
            self._publish(
                "odom", t,
                {
                    "pose": self.base_link_pose(),
                    "velocity": snap.velocity,
                    "angular_velocity": snap.angular_velocity,
                },
            )

    def publish_correction(self, t: float, pose: np.ndarray) -> None:
        """Per-correction outputs: inferred pose + particle cloud
        (reference visualize :923-983), gated on ``viz`` and sink demand.
        The cloud is the current state's, read back from the card: with
        corrections in flight that read waits for them."""
        if not self.sinks or not self.config.viz:
            return
        # particles BEFORE pose: a renderer drawing a frame on the pose
        # event uses the latest cloud, so this order pairs correction k's
        # pose with correction k's cloud (not k-1's)
        if self._wants("particles"):
            self._publish("particles", t, {"cloud": self.particle_cloud()})
        if self._wants("pose"):
            self._publish("pose", t, {"pose": np.asarray(pose)})

    # ----- outputs (reference :857-983) -----
    def current_pose(self) -> np.ndarray:
        """The pose priority chain; the particle mean is read back only
        when the chain reaches it."""
        state = self.state
        particle_mean = None if state is None else (
            lambda: state.particles.cpu().numpy().mean(axis=0)
        )
        return self.tracker.current_pose(self.inferred_pose, particle_mean)

    def base_link_pose(self) -> np.ndarray:
        """map->base_link output pose (lidar offset applied, reference :857-866)."""
        return apply_vehicle_offset(self.current_pose(), self.config.lidar_offset_x)

    def particle_cloud(self) -> np.ndarray:
        """Visualization cloud, weighted-downsampled to max_viz_particles
        (reference :944-960), lidar offset applied (reference :967-977)."""
        if self.state is None:
            raise RuntimeError("the node has no filter state")
        particles = self.state.particles.cpu().numpy()
        w = torch.softmax(self.state.log_weights, dim=0).cpu().numpy()
        if particles.shape[0] > self.config.max_viz_particles:
            idx = self.rng.choice(
                particles.shape[0],
                self.config.max_viz_particles,
                p=w / w.sum(),
            )
            particles = particles[idx]
        return apply_vehicle_offset(particles, self.config.lidar_offset_x)

    # ----- trace replay -----
    def replay(
        self,
        trace: Trace,
        realtime_compensation: bool = False,
    ) -> ReplayResult:
        """Replay a recorded trace through the engine.

        One correction runs per scan event (the steady-state behavior of
        the reference, whose ~200 Hz timer is gated by the ~6 Hz compute).
        ``realtime_compensation`` re-enables wall-clock delay compensation
        — only meaningful when replaying in real time.
        """
        self.delay_compensation_enabled = realtime_compensation
        self._in_replay = True
        times, poses, tracked = [], [], []
        wall0 = time.perf_counter()
        warm_wall = None  # wall clock after the FIRST correction: the
        # first update pays one-time cost (LUT build, kernel build) that
        # must not pollute the steady-state updates/s
        for ev in TraceReader(trace):
            if ev.kind == "odom":
                op = trace.odom_pose[ev.index]
                tw = trace.odom_twist[ev.index]
                self.on_odometry(op[0], op[1], op[2], tw[0], tw[1], stamp=ev.t)
            else:
                self.on_scan(
                    trace.scan_ranges[ev.index], beam_angles=trace.beam_angles
                )
                pose = self.update(now=ev.t)
                self.publish_tick(ev.t)
                if pose is not None:
                    times.append(ev.t)
                    poses.append(pose)
                    tracked.append(self.current_pose())
                    self.publish_correction(ev.t, pose)
                    if warm_wall is None:
                        warm_wall = time.perf_counter()
        self._in_replay = False
        wall = time.perf_counter() - wall0
        if warm_wall is not None and len(times) > 1:
            # steady-state rate over corrections after the warmup one
            steady = (len(times) - 1) / max(
                time.perf_counter() - warm_wall, 1e-9
            )
        else:
            steady = len(times) / wall if wall > 0 else 0.0

        times_a = np.asarray(times)
        poses_a = np.asarray(poses).reshape(-1, 3)
        tracked_a = np.asarray(tracked).reshape(-1, 3)
        rmse_xy = rmse_th = None
        if trace.truth_t is not None and len(times_a):
            rmse_xy, rmse_th = trajectory_rmse(
                times_a, poses_a, trace.truth_t, trace.truth_pose
            )
        return ReplayResult(
            times=times_a,
            poses=poses_a,
            tracked=tracked_a,
            rmse_xy=rmse_xy,
            rmse_theta=rmse_th,
            updates_per_sec=steady,
            stats=self.stats,
        )

    def replay_chained(self, trace: Trace, chunk: int = 64) -> ReplayResult:
        """Throughput replay: ``chunk`` corrections per
        ``ParticleFilter.step_many`` call, with one wait for the card per
        chunk (the first, which pays the build, and the last full one
        bound the timed window). The per-scan action integrates every
        odometry twist between consecutive scans (``trace_actions``); the
        dual-rate tracker/pose-priority chain is NOT exercised — use
        :meth:`replay` to test the live loop, this method to evaluate
        filter quality/throughput. Recorded as the ``TRACER`` span
        ``node.replay_chained`` over each chunk's ``filter.step_many``
        (request: the chunk's first scan index), ``node.chunk_sync`` and
        ``node.readback``.
        """
        token = TRACER.open(_REPLAY_CHAINED)
        try:
            return self._replay_chained(trace, chunk)
        finally:
            TRACER.close(token)

    def _replay_chained(self, trace: Trace, chunk: int) -> ReplayResult:
        if len(trace.scan_t) == 0:
            raise ValueError("trace has no scans")
        self.on_scan(trace.scan_ranges[0], beam_angles=trace.beam_angles)
        stride = self.config.angle_step
        scans = np.ascontiguousarray(
            trace.scan_ranges[:, ::stride], dtype=np.float32
        )
        st = np.asarray(trace.scan_t, np.float64)
        actions = trace_actions(trace.odom_t, trace.odom_twist, st)

        k = len(st)
        # full chunks first; the remainder runs as one smaller tail call
        # rather than padding with duplicated corrections — padded steps
        # would advance the COMMITTED state (and any checkpoint) past the
        # real trace
        state = self.state
        pose_chunks = []
        full_end = k - (k % chunk)  # tail runs outside the steady window
        wall0 = time.perf_counter()
        warm_wall = steady_end = None
        for c0 in range(0, full_end, chunk):
            TRACER.request = c0
            state, p = self._step_many(
                state, actions[c0 : c0 + chunk], scans[c0 : c0 + chunk]
            )
            pose_chunks.append(p)
            if warm_wall is None:
                _sync(p)  # the first chunk pays the build
                warm_wall = time.perf_counter()
        if pose_chunks:
            _sync(pose_chunks[-1])
            steady_end = time.perf_counter()
        if full_end < k:
            TRACER.request = full_end
            state, p = self._step_many(state, actions[full_end:], scans[full_end:])
            pose_chunks.append(p)
        t0 = time.perf_counter_ns()
        poses_a = torch.cat(pose_chunks).cpu().numpy().astype(np.float64)
        TRACER.record(_READBACK, t0, time.perf_counter_ns())
        wall = time.perf_counter() - wall0
        done = full_end - min(chunk, full_end)  # after the warmup chunk
        steady = (
            done / max(steady_end - warm_wall, 1e-9)
            if done > 0
            else k / max(wall, 1e-9)
        )

        self.state = state
        self.iters += k
        self.stats.measurement_count += k
        self.inferred_pose = poses_a[-1]

        rmse_xy = rmse_th = None
        if trace.truth_t is not None:
            rmse_xy, rmse_th = trajectory_rmse(
                st, poses_a, trace.truth_t, trace.truth_pose
            )
        return ReplayResult(
            times=st,
            poses=poses_a,
            tracked=poses_a.copy(),
            rmse_xy=rmse_xy,
            rmse_theta=rmse_th,
            updates_per_sec=steady,
            stats=self.stats,
        )


def _sync(t: torch.Tensor) -> None:
    """Wait for the card: the ``TRACER`` span ``node.chunk_sync``."""
    if t.device.type == "cuda":
        t0 = time.perf_counter_ns()
        torch.cuda.synchronize(t.device)
        TRACER.record(_CHUNK_SYNC, t0, time.perf_counter_ns())
