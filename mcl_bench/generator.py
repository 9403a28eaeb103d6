"""The general traffic generator: it builds the program for a cell's
configuration and drives it as the cell's mix file says.

``mode: "replay"`` is a closed loop of one client: episodes back to back,
each a start (``MCLNode.initialize_pose`` at the trace's first true pose,
or ``initialize_global``) and ``MCLNode.replay_chained`` over the whole
trace in chunks of ``chunk``. ``mode: "live"`` is an open loop on the
node's timer: a tick is due every ``1 / tick_hz`` s on the host clock;
before each tick the trace's odometry and scans up to the tick's trace
time go in through ``on_odometry`` and ``on_scan``, then one synchronous
``MCLNode.update(now)`` runs, ``now`` the tick's due time on the
schedule. A window longer than the trace starts a new episode.
The host spins until a tick is due: a sleep's wake-up on the card's
machine comes 1-10 ms late at times, and the tick's latency would read
the harness's timer instead of the node.

A ``Recorder`` keeps, for a sample of the window's calls into the filter
drawn from the seed, the state the call started from, what it returned
and where in its episode it ran: what ``check.py`` compares.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import time
from dataclasses import dataclass

import numpy as np

SAMPLED_CALLS = 6  # filter calls compared a run
SAMPLED_STARTS = 2  # episode starts compared a run


@dataclass
class Record:
    episode: int
    step: int  # corrections of the episode before this call
    steps: int  # corrections in this call
    state_in: object
    state_out: object
    poses: object  # (steps, 3) tensor, as the program returned them
    generator_state: object  # the program's generator at the call
    tau: float = 0.0  # live: the tick's trace time
    dt: float = 0.0  # live: seconds since the previous tick


class Reservoir:
    """``k`` items drawn uniformly, from ``rng``, out of a stream of unknown
    length."""

    def __init__(self, k: int, rng: np.random.Generator):
        self.k, self.rng, self.seen, self.items = k, rng, 0, []

    def slot(self) -> int | None:
        i, self.seen = self.seen, self.seen + 1
        if i < self.k:
            self.items.append(None)
            return i
        j = int(self.rng.integers(0, i + 1))
        return j if j < self.k else None


class Spans:
    """Host spans: record_function ranges while a profiler traces, else
    nothing."""

    active = False

    @classmethod
    def span(cls, name: str):
        if not cls.active:
            return contextlib.nullcontext()
        import torch

        return torch.profiler.record_function(name)


class Recorder:
    """Wraps the filter's entry (``step`` or ``step_many``) to keep a
    sample of its calls; the call itself goes through unchanged."""

    def __init__(self, filt, entry: str, rng: np.random.Generator):
        self.calls = Reservoir(SAMPLED_CALLS, rng)
        self.starts = Reservoir(SAMPLED_STARTS, rng)
        self.on = False
        self.episode = self.step = 0
        self.tick = (0.0, 0.0)
        orig = getattr(filt, entry)

        def call(state, actions, *args, **kwargs):
            slot = self.calls.slot() if self.on else None
            gen = state.generator.get_state() if slot is not None else None
            with Spans.span("bench.dispatch"):
                out_state, poses = orig(state, actions, *args, **kwargs)
            steps = 1 if entry == "step" else len(actions)
            if slot is not None:
                self.calls.items[slot] = Record(self.episode, self.step, steps, state,
                                                out_state, poses, gen, *self.tick)
            self.step += steps
            return out_state, poses

        setattr(filt, entry, call)

    def start(self, episode: int, state) -> None:
        self.episode, self.step = episode, 0
        if self.on:
            slot = self.starts.slot()
            if slot is not None:
                self.starts.items[slot] = (episode, state)


class Session:
    """The program under test, built for one cell."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device: str, paths):
        from monte_carlo_localization_tpu_torch.config import MCLConfig
        from monte_carlo_localization_tpu_torch.mapping.grid_map import load_map
        from monte_carlo_localization_tpu_torch.runtime.node import MCLNode
        from monte_carlo_localization_tpu_torch.runtime.trace import Trace

        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, int(seed), device
        mcl = cfg["mcl"]
        fields = {f.name for f in dataclasses.fields(MCLConfig)}
        config = MCLConfig(**{k: v for k, v in mcl.items() if k in fields})
        self.trace = Trace.load(paths(cfg["trace"]))
        gm = load_map(paths(cfg["map"]), max_range_meters=float(mcl["max_range"]), device=device)
        self.node = MCLNode(gm, config, rng_seed=self.seed)
        # the first scan sets the beams: the LUT is built on the card here
        self.node.on_scan(self.trace.scan_ranges[0], beam_angles=self.trace.beam_angles)
        self.mode = traffic["mode"]
        self.recorder = Recorder(self.node.filter, "step_many" if self.mode == "replay" else "step",
                                 np.random.default_rng([self.seed, 1]))
        self.episodes = 0

    @property
    def filter(self):
        return self.node.filter

    def sync(self) -> None:
        if self.device != "cpu":
            import torch

            torch.cuda.synchronize()

    def start_episode(self) -> None:
        with Spans.span("bench.init"):
            if self.cfg["start"] == "pose":
                self.node.initialize_pose(np.asarray(self.trace.truth_pose[0], np.float64))
            else:
                self.node.initialize_global()
        self.recorder.start(self.episodes, self.node.state)
        self.episodes += 1

    # ----- replay: closed loop -----
    def replay_episode(self) -> tuple[int, int]:
        """(corrections, failed) of one episode."""
        self.start_episode()
        n = len(self.trace.scan_t)
        try:
            with Spans.span("bench.replay"):
                res = self.node.replay_chained(self.trace, chunk=int(self.traffic["chunk"]))
        except Exception as e:  # a raising episode fails every correction in it
            print(f"episode {self.episodes - 1} raised: {e!r}", flush=True)
            return n, n
        bad = int(np.sum(~np.all(np.isfinite(res.poses), axis=1))) + n - len(res.poses)
        return n, bad

    def warm_replay(self) -> None:
        """Captures both chunk shapes of an episode (the full chunk and the
        trace's tail) on the constructor's state."""
        self.node.replay_chained(self.trace, chunk=int(self.traffic["chunk"]))
        self.sync()

    def run_replay(self, seconds: float) -> dict:
        t0 = time.perf_counter()
        done = failed = 0
        while True:
            n, bad = self.replay_episode()
            done, failed = done + n, failed + bad
            if time.perf_counter() - t0 >= seconds:
                break
        elapsed = time.perf_counter() - t0
        return dict(attempted=done, failed=failed, updates_per_s=(done - failed) / elapsed)

    # ----- live: open loop on the node's timer -----
    def _feed(self, tau: float) -> None:
        tr = self.trace
        while self._io < len(tr.odom_t) and tr.odom_t[self._io] <= tau:
            p, tw = tr.odom_pose[self._io], tr.odom_twist[self._io]
            self.node.on_odometry(p[0], p[1], p[2], tw[0], tw[1], stamp=float(tr.odom_t[self._io]))
            self._io += 1
        while self._is < len(tr.scan_t) and tr.scan_t[self._is] <= tau:
            self.node.on_scan(tr.scan_ranges[self._is], beam_angles=tr.beam_angles)
            self._is += 1

    def warm_live(self) -> None:
        """Ticks on the constructor's state before the window: the node's
        first update only starts its clock, the next ones capture ``step``."""
        hz = float(self.traffic["tick_hz"])
        self._io = self._is = 0
        self._feed(0.0)
        for j in (-3, -2, -1):
            self.node.update(now=j / hz)
        self.sync()
        self._now = -1 / hz  # the node's clock: it runs on across episodes and windows

    def run_live(self, seconds: float, first_start: bool = True) -> dict:
        hz = float(self.traffic["tick_hz"])
        per_episode = int(math.floor(self.trace.duration * hz)) + 1
        n_ticks = int(round(seconds * hz))
        lat, upd = np.zeros(n_ticks), np.zeros(n_ticks)
        failed = 0
        if first_start:
            self.start_episode()
            self._io = self._is = self._ep_tick = 0
        t0 = time.perf_counter()
        base = self._now
        for i in range(n_ticks):
            if self._ep_tick >= per_episode:
                self.start_episode()
                self._io = self._is = self._ep_tick = 0
            tau, now = self._ep_tick / hz, base + (i + 1) / hz
            self._ep_tick += 1
            due = t0 + i / hz
            with Spans.span("bench.wait"):
                while time.perf_counter() < due:
                    pass
            with Spans.span("bench.feed"):
                self._feed(tau)
            self.recorder.tick = (tau, now - self._now)
            self._now = now
            t_a = time.perf_counter()
            try:
                with Spans.span("bench.update"):
                    pose = self.node.update(now=now)
                ok = pose is not None and bool(np.all(np.isfinite(pose)))
            except Exception as e:
                print(f"tick at {now} raised: {e!r}", flush=True)
                ok = False
            t_b = time.perf_counter()
            failed += not ok
            lat[i], upd[i] = t_b - due, t_b - t_a
        return dict(attempted=n_ticks, failed=failed, latency_s=lat, update_s=upd)

    # ----- by mode -----
    def warm(self) -> None:
        (self.warm_replay if self.mode == "replay" else self.warm_live)()

    def run(self, seconds: float) -> dict:
        self.recorder.on = True
        try:
            return (self.run_replay if self.mode == "replay" else self.run_live)(seconds)
        finally:
            self.recorder.on = False

    def profiled(self) -> dict:
        """The traced segment: one episode (replay) or ``profile_ticks``
        ticks (live) of the cell's traffic under the profiler."""
        from mcl_bench.card import lut_launches
        from mcl_bench.devtrace import profile_segment

        def count():
            return lut_launches(self.filter)

        if self.mode == "replay":
            # the episode again without the profiler, from the same start
            # seed: the same corrections and draws, for the unprofiled wall
            rng = self.node.rng.bit_generator.state
            prof = profile_segment(self, lambda: self.replay_episode()[0], count)
            walls = []
            for _ in range(3):
                self.node.rng.bit_generator.state = rng
                t0 = time.perf_counter()
                self.replay_episode()
                self.sync()
                walls.append(time.perf_counter() - t0)
            prof["wall_plain_s"] = sorted(walls)[1]
            return prof
        ticks = int(self.traffic["profile_ticks"])
        hz = float(self.traffic["tick_hz"])
        return profile_segment(
            self, lambda: self.run_live(ticks / hz, first_start=False)["attempted"], count)

    def facts(self, paths) -> dict:
        """What the per-layer readers take from the program besides the
        window and the trace: graph statistics, the LUT's build time and
        the likelihood kernel's shapes (on-map particles counted by the
        reference's own address math)."""
        from mcl_bench.reference.mapio import load_map, on_map

        gm, state = self.filter.grid_map, self.node.state
        ref_map = load_map(paths(self.cfg["map"]), float(self.cfg["mcl"]["max_range"]))
        return dict(
            graph_stats=list(self.filter.programs.stats().values()),
            lut_build_s=float(gm.lut_build_s),
            shapes=dict(n=state.num_particles, n_on=on_map(ref_map, state.particles.cpu().numpy()),
                        beams=int(self.filter.beam_angles.shape[0]),
                        itemsize=int(gm.range_lut.element_size()),
                        row_map=gm.lut_row_map is not None))

    def samples(self) -> tuple[list, list]:
        """(the sampled calls, the sampled episode starts) of the window."""
        rec = self.recorder
        return ([r for r in rec.calls.items if r is not None],
                [s for s in rec.starts.items if s is not None])
