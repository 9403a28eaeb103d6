"""Timers for work on the card, shared by ``chip_smoke.py``,
``tools/mega_probe.py`` and the filter's ``profile_phases``; and the
runtime's accounting, as in the JAX package's ``utils/timing.py``.

- :class:`TimingStats` and :class:`Stopwatch`: the reference's per-phase
  accumulators and its printed breakdown (reference
  include/particle_filter_cpp/utils.hpp:49-61, src/utils.cpp:93-125).
- :class:`device_trace`: a ``torch.profiler`` session around a block that
  writes a Chrome trace (the JAX package's ``jax.profiler`` trace).
- :func:`call_ms`: milliseconds per call of ``fn`` on a device, CUDA
  events on a card and the host clock on the CPU.

- :func:`event_ms`: CUDA events around back-to-back Python calls (what a
  caller pays per call; host-bound where the call's kernels are shorter
  than its Python).
- :func:`graph_ms`: a CUDA graph of the calls replayed between CUDA
  events, so no host work is inside the timed span; each call still pays
  the graph's gap between kernels.
- :func:`device_ms`: one kernel's own device time from ``torch.profiler``
  (the median of three profiled runs), falling back to :func:`graph_ms`
  where the profiler caught no event of it.
"""

from __future__ import annotations

import statistics
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Callable

import torch


@dataclass
class TimingStats:
    total_mcl_time: float = 0.0  # ms accumulators, as in the reference
    ray_casting_time: float = 0.0
    sensor_model_time: float = 0.0
    motion_model_time: float = 0.0
    resampling_time: float = 0.0
    query_prep_time: float = 0.0
    measurement_count: int = 0

    def reset(self) -> None:
        self.total_mcl_time = 0.0
        self.ray_casting_time = 0.0
        self.sensor_model_time = 0.0
        self.motion_model_time = 0.0
        self.resampling_time = 0.0
        self.query_prep_time = 0.0
        self.measurement_count = 0

    @property
    def avg_total_ms(self) -> float:
        if self.measurement_count == 0:
            return 0.0
        return self.total_mcl_time / self.measurement_count

    def print_stats(self, logger: Callable[[str], None] = print) -> None:
        """Same layout as reference src/utils.cpp:105-125."""
        if self.measurement_count == 0:
            return
        n = self.measurement_count
        avg_total = self.total_mcl_time / n
        rows = [
            ("Ray casting", self.ray_casting_time / n),
            ("Sensor eval", self.sensor_model_time / n),
            ("Query prep", self.query_prep_time / n),
            ("Motion model", self.motion_model_time / n),
            ("Resampling", self.resampling_time / n),
        ]
        logger(f"=== PERFORMANCE STATS (last {n} iterations) ===")
        hz = 1000.0 / avg_total if avg_total > 0 else float("inf")
        logger(f"Total MCL:        {avg_total:.6f} ms/iter ({hz:.2f} Hz)")
        for name, avg in rows:
            pct = 100.0 * avg / avg_total if avg_total > 0 else 0.0
            logger(f"{name + ':':<18}{avg:.6f} ms/iter ({pct:.2f}%)")
        logger("=====================================")


class Stopwatch:
    """Context manager accumulating wall ms into a TimingStats attribute.
    Work on the card is counted only up to where the block waits for it
    (the node's synchronous update reads its pose back inside)."""

    def __init__(self, stats: TimingStats, attr: str):
        self.stats = stats
        self.attr = attr

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt_ms = (time.perf_counter() - self._t0) * 1000.0
        setattr(self.stats, self.attr, getattr(self.stats, self.attr) + dt_ms)
        return False


class device_trace:
    """A ``torch.profiler`` session (CPU, and CUDA where a card is present)
    around a block; on exit it writes ``trace.json`` (Chrome trace format,
    for chrome://tracing or ui.perfetto.dev) into ``log_dir``::

        with device_trace("/tmp/mcl_trace"):
            state, pose = pf.step(state, action, scan)
    """

    def __init__(self, log_dir: str | Path, log: Callable[[str], None] = print):
        self.log_dir = Path(log_dir)
        self.log = log
        self._prof = None

    def __enter__(self) -> "device_trace":
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=activities)
        self._prof.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        prof, self._prof = self._prof, None
        prof.__exit__(*exc)
        self.log_dir.mkdir(parents=True, exist_ok=True)
        path = self.log_dir / "trace.json"
        prof.export_chrome_trace(str(path))
        self.log(f"device trace written to {path}")


def call_ms(fn, iters: int, device: torch.device) -> float:
    """Milliseconds per call of ``fn`` over ``iters`` calls after one
    warm-up: :func:`event_ms` on a card, the host clock on the CPU (where
    every call returns finished)."""
    if device.type == "cuda":
        return event_ms(fn, iters)
    fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1e3 / iters


def event_ms(fn, iters: int = 50) -> float:
    """Milliseconds per call between CUDA events around ``iters``
    back-to-back calls of ``fn``, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int = 50, replays: int = 5) -> float:
    """Device milliseconds per call of ``fn`` (all its kernels): a CUDA
    graph of ``iters`` calls, replayed ``replays`` times between CUDA
    events; the median replay over ``iters``. Outputs ``fn`` allocates
    come from the graph's pool and add no device work."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(replays):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def _self_device_us(avg) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(avg, name, None)
        if v is not None:
            return float(v)
    return 0.0


def profile_run(fn, iters: int):
    """Run ``fn`` ``iters`` times under torch.profiler (CPU + CUDA). Returns
    ({name: (device us, count)} over the device-side events, host wall
    seconds). CPU operator rows also carry their kernels' device time, so
    only rows of device type CUDA are kept."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = {}
    for avg in prof.key_averages():
        us = _self_device_us(avg)
        if avg.device_type == torch.autograd.DeviceType.CUDA and us > 0:
            rows[avg.key] = (us, avg.count)
    return rows, wall


def device_ms(fn, kernel: str, iters: int = 20, reps: int = 3) -> dict:
    """A kernel's own device milliseconds per launch: the profiler's
    device time summed over events whose name holds ``kernel``, divided
    by their count, as the median of ``reps`` profiled runs of ``iters``
    launches (one slow launch moves a mean of 20 by several percent at
    5 us); where the profiler shows none, :func:`graph_ms` of ``fn``.
    Returns dict(ms, source)."""
    means = []
    for _ in range(reps):
        rows, _ = profile_run(fn, iters)
        hits = [(us, n) for key, (us, n) in rows.items() if kernel in key]
        if hits:
            means.append(sum(us for us, _ in hits) / 1e3 / sum(n for _, n in hits))
    if means:
        return dict(ms=statistics.median(means), source="profiler")
    return dict(ms=graph_ms(fn, iters), source="cuda_graph")
