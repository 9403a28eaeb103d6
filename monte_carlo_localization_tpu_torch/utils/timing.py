"""Timers for work on the card, shared by ``chip_smoke.py`` and
``tools/mega_probe.py``.

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

import torch


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
