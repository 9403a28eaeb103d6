"""The traced run's device trace: a short segment of the cell's own traffic
under ``torch.profiler``, read into device rows (as ``chip_smoke.py``
``chain_profile`` reads them, commit 2f0b362), the device's busy time and
the idle gaps, each labelled with the benchmark span the host was in.

The profiler sometimes drops events, so the segment's count of
likelihood-kernel rows is held against the wrapper's own launch counter;
a segment that falls short is profiled again.
"""

from __future__ import annotations

import time

SPAN_LABELS = {
    "bench.dispatch": "graph replay call (filter step entry)",
    "bench.update": "node update: host work and pose readback",
    "bench.replay": "replay_chained: host work, sync and readback",
    "bench.init": "episode start",
    "bench.wait": "waiting for the next tick",
    "bench.feed": "feeding scans and odometry",
    "bench.segment": "benchmark loop",
}
LUT_KERNEL = "lut_loglik_kernel"
ATTEMPTS = 3


def _times(e) -> tuple[float, float]:
    """(start, end) seconds of a kineto event."""
    if hasattr(e, "start_ns"):
        start = e.start_ns() / 1e9
        return start, start + e.duration_ns() / 1e9
    start = e.start_us() / 1e6
    return start, start + e.duration_us() / 1e6


def _self_device_us(avg) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(avg, name, None)
        if v is not None:
            return float(v)
    return 0.0


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def read_trace(prof) -> dict:
    """Device rows, busy seconds and labelled idle gaps of one profile."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    rows = {}
    for avg in prof.key_averages():
        us = _self_device_us(avg)
        if avg.device_type == cuda and us > 0 and avg.key not in SPAN_LABELS:
            rows[avg.key] = (us, avg.count)
    device, spans, segment = [], [], None
    for e in prof.profiler.kineto_results.events():
        a, b = _times(e)
        if e.device_type() == cuda:
            if e.name() not in SPAN_LABELS:  # the spans' device-side shadows
                device.append((a, b))
        elif e.name() in SPAN_LABELS:
            spans.append((a, b, e.name()))
            if e.name() == "bench.segment":
                segment = (a, b)
    busy = _merge(device)
    gaps = {}
    if segment is not None:
        edges = [segment[0]] + [x for iv in busy for x in iv] + [segment[1]]
        for a, b in zip(edges[0::2], edges[1::2]):
            a, b = max(a, segment[0]), min(b, segment[1])
            if b <= a:
                continue
            mid = 0.5 * (a + b)
            inside = [s for s in spans if s[0] <= mid <= s[1]]
            name = min(inside, key=lambda s: s[1] - s[0])[2] if inside else "bench.segment"
            gaps[SPAN_LABELS[name]] = gaps.get(SPAN_LABELS[name], 0.0) + (b - a)
    busy_s = sum(min(b, segment[1]) - max(a, segment[0]) for a, b in busy
                 if segment and b > segment[0] and a < segment[1]) if segment else 0.0
    return dict(rows=rows, busy_s=busy_s, gaps=gaps,
                window_s=(segment[1] - segment[0]) if segment else 0.0)


def profile_segment(session, run_segment, launch_count) -> dict:
    """``run_segment()`` (returns its corrections) under the profiler, with
    the benchmark's spans on; again where the likelihood kernel's rows
    fall short of ``launch_count()``'s delta."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from mcl_bench.generator import Spans

    out = None
    for attempt in range(1, ATTEMPTS + 1):
        before = launch_count()
        session.sync()
        Spans.active = True
        try:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                with torch.profiler.record_function("bench.segment"):
                    corrections = run_segment()
                    session.sync()
                wall = time.perf_counter() - t0
        finally:
            Spans.active = False
        out = dict(read_trace(prof), corrections=corrections, wall_s=wall,
                   launches=launch_count() - before, attempts=attempt)
        seen = sum(n for k, (_, n) in out["rows"].items() if LUT_KERNEL in k)
        out["lut_rows"] = seen
        if seen == out["launches"]:
            break
        print(f"profile attempt {attempt}: {seen} {LUT_KERNEL} rows for "
              f"{out['launches']} launches counted", flush=True)
    out["complete"] = out["lut_rows"] == out["launches"]
    rows = out["rows"]
    copies = sum(n for k, (_, n) in rows.items() if k.startswith(("Memcpy", "Memset")))
    out["kernels"] = sum(n for _, n in rows.values()) - copies
    out["busy_us_sum"] = sum(us for us, _ in rows.values())
    lut = [(us, n) for k, (us, n) in rows.items() if LUT_KERNEL in k]
    out["lut_us"] = sum(us for us, _ in lut)
    return out


def breakdown(prof: dict) -> dict:
    top = sorted(prof["rows"].items(), key=lambda kv: -kv[1][0])[:10]
    gaps = sorted(prof["gaps"].items(), key=lambda kv: -kv[1])[:10]
    return dict(device_ops=[[k, us / 1e6] for k, (us, _) in top],
                idle_gaps=[[k, s] for k, s in gaps])
