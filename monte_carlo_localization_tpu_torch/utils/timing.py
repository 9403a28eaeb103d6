"""Timers for work on the card, shared by ``chip_smoke.py``,
``tools/mega_probe.py`` and the filter's ``profile_phases``; and the
runtime's accounting, as in the JAX package's ``utils/timing.py``.

- :class:`TimingStats` and :class:`Stopwatch`: the reference's per-phase
  accumulators and its printed breakdown (reference
  include/particle_filter_cpp/utils.hpp:49-61, src/utils.cpp:93-125).
- :class:`device_trace`: a ``torch.profiler`` session around a block that
  writes a Chrome trace (the JAX package's ``jax.profiler`` trace), with
  the program's own spans on an "mcl" track beside the device rows.
- :data:`TRACER` (:class:`Tracer`): the program's spans and counters,
  recorded where the work happens (the filter's entries, the graph call's
  parts, the node's phases) and, from inside each step graph, the device
  time of the correction's phases (:class:`DeviceMarks`).
- :data:`COUNTS` (:class:`Counts`): every kernel launch count of the
  process (each kernel's, each wrapper's own) and the collectives' calls
  and bytes, each a :class:`Count`; a graph's capture records what its
  thread adds (:meth:`Counts.recording`) and each replay adds it again.
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

import collections
import contextlib
import itertools
import json
import operator
import os
import statistics
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from time import perf_counter_ns
from typing import Callable

import numpy as np
import torch
from torch.autograd import profiler as _autograd_profiler


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

    def fill_device_phases(self, tracer: "Tracer") -> None:
        """Resampling, motion and sensor times from the device phases that
        ``tracer`` sampled from inside the step graphs (the median of its
        ring, a correction; the fused likelihood kernel's ray casting and
        query preparation are inside the sensor time). Fields with no
        sample (eager and CPU runs) stay as they are."""
        n = self.measurement_count
        for attr, name in (("resampling_time", "device.resample"),
                           ("motion_model_time", "device.motion"),
                           ("sensor_model_time", "device.likelihood")):
            us = tracer.p50_us(name)
            if us is not None:
                setattr(self, attr, us * 1e-3 * n)

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


RING = 8192  # durations and self times kept for each name (a power of two)
MASK = RING - 1
TIMELINE = 1 << 17  # timeline records kept while a profiler runs
DEPTH = 32  # open spans kept a thread; deeper ones are counted as closed, not timed
# corrections replayed between two readings of a graph's device marks: a
# reading (a query and four elapsed times) takes 30-70 µs of host, which a
# live tick would pay in full, so one tick in 128 does; a chunk of 64 reads
# every other call where its replay has finished
READ_EVERY = 128
MARKS = 5  # boundaries of a correction: start, resample, motion, likelihood, pose
MCL_TID = 1  # the "mcl" track's thread id in an exported trace (real ones are large)
DEVICE_PHASES = ("device.resample", "device.motion", "device.likelihood",
                 "device.normalize_pose")


class Series:
    """One name's counters: how many were recorded, and the last
    :data:`RING` durations and, for a span closed by
    :meth:`Tracer.close`, self times in ns (the duration less what its
    children covered; a leaf's and a device phase's self time is its
    duration). Each name is recorded from one thread at a time, as one
    filter's calls are."""

    __slots__ = ("name", "count", "dur", "own", "closed")

    def __init__(self, name: str):
        self.name = name
        self.count = 0
        self.dur = [0] * RING
        self.own = [0] * RING
        self.closed = False  # self times kept in ``own``

    @property
    def last_ns(self) -> int:
        """The latest duration (0 before the first)."""
        return self.dur[(self.count - 1) & MASK] if self.count else 0

    def ring(self) -> tuple[np.ndarray, np.ndarray]:
        """(durations, self times) in the ring, ns."""
        n = min(self.count, RING)
        dur = np.asarray(self.dur[:n], np.float64)
        return dur, np.asarray(self.own[:n], np.float64) if self.closed else dur


class _Frames:
    """A thread's open spans, in arrays of :data:`DEPTH` made once, and
    the :class:`DeviceMarks` a capture on this thread has open."""

    __slots__ = ("depth", "series", "start", "child", "sid", "sink")

    def __init__(self):
        self.depth = 0
        self.series = [None] * DEPTH
        self.start = [0] * DEPTH
        self.child = [0] * DEPTH
        self.sid = [0] * DEPTH
        self.sink = None


class _Local(threading.local):
    def __init__(self):
        self.frames = _Frames()


class Tracer:
    """The program's spans and counters (one process-wide instance,
    :data:`TRACER`).

    A span has a name, a start and an end (``time.perf_counter_ns``), the
    span open around it on its thread (its parent) and the request it
    served (:attr:`request`: the node's iteration on a tick, a chunk's
    first scan index in a replay). Hot paths keep a :class:`Series` per
    name (:meth:`name`) and take stamps themselves: :meth:`open` and
    :meth:`close` around a span with children, :meth:`record` or
    :meth:`chain` for leaves whose stamps they took.

    Always on: each name's count and ring of durations and self times
    (:meth:`summary`); nothing is allocated a span. The kernels' named
    launch counts (:data:`COUNTS`, which graph replays advance) join the
    summary. Only while a
    ``torch.profiler`` session runs (a flag read) does a span also go into
    :attr:`timeline`, a bounded buffer of records with start and end in
    the epoch nanoseconds of the profiler's own events (one offset to
    ``time.time_ns()``, sampled once), which :class:`device_trace` writes
    beside the device rows. The tracer never opens a profiler range.
    """

    def __init__(self):
        self.series: dict[str, Series] = {}
        # (name, start, end, span id, parent id, request, thread), epoch ns
        self.timeline: collections.deque = collections.deque(maxlen=TIMELINE)
        self.request = 0
        self.marking = 0  # DeviceMarks open, on any thread
        self._local = _Local()
        self._ids = itertools.count(1)
        self._lock = threading.Lock()
        t0 = perf_counter_ns()
        wall = time.time_ns()
        self.epoch_offset_ns = wall - (t0 + perf_counter_ns()) // 2

    def name(self, name: str) -> Series:
        """The series of ``name``, made on first use."""
        with self._lock:
            s = self.series.get(name)
            if s is None:
                s = self.series[name] = Series(name)
            return s

    def reset(self) -> None:
        """Forget every count, ring and record (the series stay, so the
        hot paths' references stay live)."""
        for s in self.series.values():
            s.count = 0
            s.closed = False
        self.timeline.clear()
        self.request = 0

    # ----- recording -----
    def open(self, series: Series, start: int | None = None) -> int:
        """Open a span of ``series`` on this thread, from now or from
        ``start`` (a ``perf_counter_ns`` taken before the caller knew it
        would record); returns the token :meth:`close` takes."""
        f = self._local.frames
        d = f.depth
        f.depth = d + 1
        if d < DEPTH:
            f.series[d] = series
            f.child[d] = 0
            # ids only for the timeline: a span opened before the profiler has none
            f.sid[d] = next(self._ids) if _autograd_profiler._is_profiler_enabled else 0
            f.start[d] = perf_counter_ns() if start is None else start
        return d

    def close(self, token: int) -> None:
        """Close the span ``token`` opened (and whatever an exception left
        open inside it)."""
        end = perf_counter_ns()
        f = self._local.frames
        f.depth = token
        if token >= DEPTH:
            return
        start = f.start[token]
        dur = end - start
        s = f.series[token]
        i = s.count & MASK
        s.count += 1
        s.dur[i] = dur
        s.own[i] = dur - f.child[token]
        s.closed = True
        if token:
            f.child[token - 1] += dur
        if _autograd_profiler._is_profiler_enabled:
            self._emit(s.name, start, end, f.sid[token], f.sid[token - 1] if token else 0)

    def record(self, series: Series, start: int, end: int) -> None:
        """A leaf span from ``start`` to ``end`` (``perf_counter_ns``)
        under the span open on this thread."""
        self.chain((series,), (start, end))

    def chain(self, series: tuple, stamps) -> None:
        """Consecutive leaf spans under the span open on this thread:
        ``series[i]`` from ``stamps[i]`` to ``stamps[i + 1]``."""
        a = stamps[0]
        k = 0
        for s in series:
            k += 1
            b = stamps[k]
            i = s.count & MASK
            s.count += 1
            s.dur[i] = b - a
            a = b
        f = self._local.frames
        d = f.depth
        if 0 < d <= DEPTH:
            f.child[d - 1] += a - stamps[0]
        if _autograd_profiler._is_profiler_enabled:
            parent = f.sid[d - 1] if 0 < d <= DEPTH else 0
            for k, s in enumerate(series):
                self._emit(s.name, stamps[k], stamps[k + 1], next(self._ids), parent)

    def value(self, series: Series, ns: int) -> None:
        """A sample that is not a span of this thread (a device phase)."""
        i = series.count & MASK
        series.count += 1
        series.dur[i] = ns

    def _emit(self, name: str, start: int, end: int, sid: int, parent: int) -> None:
        off = self.epoch_offset_ns
        self.timeline.append((name, start + off, end + off, sid, parent, self.request,
                              threading.get_ident()))

    # ----- device marks -----
    def mark(self) -> None:
        """A boundary of the correction being captured (``correct()``):
        records the next event of the :class:`DeviceMarks` open on this
        thread, up to :data:`MARKS`; anywhere else a flag check."""
        if self.marking:
            sink = self._local.frames.sink
            if sink is not None:
                sink.record()

    # ----- reading -----
    def p50_us(self, name: str) -> float | None:
        """The median duration in the ring of ``name``, µs; None with no sample."""
        s = self.series.get(name)
        if s is None or not s.count:
            return None
        return float(np.median(s.ring()[0])) / 1e3

    def summary(self) -> dict:
        """Per name with samples: count, p50 and p95 duration and p50 self
        time (µs) over its ring; per named count of :data:`COUNTS` above 0
        (which :meth:`reset` leaves): its count."""
        out = {}
        for name, s in list(self.series.items()):
            if not s.count:
                continue
            dur, own = s.ring()
            p50, p95 = np.percentile(dur, [50, 95]) / 1e3
            out[name] = dict(count=s.count, p50_us=float(p50), p95_us=float(p95),
                             self_p50_us=float(np.median(own)) / 1e3)
        for name, count in list(COUNTS.named.items()):
            if count.n:
                out[name] = dict(count=count.n)
        return out

    def chrome_events(self, since_ns: int = 0, base_ns: int = 0) -> list[dict]:
        """The timeline's records that start at or after ``since_ns``
        (epoch ns) as Chrome-trace events on one "mcl" track, ``ts`` in µs
        from ``base_ns``, request and parent ids in ``args``."""
        pid, tid = os.getpid(), MCL_TID
        events = [dict(ph="M", name="thread_name", pid=pid, tid=tid, args=dict(name="mcl"))]
        for name, start, end, sid, parent, request, thread in list(self.timeline):
            if start < since_ns:
                continue
            events.append(dict(ph="X", cat="mcl", name=name, pid=pid, tid=tid,
                               ts=(start - base_ns) / 1e3, dur=(end - start) / 1e3,
                               args=dict(request=request, span=sid, parent=parent,
                                         thread=thread)))
        return events


class Count:
    """One count (``n``): a kernel's launches, a wrapper's own, or a
    collective's calls or bytes. It grows only through :meth:`Counts.add`,
    so that a graph's capture records it; a caller may set ``n`` (a
    reset)."""

    __slots__ = ("n",)

    def __init__(self):
        self.n = 0

    @staticmethod
    def attr(name: str) -> property:
        """A property over the :class:`Count` an instance holds in
        ``name``: reads its ``n`` and, for a caller's reset, sets it."""
        get = operator.attrgetter(name)
        return property(lambda self: get(self).n,
                        lambda self, value: setattr(get(self), "n", value))


class Recording:
    """What one thread added inside :meth:`Counts.recording`: amounts by
    :class:`Count` (``increments``) and the attributes set by
    :meth:`Counts.keep` (``kept``). :meth:`replay` applies both, with no
    lookup by name."""

    def __init__(self):
        self.increments: dict[Count, int] = {}
        self.kept: dict[tuple, tuple] = {}

    def replay(self) -> None:
        for count, n in self.increments.items():
            count.n += n
        for obj, name, value in self.kept.values():
            setattr(obj, name, value)


class Counts:
    """Every count of the process (one instance, :data:`COUNTS`). A
    kernel's launches are the :class:`Count` named for it (:meth:`name`,
    shown by ``TRACER.summary()``); a wrapper keeps its own counts as
    :class:`Count` objects, read through :meth:`Count.attr` properties.
    A CUDA graph's replays launch kernels without Python seeing it, so
    ``utils/graphs.py`` captures inside :meth:`recording` and adds the
    :class:`Recording` on every replay."""

    def __init__(self):
        self.named: dict[str, Count] = {}
        self._local = threading.local()

    def name(self, name: str) -> Count:
        """The count named ``name``, made on first use."""
        count = self.named.get(name)
        return count if count is not None else self.named.setdefault(name, Count())

    def add(self, count: Count, n: int = 1) -> None:
        """Add ``n`` to ``count``, or record it in this thread's recording."""
        rec = getattr(self._local, "rec", None)
        if rec is None:
            count.n += n
        else:
            rec.increments[count] = rec.increments.get(count, 0) + n

    def keep(self, obj, name: str, value) -> None:
        """Set ``obj``'s attribute ``name`` to ``value``, and again on every
        replay of this thread's recording (the dedup query's
        ``last_overflow``: the device tensor each replay writes)."""
        setattr(obj, name, value)
        rec = getattr(self._local, "rec", None)
        if rec is not None:
            rec.kept[id(obj), name] = (obj, name, value)

    @contextlib.contextmanager
    def recording(self):
        """Inside, what this thread adds goes into the :class:`Recording`
        yielded, not into the counts; other threads count as ever. An
        inner recording takes what is added inside it."""
        outer, self._local.rec = getattr(self._local, "rec", None), Recording()
        try:
            yield self._local.rec
        finally:
            self._local.rec = outer


COUNTS = Counts()


class DeviceMarks:
    """The device phases of the first correction a CUDA graph captures:
    :data:`MARKS` timing CUDA events recorded as event nodes of the graph
    (``external=True``) by :meth:`Tracer.mark` while this is open on the
    capturing thread, so a graph holds :data:`MARKS` of them whatever its
    number of corrections (which it counts). Each hangs on a branch of the
    graph (a side stream that waits for the work before it; the capture's
    stream joins it at the end), so no kernel waits for an event node.
    Every replay records them again; :meth:`phases_ns` reads the latest
    replay's four phases once :meth:`ready`. ``make_event`` stands in for
    the CUDA event, and the events are then recorded in line (tests)."""

    def __init__(self, tracer: Tracer, make_event: Callable | None = None):
        self.side = None
        if make_event is None:
            self.side = torch.cuda.Stream()

            def make_event():
                ev = torch.cuda.Event(enable_timing=True, external=True)
                ev.record()  # made here, outside the capture
                return ev
        self.tracer = tracer
        self.events = [make_event() for _ in range(MARKS)]
        self.recorded = 0
        self.marked = 0  # marks the capture passed, of every correction
        self._outer = None

    def __enter__(self) -> "DeviceMarks":
        f = self.tracer._local.frames
        self._outer, f.sink = f.sink, self
        with self.tracer._lock:
            self.tracer.marking += 1
        return self

    def __exit__(self, exc_type, *exc) -> None:
        self.tracer._local.frames.sink = self._outer
        with self.tracer._lock:
            self.tracer.marking -= 1
        if self.side is not None and self.recorded and exc_type is None:
            torch.cuda.current_stream().wait_stream(self.side)  # the branch joins

    def record(self) -> None:
        """Record the next mark, after the work captured so far, up to
        :data:`MARKS`; count it either way."""
        self.marked += 1
        if self.recorded == MARKS:
            return
        ev = self.events[self.recorded]
        self.recorded += 1
        if self.side is None:
            ev.record()
        else:
            self.side.wait_stream(torch.cuda.current_stream())
            ev.record(self.side)

    @property
    def complete(self) -> bool:
        return self.recorded == MARKS

    @property
    def corrections(self) -> int:
        """Corrections a replay runs (each marks :data:`MARKS` times)."""
        return self.marked // MARKS

    def ready(self) -> bool:
        """The latest replay has passed the last mark."""
        return self.events[-1].query()

    def phases_ns(self) -> list[int]:
        """Resample, motion, likelihood and normalization-and-pose device
        ns of the latest replay's first correction."""
        ev = self.events
        return [int(a.elapsed_time(b) * 1e6) for a, b in zip(ev, ev[1:])]


TRACER = Tracer()


class device_trace:
    """A ``torch.profiler`` session (CPU, and CUDA where a card is present)
    around a block; on exit it writes ``trace.json`` (Chrome trace format,
    for chrome://tracing or ui.perfetto.dev) into ``log_dir``, with the
    :data:`TRACER` spans recorded inside the block on an "mcl" track, on
    the profiler's clock::

        with device_trace("/tmp/mcl_trace"):
            state, pose = pf.step(state, action, scan)
    """

    def __init__(self, log_dir: str | Path, log: Callable[[str], None] = print):
        self.log_dir = Path(log_dir)
        self.log = log
        self._prof = None
        self._since = 0

    def __enter__(self) -> "device_trace":
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        self._since = time.time_ns()
        self._prof = profile(activities=activities)
        self._prof.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        prof, self._prof = self._prof, None
        prof.__exit__(*exc)
        self.log_dir.mkdir(parents=True, exist_ok=True)
        path = self.log_dir / "trace.json"
        prof.export_chrome_trace(str(path))
        trace = json.loads(path.read_text())
        # the profiler writes ts in µs from baseTimeNanoseconds where it has one
        spans = TRACER.chrome_events(self._since, int(trace.get("baseTimeNanoseconds", 0)))
        trace.setdefault("traceEvents", []).extend(spans)
        path.write_text(json.dumps(trace))
        self.log(f"device trace written to {path} ({len(spans) - 1} program spans)")


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
