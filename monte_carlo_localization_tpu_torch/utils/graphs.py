"""CUDA graphs of the filters' step programs: the port's counterpart of
the JAX package's compiled programs, ``jax.jit`` of the step and of its
injection twin and ``jax.jit`` of a ``lax.scan`` over K corrections
(``filter/core.py:483-510``, ``filter/mega.py:110-197``,
``parallel/fleet.py:315-476`` of the JAX package).

A program is a Python function of named float32 input buffers and a
``torch.Generator`` that returns a dict of output tensors: one correction,
or a chunk of K. :class:`Programs` keeps one filter's programs, keyed the
way ``jit``'s cache is (the program, K, N, F, which draws are given), all
in one graph memory pool. On a card each key's first call

1. copies the inputs into static device buffers (host values through
   pinned memory straight into them, :func:`upload` with ``out``);
2. warms up: one eager run on those buffers with the program's own
   generator, on a side stream, so that every lazy cache (``div``'s
   divisors, the LUT query's tables, the mega step's plan and workspace,
   the kernels' library) fills outside the capture and no draw is taken
   from the caller's generator;
3. captures the same run into a ``torch.cuda.CUDAGraph`` on a side
   stream (``capture_error_mode="thread_local"``: the live loop and the
   web view run other threads), with the program's generator registered
   (``register_generator_state``), so that the in-graph ``torch.rand``
   and ``torch.randn`` draw afresh on every replay;

and every call then replays the graph: the caller's generator state is
handed to the program's generator before the replay and taken back
after it, so the caller's generator advances exactly as an eager run
would advance it and draws the same numbers. The outputs come back as
clones, so a later replay never overwrites what a caller holds, and the
inputs are never written. A failed capture raises
:class:`GraphCaptureError` naming the last tensor operation it reached;
nothing falls back to an eager run.

A program may own several generators (the sharded filter's u0
generator and its shard's motion generator): it is then called with a
tuple of the caller's generators, gets a tuple of its own, registers
each, and hands each state in and out around a replay.

Python counts do not move on a replay, so the capture runs inside
``utils/timing.py`` ``COUNTS.recording()``: every count that the
capturing thread adds meanwhile (each kernel launch, through
``ops/_cuda_build.py`` ``launch``, and each ``Collectives``' calls and
bytes) is recorded, not counted, and every later replay adds the
recording, its amounts summed once. The first call leaves the
counts as its eager warm-up left them (a normaliser table filled there
counts once, as on the eager path). The dedup query's ``last_overflow``
is set again to what the capture left: the device tensor that each
replay writes. Launches that other threads make during a capture are
counted as ever, and not recorded.

On the CPU, inside :func:`disable_graphs` (the counterpart of
``jax.disable_jit()``), and while the current stream is already being
captured (a program inside another graph is inlined, as ``jit`` inlines
a jitted function) the function runs eagerly on the caller's tensors.
Each call records its parts as ``TRACER`` spans (``utils/timing.py``)
under the span its caller has open: ``graphs.key`` (the key and the
cache lookup), ``graphs.load``, ``graphs.handoff_in``, ``graphs.launch``
(``graph.replay()``), ``graphs.handoff_out`` (with the counts) and
``graphs.clone``; a key's first call records ``graphs.capture`` instead.
The capture holds :class:`~monte_carlo_localization_tpu_torch.utils.timing.DeviceMarks`:
five timing events at the boundaries of the program's first correction,
event nodes that every replay records again; once ``READ_EVERY``
corrections have been replayed since the last reading, a call reads the
previous replay's phases into the tracer before its own replay, if they
have passed, and never waits for them.

One rule more is the callers': a program whose body calls a collective
of a group that stages through the host (gloo: ``Collectives.stages_on_host``,
a card-to-host copy each call) is not handed to :class:`Programs` at all
but run by :func:`run_eager`, decided from the group's backend before any
capture; a one-shard world and an NCCL group are captured. No capture
error is caught to fall back to an eager run; the cyclic garbage
collector is paused while a program is captured
(:func:`collector_paused`). One filter's programs
share a pool, so they replay on one stream at a time, as one filter's
steps do.
"""

from __future__ import annotations

import contextlib
import gc
import threading
import time
from time import perf_counter_ns
from typing import Callable

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from monte_carlo_localization_tpu_torch.utils.device import upload
from monte_carlo_localization_tpu_torch.utils.timing import (
    COUNTS,
    DEVICE_PHASES,
    READ_EVERY,
    TRACER,
    DeviceMarks,
)

_lock = threading.Lock()
_disabled = 0
# captures in progress, and whether the cyclic collector was on before them
_collector_held = 0
_collector_was_on = False

# a graph call's parts (``TRACER`` spans under the filter's entry)
_KEY = TRACER.name("graphs.key")
_PARTS = (_KEY, *(TRACER.name(f"graphs.{part}")
                  for part in ("load", "handoff_in", "launch", "handoff_out", "clone")))
_CAPTURE = TRACER.name("graphs.capture")
_READ_MARKS = TRACER.name("graphs.read_marks")
_PHASES = tuple(TRACER.name(name) for name in DEVICE_PHASES)


@contextlib.contextmanager
def disable_graphs():
    """Run every program eagerly while inside (nestable; process-wide,
    like the JAX package's ``jax.disable_jit()``): the only way to the
    eager loop on a card."""
    global _disabled
    with _lock:
        _disabled += 1
    try:
        yield
    finally:
        with _lock:
            _disabled -= 1


@contextlib.contextmanager
def collector_paused():
    """No cyclic garbage collection while inside (nestable, across
    threads). A ``CUDAGraph`` freed by the collector runs
    ``cudaGraphExecDestroy``, which invalidates a capture in progress on
    the collecting thread; ``torch.cuda.graph`` no longer collects on
    entry, so a dead filter's graphs may be collected at any allocation."""
    global _collector_held, _collector_was_on
    with _lock:
        if _collector_held == 0:
            _collector_was_on = gc.isenabled()
            gc.disable()
        _collector_held += 1
    try:
        yield
    finally:
        with _lock:
            _collector_held -= 1
            if _collector_held == 0 and _collector_was_on:
                gc.enable()


def graphs_enabled(device: torch.device | str) -> bool:
    """True where a program runs as a graph: a CUDA device, outside
    :func:`disable_graphs`, on a stream that is not being captured."""
    dev = torch.device(device)
    return (dev.type == "cuda" and _disabled == 0
            and not torch.cuda.is_current_stream_capturing())


class GraphCaptureError(RuntimeError):
    """A program's capture failed; the message names the last operation."""


class _LastOp(TorchDispatchMode):
    """Remembers the last tensor operation dispatched (a capture's
    culprit when it fails)."""

    def __init__(self):
        super().__init__()
        self.last = None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.last = func
        return func(*args, **(kwargs or {}))


def generators_of(generator) -> tuple:
    """A program's generators: ``generator`` alone, or a tuple of them."""
    return tuple(generator) if isinstance(generator, tuple) else (generator,)


def shape_of(x) -> tuple:
    """The shape of a tensor, an array, a nested list or a number."""
    return tuple(x.shape) if hasattr(x, "shape") else np.shape(x)


class GraphedProgram:
    """One captured program (see the module's notes): its static input
    buffers, the graph, the outputs the graph writes, its own generators
    (as many as the caller hands it), the counts its capture recorded
    (``recorded``, a ``utils/timing.py`` ``Recording``), and what it
    cost: ``warmup_ms``, ``capture_ms`` and ``pool_bytes`` (device memory
    the capture added to the pool)."""

    def __init__(self, key, fn: Callable, inputs: dict, device: torch.device, pool, keep=(),
                 generator=None):
        self.key = key
        self.device = device
        self.keep = keep  # what the graph reads by address: maps, LUTs, tables
        self.buffers = {name: torch.empty(shape_of(x), dtype=torch.float32, device=device)
                        for name, x in inputs.items()}
        self._load(inputs)
        # as many generators as the caller's, handed to ``fn`` in the same form
        self.generators = tuple(torch.Generator(device=device)
                                for _ in generators_of(generator))
        own = self.generators if isinstance(generator, tuple) else self.generators[0]
        cur = torch.cuda.current_stream(device)
        t0 = time.perf_counter()
        side = torch.cuda.Stream(device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            fn(self.buffers, own)
        cur.wait_stream(side)
        torch.cuda.synchronize(device)
        t1 = time.perf_counter()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(device)
        self.graph = torch.cuda.CUDAGraph()
        for gen in self.generators:
            self.graph.register_generator_state(gen)
        op = _LastOp()
        marks = DeviceMarks(TRACER)
        try:
            with collector_paused(), COUNTS.recording() as self.recorded, \
                    torch.cuda.graph(self.graph, pool=pool, capture_error_mode="thread_local"):
                with op, marks:
                    self.outputs = fn(self.buffers, own)
        except Exception as e:
            raise GraphCaptureError(
                f"capture of program {key!r} failed at {op.last}: {e}") from e
        torch.cuda.synchronize(device)
        self.warmup_ms = (t1 - t0) * 1e3
        self.capture_ms = (time.perf_counter() - t1) * 1e3
        self.pool_bytes = torch.cuda.memory_reserved(device) - reserved
        # the device phases of the graph's first correction, where the
        # program runs one (``correct()`` marks its boundaries)
        self.marks = marks if marks.complete else None
        self._marked = marks.corrections if self.marks is not None else 0
        self._unread = 0  # marked corrections replayed since the last reading
        self._stamps = [0] * (len(_PARTS) + 1)

    def _load(self, inputs: dict) -> None:
        """Copy the inputs into the buffers (their shapes are the key's)."""
        for name, x in inputs.items():
            buf = self.buffers[name]
            if x is buf:
                continue
            if isinstance(x, float):
                buf.fill_(x)
            else:
                upload(x, self.device, out=buf)

    def __call__(self, inputs: dict, generator, t_key: int) -> dict:
        """Load ``inputs`` and :meth:`replay`, recording the call's parts
        (``graphs.key`` from ``t_key``, the caller's ``perf_counter_ns``
        before its cache lookup, then ``graphs.load``,
        ``graphs.handoff_in``, ``graphs.launch``, ``graphs.handoff_out``
        and ``graphs.clone``) under the span open around it."""
        t = self._stamps
        t[0], t[1] = t_key, perf_counter_ns()
        if self._unread >= READ_EVERY:
            read_ns = self._read_marks()
            t[0] += read_ns  # the lookup, less the reading
            t[1] += read_ns
        self._load(inputs)
        t[2] = perf_counter_ns()
        out = self.replay(generator)
        TRACER.chain(_PARTS, t)
        return out

    def replay(self, generator, counted: bool = True) -> dict:
        """One replay on the loaded buffers, drawing from ``generator`` (or
        a tuple of generators, one for each of the program's), adding the
        recorded counts unless not ``counted``; the outputs as fresh
        tensors. Stamps the ``perf_counter_ns`` after the hand-in, the
        launch, the hand-back and the clones (the last four of the call's
        parts)."""
        t = self._stamps
        self._unread += self._marked
        theirs = generators_of(generator)
        for own, their in zip(self.generators, theirs):
            own.set_state(their.get_state())
        t[3] = perf_counter_ns()
        self.graph.replay()
        t[4] = perf_counter_ns()
        for own, their in zip(self.generators, theirs):
            their.set_state(own.get_state())
        if counted:
            self.recorded.replay()
        t[5] = perf_counter_ns()
        out = {name: x.clone() for name, x in self.outputs.items()}
        t[6] = perf_counter_ns()
        return out

    def _read_marks(self) -> int:
        """Before this call's replay: the device phases of the previous
        replay into the tracer, once its last mark has passed (never
        waiting for it). Returns the ns this took (``graphs.read_marks``
        when it read)."""
        t0 = perf_counter_ns()
        if not self.marks.ready():
            return perf_counter_ns() - t0
        for series, ns in zip(_PHASES, self.marks.phases_ns()):
            TRACER.value(series, ns)
        self._unread = 0
        t1 = perf_counter_ns()
        TRACER.record(_READ_MARKS, t0, t1)
        return t1 - t0


def run_eager(fn: Callable, inputs: dict, generator, device: torch.device) -> dict:
    """``fn`` on the inputs uploaded to ``device``: a program's eager run."""
    return fn({name: upload(x, device) for name, x in inputs.items()}, generator)


class Programs:
    """One filter's programs, keyed like ``jit``'s cache, sharing one
    graph pool."""

    def __init__(self, device: torch.device | str):
        self.device = torch.device(device)
        self.cache: dict[tuple, GraphedProgram] = {}
        self._pool = None

    def __call__(self, key: tuple, fn: Callable, inputs: dict, generator, keep=()) -> dict:
        """``fn(inputs on the device, generator)``: a replay of the graph
        of ``key`` and the inputs' shapes on a card (captured on first
        use), else an eager run. ``generator`` may be a tuple of
        generators, which ``fn`` then gets as a tuple. ``keep``: what the
        graph reads by address and must outlive it (the map and its LUT,
        the tables)."""
        if not graphs_enabled(self.device):
            return run_eager(fn, inputs, generator, self.device)
        t_key = perf_counter_ns()
        key = (*key, *((name, shape_of(x)) for name, x in sorted(inputs.items())))
        prog = self.cache.get(key)
        if prog is not None:
            return prog(inputs, generator, t_key)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        prog = self.cache[key] = GraphedProgram(key, fn, inputs, self.device, self._pool, keep,
                                                generator)
        out = prog.replay(generator, counted=False)  # the warm-up counted this run
        TRACER.record(_CAPTURE, t_key, perf_counter_ns())
        return out

    @property
    def pool_bytes(self) -> int:
        return sum(p.pool_bytes for p in self.cache.values())

    def stats(self) -> dict:
        """Per key: warm-up and capture ms, pool bytes (``TRACER`` counts
        the replays: ``graphs.launch``)."""
        return {str(k): dict(warmup_ms=p.warmup_ms, capture_ms=p.capture_ms,
                             pool_bytes=p.pool_bytes)
                for k, p in self.cache.items()}
