"""The port's tracer (``utils/timing.py`` ``TRACER``): spans and counters
recorded where the work happens, a timeline on the profiler's clock while
a profiler runs, the node's and the graph call's spans, the device marks
inside the step graphs, and the benchmark's readers of them.

On the CPU: the ring's counts, median and self time; timeline records
only under a profiler; the timeline's clock against the profiler's own
events; ``device_trace``'s ``trace.json`` carrying the spans; one node
tick's spans under one request id; marks that record nothing in eager
runs and, in a capture, only the first correction's five; the readers.

On a card (skipped here; this file imports no jax: ``python -m pytest
--noconftest -p no:cacheprovider -m cuda tests/test_torch_tracing.py``):
the graph call's parts inside ``filter.step``, five event nodes a graph
whatever its corrections, the device phases against the correction's
device time, and ``graphs.launch`` around the profiler's
``cudaGraphLaunch``.
"""

import collections
import ctypes
import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from mcl_bench import spec
from monte_carlo_localization_tpu_torch import MCLConfig, ParticleFilter
from monte_carlo_localization_tpu_torch.mapping.synthetic import random_obstacle_world
from monte_carlo_localization_tpu_torch.runtime import MCLNode
from monte_carlo_localization_tpu_torch.utils import timing
from monte_carlo_localization_tpu_torch.utils.timing import (
    DEVICE_PHASES,
    MARKS,
    READ_EVERY,
    RING,
    TRACER,
    DeviceMarks,
    Tracer,
)

BEAMS = np.linspace(-2.35, 2.35, 60).astype(np.float32)
POSE = np.array([10.0, 10.0, 0.5], np.float32)
ACTION = np.float32([0.05, 0.0, 0.02])
SCAN = np.full(60, 2.5, np.float32)
CLOCK_SLACK_NS = 20_000  # the timeline against the profiler's events, at each end
KERNEL_NODE, EVENT_RECORD_NODE = 0, 7  # cudaGraphNodeTypeKernel, cudaGraphNodeTypeEventRecord
GRAPH_PARTS = ("graphs.key", "graphs.load", "graphs.handoff_in", "graphs.launch",
               "graphs.handoff_out", "graphs.clone")
NEW_READERS = {  # metric: (mode, the name it reads, self time)
    "filter_call_host_us.live": ("live", "filter.step", False),
    "filter_call_host_us.replay": ("replay", "filter.step_many", False),
    "pose_wait_us.live": ("live", "node.pose_wait", False),
    "node_host_us.live": ("live", "node.update", True),
    "resample_device_us.replay": ("replay", "device.resample", False),
    "resample_device_us.live": ("live", "device.resample", False),
}


@pytest.fixture(autouse=True)
def _one_thread_private_lut_cache(monkeypatch, tmp_path):
    torch.set_num_threads(1)
    monkeypatch.setenv("MCL_LUT_CACHE", str(tmp_path / "lut_cache"))
    TRACER.reset()


class FakeClock:
    def __init__(self):
        self.now = 0

    def __call__(self) -> int:
        return self.now


def _kineto(prof, name: str) -> list:
    """(start, end) epoch ns of the profiler's events named ``name``."""
    return [(e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events() if e.name() == name]


def _records(name: str) -> list:
    return [r for r in TRACER.timeline if r[0] == name]


def _contains(outer, inner, slack=CLOCK_SLACK_NS) -> bool:
    return outer[0] - slack <= inner[0] and inner[1] <= outer[1] + slack


# ----- the ring -----
def test_the_ring_counts_and_gives_the_median_and_self_time(monkeypatch):
    clock = FakeClock()
    monkeypatch.setattr(timing, "perf_counter_ns", clock)
    tr = Tracer()
    parent, child, phase = tr.name("p"), tr.name("c"), tr.name("d")
    for k in range(5):
        token = tr.open(parent)
        clock.now += 1_000 * (k + 1)
        tr.record(child, clock.now, clock.now + 300)  # a leaf inside
        tr.chain((child, child), (clock.now + 300, clock.now + 400, clock.now + 700))
        clock.now += 2_000
        tr.close(token)
    s = tr.summary()
    assert s["p"]["count"] == 5 and s["c"]["count"] == 15
    # durations 3, 4, 5, 6, 7 µs; the children cover 0.7 µs of each
    assert s["p"]["p50_us"] == pytest.approx(5.0)
    assert s["p"]["self_p50_us"] == pytest.approx(4.3)
    assert s["c"]["p50_us"] == pytest.approx(0.3) and s["c"]["self_p50_us"] == pytest.approx(0.3)
    assert tr.series["p"].last_ns == 7_000
    for v in range(RING + 10):  # the ring keeps the last RING
        tr.value(phase, 1_000 if v < 10 else 2_000)
    dur, own = tr.series["d"].ring()
    assert tr.series["d"].count == RING + 10 and len(dur) == RING
    assert np.all(dur == 2_000) and tr.p50_us("d") == 2.0
    assert tr.p50_us("nothing") is None and "nothing" not in tr.summary()


def test_a_close_after_an_exception_pops_what_was_left_open():
    tr = Tracer()
    outer, inner = tr.name("outer"), tr.name("inner")
    token = tr.open(outer)
    tr.open(inner)  # never closed: an exception left it
    tr.close(token)
    assert tr._local.frames.depth == 0
    assert tr.series["outer"].count == 1 and tr.series["inner"].count == 0


# ----- the timeline -----
def test_timeline_records_exist_only_under_a_profiler():
    span = TRACER.name("test.span")
    TRACER.close(TRACER.open(span))
    assert TRACER.series["test.span"].count == 1 and not TRACER.timeline
    with profile(activities=[ProfilerActivity.CPU]):
        token = TRACER.open(span)
        TRACER.record(TRACER.name("test.leaf"), 1, 2)
        TRACER.close(token)
    (leaf,), (outer,) = _records("test.leaf"), _records("test.span")
    assert leaf[4] == outer[3] != 0  # the leaf's parent is the span
    TRACER.close(TRACER.open(span))
    assert len(_records("test.span")) == 1 and TRACER.series["test.span"].count == 3


def test_the_timeline_is_on_the_profilers_clock():
    span = TRACER.name("test.clock")
    with record_function("warm"):
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            token = TRACER.open(span)
            with record_function("marker"):
                torch.ones(16).sum()
            TRACER.close(token)
    ours, theirs = [r[1:3] for r in _records("test.clock")], _kineto(prof, "marker")
    assert len(ours) == len(theirs) == 3
    for o, t in zip(ours, theirs):
        assert _contains(o, t), (o, t)


def test_device_trace_writes_the_spans_beside_the_profilers_rows(tmp_path):
    span = TRACER.name("test.exported")
    with timing.device_trace(tmp_path, log=lambda s: None):
        TRACER.request = 7
        token = TRACER.open(span)
        with record_function("marker"):
            torch.ones(16).sum()
        TRACER.close(token)
    trace = json.loads((tmp_path / "trace.json").read_text())
    events = trace["traceEvents"]
    (ours,) = [e for e in events if e.get("cat") == "mcl" and e["name"] == "test.exported"]
    (marker,) = [e for e in events if e.get("name") == "marker"]
    assert ours["args"]["request"] == 7 and ours["args"]["parent"] == 0
    slack_us = CLOCK_SLACK_NS / 1e3
    assert ours["ts"] - slack_us <= marker["ts"]
    assert marker["ts"] + marker["dur"] <= ours["ts"] + ours["dur"] + slack_us
    assert any(e.get("ph") == "M" and e.get("tid") == ours["tid"]
               and e.get("args", {}).get("name") == "mcl" for e in events)


# ----- the node and the filter on the CPU -----
@pytest.fixture(scope="module")
def world():
    return random_obstacle_world(seed=3, device="cpu")


def test_a_cpu_node_tick_records_its_phases_under_one_request(world):
    node = MCLNode(world, MCLConfig(max_particles=64, angle_step=1), rng_seed=0)
    node.on_scan(SCAN, beam_angles=BEAMS)
    node.on_odometry(10.0, 10.0, 0.5, 0.5, 0.1, stamp=0.0)
    node.update(now=0.0)  # starts the clock
    node.update(now=0.005)
    before = node.stats.total_mcl_time
    with profile(activities=[ProfilerActivity.CPU]):
        pose = node.update(now=0.01)
    assert pose is not None
    rec = {r[0]: r for r in TRACER.timeline}
    assert {"node.update", "filter.step", "node.pose_wait", "node.post"} <= set(rec)
    assert {rec[n][5] for n in ("node.update", "filter.step", "node.pose_wait",
                                "node.post")} == {node.iters}
    update = rec["node.update"][3]
    assert rec["node.update"][4] == 0
    assert rec["filter.step"][4] == rec["node.pose_wait"][4] == rec["node.post"][4] == update
    for name in ("filter.step", "node.pose_wait", "node.post"):
        assert _contains(rec["node.update"][1:3], rec[name][1:3], 0)
    # one clock: the stats take the tick's filter.step and pose wait
    step, wait = TRACER.series["filter.step"].last_ns, TRACER.series["node.pose_wait"].last_ns
    assert node.stats.total_mcl_time - before == pytest.approx((step + wait) * 1e-6)
    s = TRACER.summary()["node.update"]
    assert s["count"] == 2 and 0 < s["self_p50_us"] < s["p50_us"]


def test_a_chained_replay_records_its_chunks(world, tmp_path):
    from monte_carlo_localization_tpu_torch.runtime import synthesize_trace

    node = MCLNode(world, MCLConfig(max_particles=64, angle_step=1), rng_seed=0)
    trace = synthesize_trace(world, duration_s=0.4, num_beams=60, seed=1)
    k = len(trace.scan_t)
    with profile(activities=[ProfilerActivity.CPU]):
        node.replay_chained(trace, chunk=4)
    chunks = _records("filter.step_many")
    assert [r[5] for r in chunks] == list(range(0, k, 4))  # each chunk's first scan index
    (outer,) = _records("node.replay_chained")
    assert {r[4] for r in chunks} | {_records("node.readback")[0][4]} == {outer[3]}


def test_marks_are_a_no_op_in_eager_runs(world, monkeypatch):
    def no_event(*args, **kwargs):
        raise AssertionError("a CUDA event was made")

    monkeypatch.setattr(torch.cuda, "Event", no_event)
    pf = ParticleFilter(world, MCLConfig(max_particles=64), beam_angles=BEAMS, device="cpu")
    state = pf.init_pose(POSE, seed=0)
    state, _ = pf.step(state, ACTION, SCAN)
    pf.step_many(state, np.tile(ACTION, (3, 1)), np.tile(SCAN, (3, 1)))
    assert TRACER.marking == 0 and TRACER.series["filter.step_many"].count == 1


@pytest.mark.parametrize("k", [1, 3])
def test_a_capture_marks_only_its_first_correction(world, k):
    class FakeEvent:
        def __init__(self):
            self.records = 0

        def record(self):
            self.records += 1

    pf = ParticleFilter(world, MCLConfig(max_particles=64), beam_angles=BEAMS, device="cpu")
    state = pf.init_pose(POSE, seed=0)
    marks = DeviceMarks(TRACER, make_event=FakeEvent)
    with marks:
        assert TRACER.marking == 1
        pf.step_many(state, np.tile(ACTION, (k, 1)), np.tile(SCAN, (k, 1)))
    assert TRACER.marking == 0 and marks.complete and marks.corrections == k
    assert [e.records for e in marks.events] == [1] * MARKS
    TRACER.mark()  # closed: records nothing
    assert [e.records for e in marks.events] == [1] * MARKS


def test_the_printout_takes_its_phases_from_the_device_marks():
    tr = Tracer()
    for name, us in zip(DEVICE_PHASES, (150, 80, 4, 40)):
        for k in range(3):
            tr.value(tr.name(name), (us + k) * 1_000)
    stats = timing.TimingStats(total_mcl_time=200 * 0.7, measurement_count=200)
    stats.fill_device_phases(tr)
    assert stats.resampling_time == pytest.approx(200 * 0.151)
    assert stats.motion_model_time == pytest.approx(200 * 0.081)
    assert stats.sensor_model_time == pytest.approx(200 * 0.005)
    lines = []
    stats.print_stats(lines.append)
    assert any(line.startswith("Resampling:") and "0.151000" in line for line in lines)
    empty = timing.TimingStats(measurement_count=5)
    empty.fill_device_phases(Tracer())  # no readings (eager, CPU): nothing to fill
    assert empty.resampling_time == empty.sensor_model_time == 0.0


# ----- the benchmark's readers -----
@pytest.mark.parametrize("metric", sorted(NEW_READERS))
def test_each_new_reader_gives_its_median_in_its_mode_alone(metric, monkeypatch):
    mode, name, own = NEW_READERS[metric]
    read = spec.reader(metric)
    run = SimpleNamespace(mode=mode)
    assert read(run) is None  # no sample yet
    clock = FakeClock()
    monkeypatch.setattr(timing, "perf_counter_ns", clock)
    series, child = TRACER.name(name), TRACER.name("test.child")
    for us in (3, 1, 2, 50, 4):  # self time a tenth of each
        token = TRACER.open(series)
        TRACER.record(child, clock.now, clock.now + us * 900)
        clock.now += us * 1_000
        TRACER.close(token)
    assert read(run) == pytest.approx(0.3 if own else 3.0)
    assert read(SimpleNamespace(mode="replay" if mode == "live" else "live")) is None


# ----- on a card -----
@pytest.fixture
def cuda():
    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _card_filter(cuda, n=4000):
    gm = random_obstacle_world(seed=3, device=cuda)
    pf = ParticleFilter(gm, MCLConfig(max_particles=n), beam_angles=BEAMS)
    return pf, pf.init_pose(POSE, seed=0)


@pytest.mark.cuda
def test_the_graph_calls_parts_lie_inside_filter_step(cuda):
    pf, state = _card_filter(cuda)
    for _ in range(12):
        state, pose = pf.step(state, ACTION, SCAN)
        pose.cpu()
        parts = [TRACER.series[p].last_ns for p in GRAPH_PARTS]
        assert sum(parts) <= TRACER.series["filter.step"].last_ns
    assert TRACER.series["graphs.capture"].count == 1
    assert TRACER.series["graphs.launch"].count == 11
    assert all(TRACER.series[p].count == 11 for p in GRAPH_PARTS)


@pytest.mark.cuda
def test_the_marks_are_read_once_every_read_every_corrections(cuda):
    pf, state = _card_filter(cuda)
    for _ in range(2 * READ_EVERY + 10):
        state, pose = pf.step(state, ACTION, SCAN)
        pose.cpu()  # each replay has passed its marks before the next call
    assert TRACER.series["graphs.read_marks"].count == 2
    assert all(TRACER.series[name].count == 2 for name in DEVICE_PHASES)
    assert TRACER.p50_us("device.resample") > 0


def _node_types(graph) -> collections.Counter:
    """Node types of a kept graph (``cudaGraphNodeType`` values), through
    the CUDA runtime that torch loaded."""
    with open("/proc/self/maps") as f:
        lib = next(line.split()[-1] for line in f if "libcudart.so" in line)
    rt = ctypes.CDLL(lib)
    g, n = ctypes.c_void_p(graph.raw_cuda_graph()), ctypes.c_size_t(0)
    assert rt.cudaGraphGetNodes(g, None, ctypes.byref(n)) == 0
    nodes = (ctypes.c_void_p * n.value)()
    assert rt.cudaGraphGetNodes(g, nodes, ctypes.byref(n)) == 0
    types = collections.Counter()
    for node in nodes:
        kind = ctypes.c_int()
        assert rt.cudaGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)) == 0
        types[kind.value] += 1
    return types


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 4, 16])
def test_a_graph_holds_five_event_nodes_whatever_its_corrections(cuda, k, monkeypatch):
    class Kept(torch.cuda.CUDAGraph):
        def __init__(self, keep_graph=False):
            super().__init__(keep_graph=True)

    monkeypatch.setattr(torch.cuda, "CUDAGraph", Kept)
    types = {}
    for marked in (True, False):
        if not marked:
            monkeypatch.setattr(TRACER, "mark", lambda: None)
        pf, state = _card_filter(cuda)
        pf.step_many(state, np.tile(ACTION, (k, 1)), np.tile(SCAN, (k, 1)))
        (prog,) = pf.programs.cache.values()
        assert (prog.marks is not None) == marked
        types[marked] = _node_types(prog.graph)
    added = types[True] - types[False]
    assert added == {EVENT_RECORD_NODE: MARKS} and not types[False] - types[True], types
    assert types[True][KERNEL_NODE] == types[False][KERNEL_NODE] > 0


@pytest.mark.cuda
def test_the_device_phases_add_up_to_the_corrections_device_time(cuda):
    pf, state = _card_filter(cuda)
    for _ in range(3):
        state, _ = pf.step(state, ACTION, SCAN)
    (prog,) = pf.programs.cache.values()
    torch.cuda.synchronize()
    for _ in range(3):
        # back to back, so each replay's launch hides behind the one before
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        prog.graph.replay()
        start.record()
        for _ in range(20):
            prog.graph.replay()
        end.record()
        torch.cuda.synchronize()
        per_replay_ns = start.elapsed_time(end) * 1e6 / 20
        phases = prog.marks.phases_ns()
        assert all(p > 0 for p in phases)
        assert sum(phases) == pytest.approx(per_replay_ns, rel=0.10), (phases, per_replay_ns)


@pytest.mark.cuda
def test_the_launch_span_holds_the_profilers_graph_launch(cuda):
    pf, state = _card_filter(cuda)
    state, _ = pf.step(state, ACTION, SCAN)  # the capture
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            state, pose = pf.step(state, ACTION, SCAN)
            pose.cpu()
    ours = [r[1:3] for r in _records("graphs.launch")]
    theirs = [(a, b) for e in prof.profiler.kineto_results.events()
              if "cudaGraphLaunch" in e.name()
              for a, b in [(e.start_ns(), e.start_ns() + e.duration_ns())]]
    assert len(ours) == 3 and len(theirs) >= 3
    for o in ours:
        assert any(_contains(o, t) for t in theirs), (o, theirs)
