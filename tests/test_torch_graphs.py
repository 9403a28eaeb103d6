"""The step programs as CUDA graphs (``utils/graphs.py``).

On the CPU: a capture-safety guard (one correction of each path, after a
warm step, records no operation that a captured region cannot hold: a
device read on the host, a data-dependent shape, or a host-to-device
copy of a host value; ``aten.scalar_tensor``, the wrapped Python number
of ``torch.where(m, 0.0, t)``, is capture-safe; the sharded filter's
bucketed chunk and the meshed fleets' corrections are recorded inside two
spawned gloo processes), the counts a capture records and its replays
add (``utils/timing.py`` ``COUNTS``: the first call as the warm-up left
them, a caller's reset, two queries' own counts, the collectives' calls
and bytes, the dedup query's overflow flags, another thread's launches,
a program inlined in another), the one launch function
(``ops/_cuda_build.py`` ``launch``) and that no other code raises on a
CUDA error code, ``disable_graphs()`` nesting, the
cyclic collector paused inside ``collector_paused()`` (nested) and as
it was after, and the eager run a CPU program is, with one generator or
two.

On a card (skipped here; this file imports no jax, so it runs on a GPU
machine alone: ``python -m pytest --noconftest -p no:cacheprovider -m
cuda tests/test_torch_graphs.py``): each program ``torch.equal`` to its
eager run, no aliasing between calls, capture from a ``LiveRunner``
thread, a failed capture raising, a capture during which a dead
filter's graphs would be collected, and, on two or more cards, the sharded
filter's bucketed program over an NCCL group of two against its eager
run.
"""

import contextlib
import gc
import json
import os
import threading
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from monte_carlo_localization_tpu_torch import MCLConfig, ParticleFilter, disable_graphs
from monte_carlo_localization_tpu_torch.mapping.synthetic import random_obstacle_world
from monte_carlo_localization_tpu_torch.ops import _cuda_build
from monte_carlo_localization_tpu_torch.ops._cuda_build import launch
from monte_carlo_localization_tpu_torch.ops.lut_query import LUTQuery
from monte_carlo_localization_tpu_torch.parallel import FleetFilter, ShardedParticleFilter
from monte_carlo_localization_tpu_torch.parallel.collectives import Collectives, world_mesh
from monte_carlo_localization_tpu_torch.parallel.multihost import spawn
from monte_carlo_localization_tpu_torch.utils import graphs
from monte_carlo_localization_tpu_torch.utils.device import upload
from monte_carlo_localization_tpu_torch.utils.graphs import (
    GraphCaptureError,
    Programs,
    collector_paused,
)
from monte_carlo_localization_tpu_torch.utils.timing import COUNTS

N = 64
BEAMS = np.linspace(-2.35, 2.35, 60).astype(np.float32)
POSE = np.array([10.0, 10.0, 0.5], np.float32)
# operations a captured region cannot hold
FORBIDDEN = ("_local_scalar_dense", "nonzero", "masked_select", "unique", "lift_fresh")


class RecordOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(func.overloadpacket.__name__)
        return func(*args, **(kwargs or {}))


@pytest.fixture(scope="module")
def world():
    torch.set_num_threads(1)
    return random_obstacle_world(seed=3, device="cpu")


def _single(gm, **opts):
    pf = ParticleFilter(gm, MCLConfig(max_particles=N, **opts), beam_angles=BEAMS)
    state = pf.init_pose(POSE, seed=0)
    action = upload(np.float32([0.05, 0.0, 0.02]), pf.device)
    obs_px = pf.sensor.to_pixel_index(upload(np.full(60, 2.5, np.float32), pf.device)).float()
    return pf, state, action, obs_px


def _guard_path(gm, path):
    """(warm call, guarded call) of one correction of ``path``."""
    if path == "sharded":
        # a one-shard world: the program's chunk of two corrections
        spf = ShardedParticleFilter(gm, MCLConfig(max_particles=N), beam_angles=BEAMS)
        st = spf.init_global(seed=0)
        b = dict(particles=st.particles, log_weights=st.log_weights,
                 actions=torch.zeros(2, 3), scans=torch.full((2, 60), 2.5))
        return lambda: spf._chunk(b, (st.generator, st.motion_generator), bucketed=False)
    if path == "fleet":
        ff = FleetFilter(gm, 4, MCLConfig(max_particles=N), beam_angles=BEAMS)
        state = ff.init_pose(np.tile(POSE, (4, 1)), seed=0)
        actions = upload(np.zeros((4, 3), np.float32), ff.device)
        obs_px = ff.sensor.to_pixel_index(upload(np.full((4, 60), 2.5, np.float32),
                                                 ff.device)).float()
        return lambda: ff._step(state, actions, obs_px, None, None)
    if path == "mega":
        pf, state, action, obs_px = _single(gm, pallas_mega=True)
        b = dict(particles=state.particles, log_weights=state.log_weights,
                 actions=action[None], observed_m=upload(np.full((1, 60), 2.5, np.float32),
                                                         pf.device))
        return lambda: pf.mega._chain(b, state.generator)
    method, _, inject = path.partition("+")
    opts = dict(raycast_method=method) if method in ("lut", "sphere", "dda") else {}
    if method == "subbin":
        opts = dict(pallas_subbin=True)
    if method == "dedup":
        opts = dict(pallas_dedup_slots=4)
    pf, state, action, obs_px = _single(gm, **opts)
    kw = {}
    if inject:
        kw = dict(inject_fraction=upload(np.float32(0.3), pf.device))
    return lambda: pf._step(state, action, obs_px, **kw)


def _recorded(run) -> list[str]:
    """The operations of ``run()`` after a warm call."""
    run()
    with RecordOps() as rec:
        run()
    return rec.names


MESHED = ("sharded_bucketed", "fleet_1d", "fleet_2d")


def _guard_rank() -> None:
    """One of two spawned gloo processes: the operations of the sharded
    filter's bucketed chunk (two corrections, D = 2), of a correction of
    a fleet over a 1-D fleet mesh (the LUT likelihood) and of one over a
    1 x 2 fleet x particle mesh (``lut``), as JSON."""
    from torch.distributed.device_mesh import init_device_mesh

    gm = random_obstacle_world(seed=3, device="cpu")
    spf = ShardedParticleFilter(gm, MCLConfig(max_particles=2 * N), mesh=world_mesh("p"),
                                beam_angles=BEAMS)
    st = spf.init_global(seed=0)
    b = dict(particles=st.particles, log_weights=st.log_weights,
             actions=torch.zeros(2, 3), scans=torch.full((2, 60), 2.5))
    runs = dict(sharded_bucketed=lambda: spf._chunk(b, (st.generator, st.motion_generator),
                                                    bucketed=True))
    for path, mesh, particle_axis, method in (
            ("fleet_1d", world_mesh("fleet"), None, "lut_pallas"),
            ("fleet_2d", init_device_mesh("cpu", (1, 2), mesh_dim_names=("fleet", "p")), "p",
             "lut")):
        ff = FleetFilter(gm, 2, MCLConfig(max_particles=N, raycast_method=method),
                         beam_angles=BEAMS, mesh=mesh, particle_axis=particle_axis)
        fs = ff.init_pose(np.tile(POSE, (2, 1)), seed=0)
        f = ff.num_local_members
        obs_px = ff.sensor.to_pixel_index(torch.full((f, 60), 2.5)).float()
        runs[path] = (lambda ff, fs, f, obs_px: lambda: ff._step(
            fs, torch.zeros(f, 3), obs_px, None, None))(ff, fs, f, obs_px)
    names = {path: _recorded(run) for path, run in runs.items()}
    (Path(os.environ["MCL_TEST_IO"]) / f"ops{dist.get_rank()}.json").write_text(json.dumps(names))


@pytest.fixture(scope="module")
def meshed_ops(tmp_path_factory):
    """Each rank's recorded operations of the :data:`MESHED` paths."""
    io = tmp_path_factory.mktemp("guard")
    spawn("tests.test_torch_graphs:_guard_rank", 2, timeout_s=240.0,
          env={"MCL_TEST_IO": str(io)})
    return [json.loads((io / f"ops{r}.json").read_text()) for r in range(2)]


@pytest.mark.parametrize("path", [
    "lut_pallas", "subbin", "dedup", "lut", "sphere", "dda",
    "lut_pallas+inject", "lut+inject", "sphere+inject", "fleet", "mega", "sharded",
    *MESHED,
])
def test_a_correction_holds_no_operation_a_graph_cannot(world, path, request):
    """One correction of each path after a warm one, on the tensors a
    program's buffers would hold. ``dda`` built its maximum range as a
    host tensor in every call until it became a Python number; the
    sharded filter read its overflow flag on the host in every correction
    until the flag became a chunk's output."""
    if path in MESHED:
        recorded = [ops[path] for ops in request.getfixturevalue("meshed_ops")]
    else:
        recorded = [_recorded(_guard_path(world, path))]
    for names in recorded:
        assert names, "nothing was dispatched"
        bad = sorted({n for n in names if n.startswith(FORBIDDEN)})
        assert bad == [], f"{path}: {bad}"


class FakeLibrary:
    """The kernel libraries as Python stand-ins: each C entry records its
    arguments and returns ``err``."""

    def __init__(self):
        self.calls, self.err = [], 0

    def __getattr__(self, entry):
        if entry == "mcl_cuda_error_string":
            return lambda code: b"an illegal memory access was encountered"

        def call(*args):
            self.calls.append((entry, args))
            return self.err
        return call


@pytest.fixture
def library(monkeypatch):
    """``launch`` on the CPU: every library a :class:`FakeLibrary`, the
    device a no-op and the current stream the handle 77."""
    lib = FakeLibrary()
    built = _cuda_build.BuiltLibrary({"lut_likelihood": lib, "probes": lib}, {}, 0.0, "")
    monkeypatch.setattr(_cuda_build, "load_library", lambda: built)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: SimpleNamespace(cuda_stream=77))
    return lib


def _query() -> LUTQuery:
    return LUTQuery(1416, BEAMS, height=8, width=8, resolution=0.05, origin_x=0.0,
                    origin_y=0.0, max_range_px=40, row_stride=3072, z_hit=0.75, z_short=0.1,
                    z_max=0.05, z_rand=0.1, sigma_hit=8.0, inv_squash=1 / 2.2, device="cpu")


def _loglik(q: LUTQuery) -> None:
    """One launch of the query's likelihood kernel, as ``LUTQuery.launch`` makes it."""
    launch("lut_likelihood", "mcl_lut_loglik_u8", "cuda", name=q.form, count=q._launches)


def _table(q: LUTQuery) -> None:
    launch("lut_likelihood", "mcl_log_norm", "cuda", name="log_norm.kernel",
           count=q._table_launches)


def test_the_first_call_leaves_the_warm_up_s_counts_and_each_replay_adds_a_run(library):
    """A program's first call: the eager warm-up counts (the normaliser
    table filled there, once), the capture is recorded and not counted, and
    the first replay stands for the warm-up's run; every later replay adds
    one run."""
    q = _query()
    form = COUNTS.name(q.form)
    _table(q)  # the warm-up: the table's one fill and three corrections
    for _ in range(3):
        _loglik(q)
    warm = (q.launch_count, q.table_launch_count, form.n)
    with COUNTS.recording() as rec:  # the capture: the table cached
        for _ in range(3):
            _loglik(q)
    assert (q.launch_count, q.table_launch_count, form.n) == warm == (3, 1, form.n)
    assert rec.increments == {q._launches: 3, form: 3}
    rec.replay()
    rec.replay()
    assert (q.launch_count, q.table_launch_count, form.n) == (9, 1, warm[2] + 6)
    assert len(library.calls) == 7  # the device saw each eager launch once


def test_a_caller_s_reset_is_kept_by_later_replays(library):
    q = _query()
    _loglik(q)
    with COUNTS.recording() as rec:
        _loglik(q)
        _loglik(q)
    q.launch_count = 0  # a caller resets its count
    rec.replay()
    assert q.launch_count == 2
    q.launch_count = 5
    rec.replay()
    assert q.launch_count == 7


def test_two_queries_keep_their_own_counts(library):
    a, b = _query(), _query()
    with COUNTS.recording() as rec:
        _loglik(a)
        _loglik(b)
        _loglik(b)
    assert a.launch_count == b.launch_count == 0
    for _ in range(3):
        rec.replay()
    assert (a.launch_count, b.launch_count) == (3, 6)
    assert a.fleet_launch_count == b.fleet_launch_count == 0


def test_a_replay_advances_the_collectives_calls_and_bytes():
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        comm = Collectives(dist.group.WORLD)
        comm.psum(torch.ones(4))  # the warm-up: 16 bytes
        with COUNTS.recording() as rec:  # the capture: a psum and an all-gather
            comm.psum(torch.ones(4))
            comm.all_gather(torch.ones(2, dtype=torch.float64))
        assert (comm.calls, comm.bytes) == (1, 16)
        comm.reset_counts()
        rec.replay()
        rec.replay()
        assert (comm.calls, comm.bytes, comm.host_copies) == (4, 64, 0)
    finally:
        dist.destroy_process_group()


def test_a_replay_sets_the_captured_overflow_flags_again():
    q = _query()
    captured, eager = torch.zeros(1, dtype=torch.int32), torch.ones(1, dtype=torch.int32)
    with COUNTS.recording() as rec:
        COUNTS.keep(q, "last_overflow", torch.full((1,), 9, dtype=torch.int32))
        COUNTS.keep(q, "last_overflow", captured)  # the last value a capture leaves
    assert q.last_overflow is captured
    q.last_overflow = eager  # an eager call of the same query
    rec.replay()
    assert q.last_overflow is captured and rec.increments == {}


def test_another_thread_s_launches_are_counted_not_recorded(library):
    """The live loop and the web view run threads of their own: what they
    launch while a step is captured is theirs, not the step's."""
    q, other = _query(), _query()
    with COUNTS.recording() as rec:
        _loglik(q)
        thread = threading.Thread(target=_loglik, args=(other,))
        thread.start()
        thread.join()
    assert (q.launch_count, other.launch_count) == (0, 1)
    assert q._launches in rec.increments and other._launches not in rec.increments
    rec.replay()
    assert (q.launch_count, other.launch_count) == (1, 1)


def test_a_program_inlined_in_another_counts_once(library):
    """A program called inside another's capture runs inline: its launches
    are the outer recording's, once; an inner recording takes its own."""
    q, progs = _query(), Programs("cpu")

    def inner(b, gen):
        _loglik(q)
        return dict(y=b["x"] + 1)

    def outer(b, gen):
        _loglik(q)
        return progs(("inner",), inner, dict(x=b["x"]), gen)

    with COUNTS.recording() as rec:
        progs(("outer",), outer, dict(x=torch.zeros(2)), torch.Generator())
        with COUNTS.recording() as own:
            _table(q)
    assert rec.increments[q._launches] == 2 and q._table_launches not in rec.increments
    assert own.increments == {q._table_launches: 1, COUNTS.name("log_norm.kernel"): 1}
    rec.replay()
    assert (q.launch_count, q.table_launch_count) == (2, 0)


@pytest.mark.parametrize("case", ["launch", "query", "error", "no_library"])
def test_the_launch_function(library, case):
    """Every kernel wrapper's one way to its library: the current stream
    last, the kernel's named count and the wrapper's own; a query takes no
    stream and counts nothing; a CUDA error code or a library not built
    raises."""
    q = _query()
    named = COUNTS.name("probe.gather_rows")
    before = named.n
    if case == "launch":
        launch("probes", "mcl_probe_gather_rows", "cuda", 1, 2, name="probe.gather_rows",
               count=q._launches)
        assert library.calls == [("mcl_probe_gather_rows", (1, 2, 77))]
        assert (named.n, q.launch_count) == (before + 1, 1)
    elif case == "query":
        launch("probes", "mcl_probe_scan_shape", None, 3, name="probe.scan_shape", stream=False)
        assert library.calls == [("mcl_probe_scan_shape", (3,))]
        assert "probe.scan_shape" not in COUNTS.named
    elif case == "error":
        library.err = 700
        with pytest.raises(RuntimeError, match=r"^probe.gather_rows launch failed: CUDA error "
                                               r"700 \(an illegal memory access"):
            launch("probes", "mcl_probe_gather_rows", "cuda", name="probe.gather_rows",
                   count=q._launches)
        assert (named.n, q.launch_count) == (before, 0)
    else:
        with pytest.raises(RuntimeError, match="motion kernel library was not built"):
            launch("motion", "mcl_motion", "cuda", name="motion.kernel")


def test_only_the_launch_function_raises_on_a_cuda_error_code():
    """One place turns a kernel's error code into an exception: no wrapper
    of the port checks one itself."""
    pkg = Path(_cuda_build.__file__).resolve().parents[1]
    raising = sorted(str(p.relative_to(pkg)) for p in pkg.rglob("*.py")
                     if "error_string(" in p.read_text() or "CUDA error {" in p.read_text())
    assert raising == ["ops/_cuda_build.py"]


def test_disable_graphs_nests_and_restores(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    assert graphs.graphs_enabled("cuda") and not graphs.graphs_enabled("cpu")
    with disable_graphs():
        assert not graphs.graphs_enabled("cuda")
        with disable_graphs():
            assert not graphs.graphs_enabled("cuda")
        assert not graphs.graphs_enabled("cuda")
    assert graphs.graphs_enabled("cuda")
    with pytest.raises(ValueError), disable_graphs():
        raise ValueError("leaves the block")
    assert graphs.graphs_enabled("cuda")


@pytest.mark.parametrize("was_on", [True, False])
def test_the_collector_is_paused_inside_and_restored_after(was_on):
    on = gc.isenabled()
    (gc.enable if was_on else gc.disable)()
    try:
        with collector_paused():
            assert not gc.isenabled()
            with collector_paused():
                assert not gc.isenabled()
            assert not gc.isenabled()
        assert gc.isenabled() == was_on
    finally:
        (gc.enable if on else gc.disable)()


def test_a_program_on_the_cpu_runs_eagerly_on_the_callers_inputs():
    progs = Programs("cpu")
    seen = []

    def fn(b, gen):
        seen.append(b)
        return dict(y=b["x"] * 2 + b["f"])

    x = torch.arange(3.0)
    out = progs(("double",), fn, dict(x=x, f=0.5, a=[1.0, 2.0]), torch.Generator())
    assert torch.equal(out["y"], torch.tensor([0.5, 2.5, 4.5]))
    assert seen[0]["x"] is x and seen[0]["f"].dtype == torch.float32
    assert seen[0]["a"].shape == (2,) and progs.cache == {} and progs.pool_bytes == 0


def test_a_program_with_two_generators_runs_eagerly_on_the_callers_generators():
    progs = Programs("cpu")
    seen = []

    def fn(b, gens):
        seen.append(gens)
        u0_gen, motion_gen = gens
        return dict(y=b["x"] + torch.rand((), generator=u0_gen),
                    z=torch.randn(3, generator=motion_gen))

    gens = (torch.Generator().manual_seed(1), torch.Generator().manual_seed(2))
    out = progs(("two",), fn, dict(x=torch.zeros(3)), gens)
    ref = (torch.Generator().manual_seed(1), torch.Generator().manual_seed(2))
    assert seen[0] == gens and seen[0][0] is gens[0] and seen[0][1] is gens[1]
    assert torch.equal(out["y"], torch.rand((), generator=ref[0]).expand(3))
    assert torch.equal(out["z"], torch.randn(3, generator=ref[1]))
    assert all(torch.equal(g.get_state(), r.get_state()) for g, r in zip(gens, ref))
    assert graphs.generators_of(gens) == gens and graphs.generators_of(gens[0]) == gens[:1]


def test_shape_of_reads_tensors_arrays_lists_and_numbers():
    assert graphs.shape_of(torch.zeros(2, 3)) == (2, 3)
    assert graphs.shape_of(np.zeros((4,))) == (4,)
    assert graphs.shape_of([[1, 2], [3, 4]]) == (2, 2)
    assert graphs.shape_of(0.25) == ()


def test_upload_into_a_buffer_casts_and_copies():
    buf = torch.zeros(3)
    got = upload(np.array([1, 2, 3], np.int64), torch.device("cpu"), out=buf)
    assert got is buf and torch.equal(buf, torch.tensor([1.0, 2.0, 3.0]))
    upload(torch.tensor([4.0, 5.0, 6.0], dtype=torch.float64), torch.device("cpu"), out=buf)
    assert torch.equal(buf, torch.tensor([4.0, 5.0, 6.0]))


# ---- on a card -------------------------------------------------------------


@pytest.fixture
def cuda():
    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _outs(state, poses):
    return (poses, state.particles, state.log_weights, state.log_quality,
            state.generator.get_state())


def _equal(a, b) -> bool:
    return all(torch.equal(x.cpu(), y.cpu()) for x, y in zip(a, b))


def _chain_cases(gm):
    """(name, filter factory, run(filter, state, draws)) of each program."""
    k, rng = 10, np.random.default_rng(0)
    acts = np.tile(np.float32([0.05, 0.0, 0.02]), (k, 1))
    scans = np.full((k, 60), 2.5, np.float32)
    draws = dict(u0=rng.random(k, dtype=np.float32),
                 noise=rng.standard_normal((k, N, 3), dtype=np.float32))

    def many(pf, s, d):
        return pf.step_many(s, acts, scans, **d)

    def steps(pf, s, d, inject=False):
        poses = []
        for i in range(k):
            kw = {name: v[i] for name, v in d.items()}
            if inject:
                kw["inject_fraction"] = 0.1 * (i % 4)
            s, p = pf.step(s, acts[i], scans[i], **kw)
            poses.append(p)
        return s, torch.stack(poses)

    for name, opts in (("classic", {}), ("subbin", dict(pallas_subbin=True)),
                       ("dedup", dict(pallas_dedup_slots=4)), ("mega", dict(pallas_mega=True)),
                       ("sphere", dict(raycast_method="sphere"))):
        yield name, opts, many, draws
    yield "step", {}, steps, draws
    yield "inject", {}, lambda pf, s, d: steps(pf, s, d, inject=True), draws


@pytest.mark.cuda
def test_each_program_equals_its_eager_run(cuda):
    gm = random_obstacle_world(seed=3, device=cuda)
    for name, opts, run, draws in _chain_cases(gm):
        pf = ParticleFilter(gm, MCLConfig(max_particles=N, **opts), beam_angles=BEAMS)
        for d in (draws, {}):
            with disable_graphs():
                eager = _outs(*run(pf, pf.init_pose(POSE, seed=1), d))
            first = _outs(*run(pf, pf.init_pose(POSE, seed=1), d))
            kept = [t.clone() for t in first]
            again = _outs(*run(pf, pf.init_pose(POSE, seed=1), d))
            assert _equal(eager, first), (name, sorted(d))
            assert _equal(first, again) and _equal(kept, first), (name, "aliasing")
        assert (pf.mega.programs if pf.mega else pf.programs).cache, name


@pytest.mark.cuda
def test_fleet_programs_equal_their_eager_run(cuda):
    gm = random_obstacle_world(seed=3, device=cuda)
    ff = FleetFilter(gm, 4, MCLConfig(max_particles=N), beam_angles=BEAMS)
    acts = np.zeros((10, 4, 3), np.float32)
    scans = np.full((10, 4, 60), 2.5, np.float32)
    for run in (lambda s: ff.step_many(s, acts, scans), lambda s: ff.step(s, acts[0], scans[0])):
        with disable_graphs():
            eager = _outs(*run(ff.init_pose(np.tile(POSE, (4, 1)), seed=1)))
        graphed = _outs(*run(ff.init_pose(np.tile(POSE, (4, 1)), seed=1)))
        assert _equal(eager, graphed)
    q = ff.likelihood
    before = q.launch_count + q.fleet_launch_count
    ff.step_many(ff.init_pose(np.tile(POSE, (4, 1)), seed=1), acts, scans)
    assert q.launch_count + q.fleet_launch_count - before == 10


@pytest.mark.cuda
def test_a_live_runner_thread_captures_and_replays(cuda):
    from monte_carlo_localization_tpu_torch.runtime import LiveRunner, MCLNode, synthesize_trace

    gm = random_obstacle_world(seed=3, device=cuda)
    tr = synthesize_trace(gm, duration_s=1.0, num_beams=60, seed=0)
    node = MCLNode(gm, MCLConfig(max_particles=N, timer_frequency=200.0))
    node.initialize_pose(tr.truth_pose[0])
    with LiveRunner(node) as runner:
        for i in range(len(tr.scan_t)):
            node.on_odometry(*tr.odom_pose[4 * i], *tr.odom_twist[4 * i])
            node.on_scan(tr.scan_ranges[i], beam_angles=tr.beam_angles)
            time.sleep(0.005)
        for _ in range(5000):
            if runner.corrections > 0 or runner.error is not None:
                break
            time.sleep(0.002)
    assert runner.corrections > 0 and node.filter.programs.cache


@pytest.mark.cuda
def test_a_failed_capture_raises(cuda):
    progs = Programs(cuda)

    def reads_the_device(b, gen):
        return dict(y=b["x"] * float(b["x"].sum()))

    with pytest.raises(GraphCaptureError, match="local_scalar_dense"):
        progs(("bad",), reads_the_device, dict(x=torch.ones(4, device=cuda)),
              torch.Generator(device=cuda))


@pytest.mark.cuda
def test_a_capture_survives_a_dead_filter_s_graphs(cuda):
    """A filter whose captured graphs only a reference cycle keeps dies
    during another program's capture, and the allocations that follow
    would run a full collection: freeing a graph then would invalidate
    the capture."""
    gm = random_obstacle_world(seed=3, device=cuda)
    dead = ParticleFilter(gm, MCLConfig(max_particles=N), beam_angles=BEAMS)
    dead.step_many(dead.init_pose(POSE, seed=1), np.zeros((2, 3), np.float32),
                   np.full((2, 60), 2.5, np.float32))
    assert dead.programs.cache
    dead.cycle = dead
    holder = [dead]
    del dead

    def fn(b, gen):
        y = b["x"] * 2
        if torch.cuda.is_current_stream_capturing() and holder:
            holder.clear()
            # enough surviving objects that the oldest generation is collected
            kept = [[i] for i in range(len(gc.get_objects()) // 2 + 100_000)]
            assert kept
        return dict(y=y + 1)

    out = Programs(cuda)(("dead",), fn, dict(x=torch.ones(4, device=cuda)),
                         torch.Generator(device=cuda))
    gc.collect()
    torch.cuda.synchronize()
    assert torch.equal(out["y"], torch.full((4,), 3.0, device=cuda))


def _nccl_rank() -> None:
    """One rank of an NCCL group of two, a card each: the sharded filter's
    two chunks with a one-slot fringe (a bucketed program, its overflow
    re-run through the all-gather one), eagerly and twice as graphs."""
    dev = torch.device("cuda", dist.get_rank())
    torch.cuda.set_device(dev)
    gm = random_obstacle_world(seed=3, device=dev)
    spf = ShardedParticleFilter(gm, MCLConfig(max_particles=2 * N, sharded_fringe=1),
                                beam_angles=BEAMS)
    acts = np.tile(np.float32([0.05, 0.0, 0.02]), (5, 1))
    scans = np.full((5, 60), 2.5, np.float32)
    runs = []
    for graphed in (False, True, True):
        reads = spf.overflow_reads
        with contextlib.nullcontext() if graphed else disable_graphs():
            s, first = spf.step_many(spf.init_global(seed=1), acts, scans)
            s, second = spf.step_many(s, acts, scans)
        runs.append(([first, second, s.particles, s.log_weights, s.log_quality,
                      s.generator.get_state(), s.motion_generator.get_state()],
                     spf.overflow_reads - reads))
    (eager, n_e), (graph, n_g), (again, n_a) = runs
    result = dict(equal=all(torch.equal(a.cpu(), b.cpu()) for a, b in zip(eager, graph)),
                  replay_equal=all(torch.equal(a.cpu(), b.cpu()) for a, b in zip(graph, again)),
                  reads=[n_e, n_g, n_a], graphs=len(spf.programs.cache),
                  fallbacks=spf.fallbacks)
    (Path(os.environ["MCL_TEST_IO"]) / f"nccl{dist.get_rank()}.json").write_text(
        json.dumps(result))


@pytest.mark.cuda
def test_the_bucketed_program_over_nccl_equals_its_eager_run(cuda, tmp_path):
    """NCCL at D = 2 needs a card a rank; a one-card machine skips this."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more NVIDIA GPUs: NCCL refuses two ranks on one card")
    spawn("tests.test_torch_graphs:_nccl_rank", 2, timeout_s=600.0, backend="nccl",
          env={"MCL_TEST_IO": str(tmp_path)})
    for r in range(2):
        res = json.loads((tmp_path / f"nccl{r}.json").read_text())
        assert res["equal"] and res["replay_equal"], res
        assert res["reads"] == [2, 2, 2] and res["graphs"] >= 1, res
