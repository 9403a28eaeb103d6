"""The motion phase's kernel (``csrc/motion.cu``, ``ops/motion.py``
``MotionKernel``): the resampled rows' gather, the arc motion and the
noise in one launch.

On the CPU: the wrapper refuses what it does not take before any launch;
``correct()`` with the gather fused into motion equals motion of the
gathered rows, for a single filter and a fleet, with given and drawn
noise; CPU calls take the plain version and count as ``motion.plain``;
every program that runs motion lists the kernel among the wrappers whose
counters its graphs' replays advance. On a card (marked ``cuda``,
skipped without one): the kernel is ``torch.equal`` to the plain
version over every branch of the motion, at 1, 4000 and 14,528 rows and
a fleet's 64 x 4000 with per-member actions and a strided noise slice;
drawn noise leaves the generator where the plain version does; a graph
replay equals the eager call; and a program's replays count their
launches. This file imports no jax:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_motion_kernel.py
"""

import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from monte_carlo_localization_tpu_torch import MCLConfig, ParticleFilter, disable_graphs
from monte_carlo_localization_tpu_torch.filter.core import correct
from monte_carlo_localization_tpu_torch.mapping.synthetic import random_obstacle_world
from monte_carlo_localization_tpu_torch.models.motion import (
    gather_rows,
    motion_model,
    motion_model_plain,
)
from monte_carlo_localization_tpu_torch.ops.motion import MOTION_KERNEL
from monte_carlo_localization_tpu_torch.ops.resample import resample_indices
from monte_carlo_localization_tpu_torch.parallel import FleetFilter, ShardedParticleFilter
from monte_carlo_localization_tpu_torch.parallel import fleet as fleet_module
from monte_carlo_localization_tpu_torch.parallel.multihost import spawn
from monte_carlo_localization_tpu_torch.tools.perf_ablate import make_steps
from monte_carlo_localization_tpu_torch.utils.graphs import LaunchCounters, Programs
from monte_carlo_localization_tpu_torch.utils.timing import TRACER

DISPERSION = (0.05, 0.025, 0.25)
BEAMS = np.linspace(-2.35, 2.35, 60).astype(np.float32)
POSE = np.array([10.0, 10.0, 0.5], np.float32)
F32 = np.float32


def _near(x: float, toward: float) -> float:
    """The float32 next to ``x`` toward ``toward``."""
    return float(np.nextafter(F32(x), F32(toward)))


# (d_forward, d_y, d_theta): every branch of the motion, with and without
# the dt heuristic (d_y is ignored)
ACTIONS = {
    "straight": (0.05, 0.0, 0.0),
    "straight_tiny_turn": (0.05, 0.3, 5e-7),
    "arc": (0.05, 0.0, 0.02),
    "zero": (0.0, 0.0, 0.0),
    "reverse": (-0.05, 0.0, -0.02),
    "turn_in_place": (0.0, 0.0, 0.3),
    "fwd_under_0.001": (_near(0.001, 0.0), 0.0, 0.01),
    "fwd_at_0.001": (0.001, 0.0, 0.01),
    "fwd_over_0.001": (_near(0.001, 1.0), 0.0, 0.01),
    "fwd_under_0.1": (_near(0.1, 0.0), 0.0, 0.05),
    "fwd_at_0.1": (0.1, 0.0, 0.05),
    "fwd_over_0.1": (_near(0.1, 1.0), 0.0, -0.05),
    "fwd_clamped": (0.7, 0.0, 0.1),
    "dth_under_0.001": (0.05, 0.0, 0.0009),
    "dth_at_0.001": (-0.05, 0.0, -0.001),
    "dth_over_0.001": (0.05, 0.0, _near(0.001, 1.0)),
    "dth_2e-6": (0.05, 0.0, 2e-6),
}


def _cloud(n: int, f: int = 0, seed: int = 0) -> torch.Tensor:
    """(n, 3) or (f, n, 3) float32 particles: positions over +-60 m,
    headings over +-7 rad (past +-pi, as a fresh global cloud's are)."""
    rng = np.random.default_rng(seed)
    shape = (f, n) if f else (n,)
    p = np.stack([rng.uniform(-60, 60, shape), rng.uniform(-60, 60, shape),
                  rng.uniform(-7, 7, shape)], axis=-1)
    return torch.from_numpy(p.astype(F32))


def _indices(n: int, m: int, f: int = 0, seed: int = 1) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, n, (f, m) if f else (m,)).astype(np.int32))


# ----- on the CPU -----

@pytest.fixture(scope="module")
def world():
    torch.set_num_threads(1)
    return random_obstacle_world(seed=3, device="cpu")


def _refusal(case: str):
    """(particles, action, noise, indices, message) the wrapper refuses."""
    p = _cloud(8)
    a = torch.tensor([0.05, 0.0, 0.02])
    noise = torch.randn(8, 3)
    idx = _indices(8, 8)
    return {
        "cpu": (p, a, noise, idx, "CUDA"),
        "float64": (p.double(), a, noise, idx, "float32"),
        "non_contiguous": (_cloud(16)[::2], a, noise, idx, "contiguous"),
        "int64_indices": (p, a, noise, idx.long(), "int32"),
        "action_shape": (p, a[:2], noise, idx, "action shape"),
        "fleet_action_shape": (_cloud(8, f=2), torch.zeros(3, 3), torch.randn(2, 8, 3),
                               _indices(8, 8, f=2), "action shape"),
        "batched_action_on_one_filter": (p, a[None], noise, idx, "action shape"),
        "index_shape": (p, a, noise, idx[None], "indices shape"),
        "fleet_index_rows": (_cloud(8, f=2), a, torch.randn(2, 8, 3), _indices(8, 8, f=3),
                             "indices shape"),
        "noise_shape": (p, a, noise[:4], idx, "noise shape"),
        "particle_rank": (p[None, None], a, noise, idx, r"\(N, 3\)"),
        "host_action": (p, [0.05, 0.0, 0.02], noise, idx, "tensor"),
    }[case]


@pytest.mark.parametrize("case", ["cpu", "float64", "non_contiguous", "int64_indices",
                                  "action_shape", "fleet_action_shape",
                                  "batched_action_on_one_filter", "index_shape",
                                  "fleet_index_rows", "noise_shape", "particle_rank",
                                  "host_action"])
def test_the_wrapper_refuses_before_any_launch(case):
    particles, action, noise, idx, message = _refusal(case)
    before = MOTION_KERNEL.launch_count
    with pytest.raises(ValueError, match=message):
        MOTION_KERNEL(particles, action, noise, DISPERSION, True, idx)
    assert MOTION_KERNEL.launch_count == before


@pytest.mark.parametrize("case", ["cpu", "float64", "non_contiguous"])
def test_a_refused_call_draws_no_noise(case):
    """Without noise the wrapper draws it only once the inputs pass, so a
    refused call leaves the generator where it was."""
    particles, action, _, idx, message = _refusal(case)
    gen = torch.Generator().manual_seed(4)
    state = gen.get_state()
    with pytest.raises(ValueError, match=message):
        MOTION_KERNEL(particles, action, None, DISPERSION, True, idx, gen)
    assert torch.equal(gen.get_state(), state)


def _zero_likelihood(particles, obs_px):
    return torch.zeros(particles.shape[:-1])


@pytest.mark.parametrize("fleet", [0, 3])
@pytest.mark.parametrize("drawn", [False, True])
@pytest.mark.parametrize("exact_dt", [True, False])
def test_correct_with_the_fused_gather_moves_the_gathered_rows(fleet, drawn, exact_dt):
    """``correct()`` hands the resampler's indices to motion, which gathers
    the rows itself: its proposal is motion of ``particles[idx]`` (a
    fleet's ``torch.gather``), drawing the same noise."""
    torch.set_num_threads(1)
    n = 200
    particles = _cloud(n, f=fleet)
    log_w = torch.from_numpy(np.random.default_rng(2).normal(
        scale=2.0, size=particles.shape[:-1]).astype(F32))
    u0 = torch.full(particles.shape[:-2], 0.37)
    action = (torch.tensor([ACTIONS[k] for k in ("arc", "reverse", "straight")])
              if fleet else torch.tensor(ACTIONS["arc"]))
    noise = None if drawn else torch.randn(particles.shape)
    gen, twin = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    plain_before = MOTION_KERNEL.plain_launch_count
    got = correct(particles, log_w, gen, action, None, _zero_likelihood,
                  motion_dispersion=DISPERSION, exact_dt_heuristic=exact_dt, u0=u0,
                  noise=noise)[0]
    assert MOTION_KERNEL.plain_launch_count == plain_before + 1
    idx = resample_indices(log_w, u0=u0)
    rows = (torch.gather(particles, 1, idx.long()[..., None].expand(-1, -1, 3)) if fleet
            else particles[idx])
    want = motion_model_plain(rows, action, *DISPERSION, exact_dt_heuristic=exact_dt,
                              generator=twin, noise=noise)
    assert torch.equal(got, want)
    assert torch.equal(gen.get_state(), twin.get_state())


@pytest.mark.parametrize("fleet", [0, 2])
def test_gather_rows_is_the_index_and_the_gather(fleet):
    particles = _cloud(50, f=fleet)
    idx = _indices(50, 70, f=fleet)
    got = gather_rows(particles, idx)
    assert got.shape == tuple(idx.shape) + (3,)
    for r in range(max(fleet, 1)):
        rows = particles[r] if fleet else particles
        assert torch.equal(got[r] if fleet else got, rows[idx[r] if fleet else idx])


def test_cpu_calls_take_the_plain_version_and_count_as_plain():
    p, a, idx = _cloud(30), torch.tensor(ACTIONS["arc"]), _indices(30, 30)
    kernel, plain = MOTION_KERNEL.launch_count, MOTION_KERNEL.plain_launch_count
    summary = TRACER.summary().get("motion.plain", {}).get("count", 0)
    for _ in range(3):
        motion_model(p, a, generator=torch.Generator().manual_seed(0), indices=idx)
    assert MOTION_KERNEL.launch_count == kernel
    assert MOTION_KERNEL.plain_launch_count == plain + 3
    assert TRACER.summary()["motion.plain"]["count"] == summary + 3


def _programs(gm, kind: str):
    """The programs of one path that runs motion."""
    beams = None if kind.endswith("no_beams") else BEAMS
    if kind.startswith("fleet"):
        return FleetFilter(gm, 2, MCLConfig(max_particles=64), beam_angles=beams).programs
    if kind.startswith("sharded"):
        return ShardedParticleFilter(gm, MCLConfig(max_particles=64), beam_angles=beams).programs
    pf = ParticleFilter(gm, MCLConfig(max_particles=64), beam_angles=beams)
    if kind == "perf_ablate":
        return make_steps(gm, pf.likelihood, pf.sensor, True, True, True, True).programs
    return pf.programs


@pytest.mark.parametrize("kind", ["single_no_beams", "single", "fleet_no_beams", "fleet",
                                  "sharded_no_beams", "sharded", "perf_ablate"])
def test_each_motion_program_counts_the_kernel_s_replays(world, kind):
    """A graph's replays launch the kernel without Python seeing it: a
    program adds them to both counts only if it lists the kernel."""
    programs = _programs(world, kind)
    assert any(w is MOTION_KERNEL for w in programs.wrappers)
    counters = LaunchCounters(programs.wrappers)
    i = next(i for i, w in enumerate(counters.wrappers) if w is MOTION_KERNEL)
    assert {(i, "launch_count"), (i, "plain_launch_count")} <= set(counters.snapshot())


def _fleet_2d_rank() -> None:
    """The one rank of a group of one (gloo on the CPU, NCCL on a card): a
    fleet of four over a 1 x 1 fleet x particle mesh, whose particle axis
    all-gathers the members' particles as a transposed view. Warms its
    programs, then writes what motion saw over an eager chain and single
    steps and a chain's graph replayed (a replay on a card calls no
    Python):
    the corrections, the kernel's launches, the plain calls and whether
    every particles tensor handed to ``motion_model`` was contiguous."""
    from torch.distributed.device_mesh import init_device_mesh

    dev = torch.device(os.environ["MCL_TEST_DEVICE"])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    gm = random_obstacle_world(seed=3, device=dev)
    f, k = 4, 5
    ff = FleetFilter(gm, f, MCLConfig(max_particles=256, raycast_method="lut"),
                     beam_angles=BEAMS,
                     mesh=init_device_mesh(dev.type, (1, 1), mesh_dim_names=("fleet", "p")),
                     particle_axis="p")
    acts = np.tile(np.float32([0.05, 0.0, 0.02]), (k, f, 1))
    scans = np.full((k, f, 60), 2.5, np.float32)
    state = ff.init_pose(np.tile(POSE, (f, 1)), seed=1)
    state, _ = ff.step_many(state, acts, scans)
    state, _ = ff.step(state, acts[0], scans[0])
    contiguous = []
    plain_motion = fleet_module.motion_model

    def recording(particles, *args, **kw):
        contiguous.append(particles.is_contiguous())
        return plain_motion(particles, *args, **kw)

    fleet_module.motion_model = recording
    MOTION_KERNEL.launch_count = MOTION_KERNEL.plain_launch_count = 0
    with disable_graphs():  # eager, so every correction passes through Python
        state, _ = ff.step_many(state, acts, scans)
        for i in range(3):
            state, _ = ff.step(state, acts[i], scans[i])
    state, _ = ff.step_many(state, acts, scans)  # the chain's graph, replayed
    if dev.type == "cuda":
        torch.cuda.synchronize()
    (Path(os.environ["MCL_TEST_IO"]) / "fleet_2d.json").write_text(json.dumps(dict(
        corrections=2 * k + 3, launches=MOTION_KERNEL.launch_count,
        plain=MOTION_KERNEL.plain_launch_count, contiguous=contiguous)))


def _fleet_2d(device: str, backend: str, tmp_path) -> dict:
    # the child imports this file from its own directory: a ``tests``
    # package installed elsewhere may shadow the checkout's
    here = Path(__file__).resolve().parent
    path = os.pathsep.join(filter(None, (str(here), os.environ.get("PYTHONPATH"))))
    spawn(f"{Path(__file__).stem}:_fleet_2d_rank", 1, timeout_s=300.0, backend=backend,
          env={"MCL_TEST_IO": str(tmp_path), "MCL_TEST_DEVICE": device, "PYTHONPATH": path})
    return json.loads((tmp_path / "fleet_2d.json").read_text())


def test_a_fleet_over_a_particle_axis_hands_motion_contiguous_particles(tmp_path):
    """On the CPU every correction takes the plain version; the gathered
    particles reach motion contiguous, as the kernel takes them."""
    res = _fleet_2d("cpu", "gloo", tmp_path)
    assert res["contiguous"] == [True] * res["corrections"], res
    assert res["plain"] == res["corrections"] and res["launches"] == 0, res


# ----- on a card -----

@pytest.fixture
def cuda():
    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _plain(particles, action, noise, exact_dt, idx):
    rows = particles if idx is None else gather_rows(particles, idx)
    return motion_model_plain(rows, action, *DISPERSION, exact_dt_heuristic=exact_dt,
                              noise=noise)


def _case(shape: str, gather: bool, dev):
    """(particles, the actions to try, noise, indices) of one shape: a
    single filter tries each action in turn; a fleet gives its rows the
    actions in turn, and its strided form reads a column slice of twice
    as many particles, indices and noise, as a fleet over a particle
    axis does."""
    kinds = list(ACTIONS.values())
    if shape.startswith("64x4000"):
        f, n = 64, 4000
        acts = torch.tensor([kinds[r % len(kinds)] for r in range(f)], device=dev)
        if shape.endswith("slice"):
            cols = slice(n // 2, n // 2 + n)
            particles = _cloud(2 * n, f=f).to(dev)
            noise = torch.randn(f, 2 * n, 3, device=dev)[:, cols]
            idx = _indices(2 * n, 2 * n, f=f).to(dev)[:, cols] if gather else None
            if not gather:
                particles = particles[:, cols].contiguous()
            assert not noise.is_contiguous()
        else:
            particles = _cloud(n, f=f).to(dev)
            noise = torch.randn(f, n, 3, device=dev)
            idx = _indices(n, n, f=f).to(dev) if gather else None
        return particles, [acts], noise, idx
    n = int(shape)
    particles = _cloud(n).to(dev)
    noise = torch.randn(n, 3, device=dev)
    idx = _indices(n, n).to(dev) if gather else None
    return particles, [torch.tensor(a, device=dev) for a in kinds], noise, idx


@pytest.mark.cuda
@pytest.mark.parametrize("gather", [True, False])
@pytest.mark.parametrize("exact_dt", [True, False])
@pytest.mark.parametrize("shape", ["1", "4000", "14528", "64x4000", "64x4000_slice"])
def test_kernel_equals_the_plain_version(cuda, shape, exact_dt, gather):
    particles, actions, noise, idx = _case(shape, gather, cuda)
    for action in actions:
        before = MOTION_KERNEL.launch_count
        got = motion_model(particles, action, *DISPERSION, exact_dt_heuristic=exact_dt,
                           noise=noise, indices=idx)
        assert MOTION_KERNEL.launch_count == before + 1
        want = _plain(particles, action, noise, exact_dt, idx)
        assert got.shape == want.shape and got.is_contiguous()
        assert torch.equal(got, want), f"{shape} action {action.tolist()}"


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["4000", "64x4000"])
def test_drawn_noise_leaves_the_generator_where_the_plain_version_does(cuda, shape):
    particles, actions, _, idx = _case(shape, True, cuda)
    gen, twin = (torch.Generator(device=cuda).manual_seed(11) for _ in range(2))
    got = motion_model(particles, actions[-1], *DISPERSION, generator=gen,
                       indices=idx)
    want = motion_model_plain(gather_rows(particles, idx), actions[-1],
                              *DISPERSION, generator=twin)
    assert torch.equal(got, want)
    assert torch.equal(gen.get_state(), twin.get_state())


@pytest.mark.cuda
@pytest.mark.parametrize("fleet", [0, 64])
def test_a_graph_replay_equals_the_eager_call_and_counts(cuda, fleet):
    """Resample and motion as a program: each replay equals the eager
    call on the same inputs and generator state, and adds one launch."""
    n = 4000
    programs = Programs(cuda, [MOTION_KERNEL])
    action = torch.tensor([ACTIONS["arc"]] * fleet if fleet else ACTIONS["arc"], device=cuda)

    def program(b, gen):
        idx = resample_indices(b["log_weights"], generator=gen)
        return dict(out=motion_model(b["particles"], b["action"], *DISPERSION, generator=gen,
                                     indices=idx))

    def inputs(seed):
        lw = np.random.default_rng(seed).normal(scale=2.0, size=(fleet, n) if fleet else (n,))
        return dict(particles=_cloud(n, f=fleet, seed=seed).to(cuda),
                    log_weights=torch.from_numpy(lw.astype(F32)).to(cuda), action=action)

    gen = torch.Generator(device=cuda).manual_seed(3)
    programs(("motion",), program, inputs(0), gen)  # warm-up and capture
    before = MOTION_KERNEL.launch_count
    for seed in (1, 2, 3):
        eager_gen = torch.Generator(device=cuda)
        eager_gen.set_state(gen.get_state())
        got = programs(("motion",), program, inputs(seed), gen)["out"]
        with disable_graphs():
            want = programs(("motion",), program, inputs(seed), eager_gen)["out"]
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        assert torch.equal(gen.get_state(), eager_gen.get_state())
    # three replays and three eager calls
    assert MOTION_KERNEL.launch_count == before + 6
    assert len(programs.cache) == 1


@pytest.mark.cuda
@pytest.mark.parametrize("fleet", [0, 3])
def test_a_filter_s_replays_count_one_launch_a_correction(cuda, fleet):
    gm = random_obstacle_world(seed=3, device=cuda)
    k = 10
    acts = np.tile(np.float32([0.05, 0.0, 0.02]), (k, 1))
    scans = np.full((k, 60), 2.5, np.float32)
    if fleet:
        pf = FleetFilter(gm, fleet, MCLConfig(max_particles=4000), beam_angles=BEAMS)
        state = pf.init_pose(np.tile(POSE, (fleet, 1)), seed=1)
        acts = np.repeat(acts[:, None], fleet, axis=1)
        scans = np.repeat(scans[:, None], fleet, axis=1)
    else:
        pf = ParticleFilter(gm, MCLConfig(max_particles=4000), beam_angles=BEAMS)
        state = pf.init_pose(POSE, seed=1)
    state, _ = pf.step_many(state, acts, scans)
    state, _ = pf.step(state, acts[0], scans[0])
    MOTION_KERNEL.launch_count = 0
    plain = MOTION_KERNEL.plain_launch_count
    for _ in range(3):
        state, _ = pf.step_many(state, acts, scans)
    for i in range(5):
        state, _ = pf.step(state, acts[i], scans[i])
    torch.cuda.synchronize()
    assert pf.programs.cache
    assert MOTION_KERNEL.launch_count == 3 * k + 5
    assert MOTION_KERNEL.plain_launch_count == plain


@pytest.mark.cuda
def test_a_fleet_over_a_particle_axis_launches_the_kernel_each_correction(cuda, tmp_path):
    """A 1 x 1 fleet x particle mesh over an NCCL group of one: each
    correction, eager or replayed, launches the kernel once and none
    takes the plain version."""
    res = _fleet_2d("cuda:0", "nccl", tmp_path)
    assert res["launches"] == res["corrections"] and res["plain"] == 0, res
    # the replayed chain's corrections do not pass through Python
    assert all(res["contiguous"]) and len(res["contiguous"]) >= res["corrections"] - 5, res
