"""The normalization and pose kernel (``csrc/normalize_pose.cu``,
``ops/normalize_pose.py`` ``NormalizePoseKernel``): the max shift, the log
quality and the weighted-mean pose of every row in one launch.

On the CPU: the wrapper refuses what it does not take before any launch;
``correct()`` off a card takes the plain lines (``filter/core.py``
``normalize_pose``: ``torch.logsumexp``, the shift and the module's
``expected_pose``, which a monkeypatch reaches), each call counted as
``normalize_pose.plain``; every program that runs ``correct()``, its
eager chain recorded as a capture records it, records one
``normalize_pose.plain`` a correction, and the sharded filter, which
keeps its own normalization, records none. On a card (marked ``cuda``,
skipped without one): the shifted weights are ``torch.equal`` to the
plain version's; the pose and the log quality lie as near a float64
computation of the same formulas as the plain float32 chain does (1e-6
more for the pose, 1e-5 for the log quality) at 1, 31, 4000, 14,528 and
100,000 particles and a 64 x 4000 fleet; rows with -inf entries and an
all -inf row give the plain version's non-finite results; and a graph
replay of ``step``, ``step_many`` and a fleet's step equals its eager
call and counts one launch a correction. This file imports no jax:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_normalize_pose_kernel.py
"""

import math

import numpy as np
import pytest
import torch

from monte_carlo_localization_tpu_torch import MCLConfig, ParticleFilter, disable_graphs
from monte_carlo_localization_tpu_torch.filter import core
from monte_carlo_localization_tpu_torch.filter.core import MCLState, correct, normalize_pose
from monte_carlo_localization_tpu_torch.mapping.synthetic import random_obstacle_world
from monte_carlo_localization_tpu_torch.ops.normalize_pose import NORMALIZE_POSE_KERNEL
from monte_carlo_localization_tpu_torch.parallel import FleetFilter, ShardedParticleFilter
from monte_carlo_localization_tpu_torch.parallel.fleet import FleetState
from monte_carlo_localization_tpu_torch.tools.perf_ablate import make_steps
from monte_carlo_localization_tpu_torch.utils.timing import COUNTS, TRACER

BEAMS = np.linspace(-2.35, 2.35, 60).astype(np.float32)
POSE = np.array([10.0, 10.0, 0.5], np.float32)
F32 = np.float32
PLAIN = COUNTS.name("normalize_pose.plain")


def _cloud(n: int, f: int = 0, seed: int = 0, spread: float = 60.0) -> torch.Tensor:
    """(n, 3) or (f, n, 3) float32 particles: positions over +-spread m
    around (spread / 2, -spread / 3), headings over +-pi."""
    rng = np.random.default_rng(seed)
    shape = (f, n) if f else (n,)
    p = np.stack([spread / 2 + rng.uniform(-spread, spread, shape),
                  -spread / 3 + rng.uniform(-spread, spread, shape),
                  rng.uniform(-np.pi, np.pi, shape)], axis=-1)
    return torch.from_numpy(p.astype(F32))


def _log_weights(n: int, f: int = 0, seed: int = 1, scale: float = 40.0) -> torch.Tensor:
    """(n,) or (f, n) float32 log likelihoods of a 60-beam scan's size,
    around -80 nats, with runs of off-map particles at -1e4."""
    rng = np.random.default_rng(seed)
    shape = (f, n) if f else (n,)
    lw = (-80.0 + rng.normal(scale=scale, size=shape)).astype(F32)
    if n >= 7:
        lw[..., n // 3:n // 3 + n // 7] = -1e4
    return torch.from_numpy(lw)


def _plain(particles, log_w):
    """The three plain lines, as ``correct()`` ran them before the kernel."""
    log_quality = torch.logsumexp(log_w, dim=-1) - math.log(log_w.shape[-1])
    shifted = log_w - torch.amax(log_w, dim=-1, keepdim=True)
    return shifted, log_quality, core.expected_pose(particles, shifted)


# ----- on the CPU -----

@pytest.fixture(scope="module")
def world():
    torch.set_num_threads(1)
    return random_obstacle_world(seed=3, device="cpu")


def _refusal(case: str):
    """(particles, log weights, message) the wrapper refuses."""
    p, lw = _cloud(8), _log_weights(8)
    return {
        "cpu": (p, lw, "CUDA"),
        "float64_weights": (p, lw.double(), "float32"),
        "float64_particles": (p.double(), lw, "float32"),
        "non_contiguous_weights": (p, _log_weights(16)[::2], "contiguous"),
        "non_contiguous_particles": (_cloud(16)[::2], lw, "contiguous"),
        "particle_count": (_cloud(9), lw, r"\(\.\.\., N, 3\)"),
        "fleet_rows": (_cloud(8, f=3), _log_weights(8, f=2), r"\(\.\.\., N, 3\)"),
        "particle_width": (p[:, :2], lw, r"\(\.\.\., N, 3\)"),
        "empty_row": (torch.zeros(0, 3), torch.zeros(0), r"\(\.\.\., N, 3\)"),
        "scalar_weights": (p, torch.tensor(0.0), r"\(\.\.\., N, 3\)"),
    }[case]


@pytest.mark.parametrize("case", ["cpu", "float64_weights", "float64_particles",
                                  "non_contiguous_weights", "non_contiguous_particles",
                                  "particle_count", "fleet_rows", "particle_width",
                                  "empty_row", "scalar_weights"])
def test_the_wrapper_refuses_before_any_launch(case):
    particles, log_w, message = _refusal(case)
    before = NORMALIZE_POSE_KERNEL.launch_count
    with pytest.raises(ValueError, match=message):
        NORMALIZE_POSE_KERNEL(particles, log_w)
    assert NORMALIZE_POSE_KERNEL.launch_count == before


def _zero_motion_likelihood(log_w):
    """A likelihood that hands back ``log_w`` whatever the proposal."""
    return lambda particles, obs_px: log_w


@pytest.mark.parametrize("fleet", [0, 3])
def test_correct_off_a_card_takes_the_plain_lines_and_counts_them(fleet):
    torch.set_num_threads(1)
    n = 200
    particles = _cloud(n, f=fleet)
    log_w = _log_weights(n, f=fleet)
    u0 = torch.full(particles.shape[:-2], 0.37)
    action = torch.zeros((fleet, 3) if fleet else (3,))
    noise = torch.zeros(particles.shape)
    kernel, plain = NORMALIZE_POSE_KERNEL.launch_count, NORMALIZE_POSE_KERNEL.plain_launch_count
    summary = TRACER.summary().get("normalize_pose.plain", {}).get("count", 0)
    proposal, shifted, log_quality, pose = correct(
        particles, particles[..., 0] * 0, torch.Generator().manual_seed(5), action, None,
        _zero_motion_likelihood(log_w), u0=u0, noise=noise)
    assert NORMALIZE_POSE_KERNEL.plain_launch_count == plain + 1
    assert NORMALIZE_POSE_KERNEL.launch_count == kernel
    assert TRACER.summary()["normalize_pose.plain"]["count"] == summary + 1
    want = _plain(proposal, log_w)
    for got, w in zip((shifted, log_quality, pose), want):
        assert got.dtype == torch.float32 and torch.equal(got, w)


def test_correct_off_a_card_goes_through_the_module_s_expected_pose(monkeypatch):
    particles, log_w = _cloud(50), _log_weights(50)
    calls = []

    def shifted_pose(p, lw):
        calls.append(lw)
        return torch.tensor([1.0, 2.0, 3.0])

    monkeypatch.setattr(core, "expected_pose", shifted_pose)
    out = correct(particles, torch.zeros(50), torch.Generator().manual_seed(1),
                  torch.zeros(3), None, _zero_motion_likelihood(log_w), u0=torch.tensor(0.5),
                  noise=torch.zeros(50, 3))
    assert torch.equal(out[3], torch.tensor([1.0, 2.0, 3.0]))
    assert len(calls) == 1 and torch.equal(calls[0], out[1])


@pytest.mark.parametrize("shape", [(1,), (31,), (4000,), (4, 300)])
def test_normalize_pose_off_a_card_is_the_three_plain_lines(shape):
    f, n = (shape[0], shape[1]) if len(shape) == 2 else (0, shape[0])
    particles, log_w = _cloud(n, f=f, seed=n), _log_weights(n, f=f, seed=n)
    got = normalize_pose(particles, log_w)
    for g, w in zip(got, _plain(particles, log_w)):
        assert torch.equal(g, w)


def _chain(gm, kind: str, k: int):
    """One path that runs ``correct()`` (or the sharded filter, which does
    not), as a function that runs k corrections through its programs."""
    cfg = MCLConfig(max_particles=64)
    acts = np.tile(F32([0.05, 0.0, 0.02]), (k, 1))
    scans = np.full((k, len(BEAMS)), 2.5, F32)
    if kind == "perf_ablate":
        pf = ParticleFilter(gm, cfg, beam_angles=BEAMS)
        steps = make_steps(pf.grid_map, pf.likelihood, pf.sensor, True, True, True, True)
        state = pf.init_pose(POSE, seed=1)
        return lambda: steps(state, torch.from_numpy(acts), torch.from_numpy(scans))
    if kind == "fleet":
        pf = FleetFilter(gm, 2, cfg, beam_angles=BEAMS)
        state = pf.init_pose(np.tile(POSE, (2, 1)), seed=1)
        acts, scans = np.repeat(acts[:, None], 2, axis=1), np.repeat(scans[:, None], 2, axis=1)
    elif kind == "sharded":
        pf = ShardedParticleFilter(gm, cfg, beam_angles=BEAMS)
        state = pf.init_global(seed=1)
    else:
        pf = ParticleFilter(gm, cfg, beam_angles=BEAMS)
        state = pf.init_pose(POSE, seed=1)
    return lambda: pf.step_many(state, acts, scans)


@pytest.mark.parametrize("kind,per_correction", [("single", 1), ("fleet", 1),
                                                 ("perf_ablate", 1), ("sharded", 0)])
def test_each_program_records_its_plain_calls(world, kind, per_correction):
    """A graph's replays run the phase without Python seeing it: the eager
    chain, recorded as a capture records it, records one
    ``normalize_pose.plain`` a correction (none for the sharded filter's
    own normalization) and counts none; a replay adds them."""
    k = 3
    run = _chain(world, kind, k)
    plain = NORMALIZE_POSE_KERNEL.plain_launch_count
    with COUNTS.recording() as rec:
        run()
    assert NORMALIZE_POSE_KERNEL.plain_launch_count == plain
    assert rec.increments.get(PLAIN, 0) == per_correction * k
    rec.replay()
    assert NORMALIZE_POSE_KERNEL.plain_launch_count == plain + per_correction * k


# ----- on a card -----

@pytest.fixture
def cuda():
    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _float64(particles, log_w):
    """(log quality, pose) of the kernel's formulas in float64."""
    p, lw = particles.double(), log_w.double()
    m = torch.amax(lw, dim=-1, keepdim=True)
    e = torch.exp(lw - m)
    s = e.sum(-1)
    pose = torch.stack([(e * p[..., 0]).sum(-1) / s, (e * p[..., 1]).sum(-1) / s,
                        torch.atan2((e * torch.sin(p[..., 2])).sum(-1),
                                    (e * torch.cos(p[..., 2])).sum(-1))], dim=-1)
    return m[..., 0] + torch.log(s) - math.log(log_w.shape[-1]), pose


def _quality_close(got, want) -> bool:
    """Within 1e-5 of ``want`` past the float32 rounding of the result
    (half an ulp: 3.8e-6 at 80 nats)."""
    return bool(((got.double() - want).abs() <= 1e-5 + want.abs() * 2.0**-24).all())


def _pose_error(pose, want):
    """|pose - want| a component, the heading's wrapped."""
    d = (pose.double() - want).abs()
    d[..., 2] = torch.remainder(d[..., 2] + math.pi, 2 * math.pi) - math.pi
    return d.abs()


# the main path's rows, and rows that one block, a cluster of 2, 3 or 8
# blocks and the streaming form over a cluster take
SHAPES = {"1": (0, 1), "31": (0, 31), "4000": (0, 4000), "5000": (0, 5000),
          "9000": (0, 9000), "14528": (0, 14_528), "100000": (0, 100_000),
          "200003": (0, 200_003), "64x4000": (64, 4000), "3x9001": (3, 9001)}


@pytest.mark.cuda
@pytest.mark.parametrize("spread", [0.5, 60.0])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_kernel_against_the_plain_version_and_float64(cuda, shape, spread):
    f, n = SHAPES[shape]
    particles = _cloud(n, f=f, seed=n + f, spread=spread).to(cuda)
    log_w = _log_weights(n, f=f, seed=n, scale=40.0 if spread > 1 else 3.0).to(cuda)
    before = NORMALIZE_POSE_KERNEL.launch_count
    shifted, log_quality, pose = normalize_pose(particles, log_w)
    torch.cuda.synchronize()
    assert NORMALIZE_POSE_KERNEL.launch_count == before + 1
    want_shifted, plain_quality, plain_pose = _plain(particles, log_w)
    assert shifted.shape == log_w.shape and shifted.is_contiguous()
    assert torch.equal(shifted, want_shifted)
    quality64, pose64 = _float64(particles, log_w)
    assert log_quality.shape == quality64.shape and pose.shape == pose64.shape
    assert _quality_close(log_quality, quality64)
    plain_err = _pose_error(plain_pose, pose64)
    assert (_pose_error(pose, pose64) <= plain_err + 1e-6).all(), (
        _pose_error(pose, pose64).max(), plain_err.max())


def _with_infinities(dev):
    """(particles, log weights) of three rows of 4000 holding -inf: a
    third of the entries, all but one, and every one."""
    particles = _cloud(4000, f=3, seed=7).to(dev)
    log_w = _log_weights(4000, f=3, seed=7).to(dev)
    log_w[0, ::3] = -math.inf
    log_w[1, 1:] = -math.inf
    log_w[2] = -math.inf
    return particles, log_w


@pytest.mark.cuda
def test_rows_with_minus_infinity_give_the_plain_version_s_results(cuda):
    particles, log_w = _with_infinities(cuda)
    shifted, log_quality, pose = normalize_pose(particles, log_w)
    want_shifted, want_quality, want_pose = _plain(particles, log_w)
    torch.cuda.synchronize()
    assert torch.equal(shifted[:2], want_shifted[:2])
    assert torch.isnan(shifted[2]).all() and torch.isnan(want_shifted[2]).all()
    # the finite rows: as near float64 as the plain version, as above
    quality64, pose64 = _float64(particles[:2], log_w[:2])
    assert _quality_close(log_quality[:2], quality64)
    assert (_pose_error(pose[:2], pose64) <= _pose_error(want_pose[:2], pose64) + 1e-6).all()
    # one live particle: its position is the pose
    assert torch.equal(pose[1, :2], particles[1, 0, :2])
    # the all -inf row: the plain version's -inf quality and NaN pose
    assert log_quality[2] == -math.inf and want_quality[2] == -math.inf
    assert torch.isnan(pose[2]).all() and torch.isnan(want_pose[2]).all()


def _states(pf, fleet: int, gen_state):
    """A fresh state of the filter's start, on a generator at ``gen_state``."""
    gen = torch.Generator(device=pf.device)
    gen.set_state(gen_state)
    if fleet:
        start = pf.init_pose(np.tile(POSE, (fleet, 1)), seed=1)
        return FleetState(particles=start.particles, log_weights=start.log_weights,
                          generator=gen, log_quality=start.log_quality)
    start = pf.init_pose(POSE, seed=1)
    return MCLState(particles=start.particles, log_weights=start.log_weights, generator=gen)


@pytest.mark.cuda
@pytest.mark.parametrize("fleet", [0, 3])
@pytest.mark.parametrize("call", ["step", "step_many"])
def test_a_graph_replay_equals_the_eager_call_and_counts(cuda, call, fleet):
    gm = random_obstacle_world(seed=3, device=cuda)
    k = 10
    acts = np.tile(np.float32([0.05, 0.0, 0.02]), (k, 1))
    scans = np.full((k, 60), 2.5, np.float32)
    if fleet:
        pf = FleetFilter(gm, fleet, MCLConfig(max_particles=4000), beam_angles=BEAMS)
        acts = np.repeat(acts[:, None], fleet, axis=1)
        scans = np.repeat(scans[:, None], fleet, axis=1)
    else:
        pf = ParticleFilter(gm, MCLConfig(max_particles=4000), beam_angles=BEAMS)
    gen_state = torch.Generator(device=cuda).manual_seed(11).get_state()

    def run(state):
        if call == "step_many":
            return pf.step_many(state, acts, scans)
        for i in range(k):
            state, pose = pf.step(state, acts[i], scans[i])
        return state, pose

    run(_states(pf, fleet, gen_state))  # warm-up and capture
    before, plain = NORMALIZE_POSE_KERNEL.launch_count, NORMALIZE_POSE_KERNEL.plain_launch_count
    got, got_pose = run(_states(pf, fleet, gen_state))
    torch.cuda.synchronize()
    assert NORMALIZE_POSE_KERNEL.launch_count == before + k
    with disable_graphs():
        want, want_pose = run(_states(pf, fleet, gen_state))
    torch.cuda.synchronize()
    assert NORMALIZE_POSE_KERNEL.launch_count == before + 2 * k
    assert NORMALIZE_POSE_KERNEL.plain_launch_count == plain
    assert pf.programs.cache
    for name in ("particles", "log_weights", "log_quality"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    assert torch.equal(got_pose, want_pose)
    assert torch.equal(got.generator.get_state(), want.generator.get_state())
