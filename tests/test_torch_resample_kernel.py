"""The systematic resampler's kernel (``csrc/resample.cu``, ``ops/resample.py``
``SystematicKernel``) and the rule it implements.

On the CPU: the per-slot rule the kernel computes (slot s takes the first
j of ``g[:-1]`` with ``g[j] >= s``, clamped to N - 1), written out here,
and ``systematic_invert_cdf_window``, its PyTorch path, are both
``torch.equal`` to the scatter inversion (source j scattered into its
first slot with ``amax``, a cumulative max after), the oracle kept here,
on the same CDF over the edge cases below and windows of the slots from
``slot0 = 0`` on and past it; CPU tensors take the PyTorch path (the
kernel's ``launch_count`` does not move).
On a card (marked ``cuda``, skipped without one): the kernel's indices are
``torch.equal`` to the PyTorch path on the same log weights and u0, a
captured graph's replay equals the eager call, a program's replays count
their launches, and a row past the kernel's cap takes the PyTorch path.
This file imports no jax:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_resample_kernel.py
"""

import numpy as np
import pytest
import torch

from monte_carlo_localization_tpu_torch import MCLConfig, ParticleFilter
from monte_carlo_localization_tpu_torch.mapping.synthetic import random_obstacle_world
from monte_carlo_localization_tpu_torch.ops.resample import (
    SYSTEMATIC_KERNEL,
    systematic_invert_cdf_window,
    systematic_resample_indices,
    weight_cdf,
)
from monte_carlo_localization_tpu_torch.parallel import FleetFilter

# the kernel's cap on an H100: 227 KB of opt-in shared memory over 16 B an element
H100_MAX_ROW = 232_448 // 16
LAST_U0 = 1.0 - 2.0**-24  # the largest float32 below 1
NS = (1, 2, 3, 31, 32, 33, 1000, 4000, 4096, "cap")
BEAMS = np.linspace(-2.35, 2.35, 60).astype(np.float32)
POSE = np.array([10.0, 10.0, 0.5], np.float32)


def _log_weights(kind: str, f: int, n: int, seed: int) -> torch.Tensor:
    """(f, n) float32 log weights: random; one-hot; equal; random with runs
    of the -1e4 off-map weight; or random with a float32 CDF that ends
    below 1 (the first such seed)."""
    rng = np.random.default_rng(seed)
    if kind == "one_hot":
        lw = np.full((f, n), -1e4, np.float32)
        lw[np.arange(f), rng.integers(0, n, f)] = 0.0
    elif kind == "equal":
        lw = np.zeros((f, n), np.float32)
    elif kind == "off_map":
        lw = rng.normal(scale=2.0, size=(f, n)).astype(np.float32)
        for start in (0, n // 3, n - n // 5):
            lw[:, start:start + max(1, n // 7)] = -1e4
    elif kind == "below_one":
        while True:
            lw = rng.normal(scale=2.0, size=(f, n)).astype(np.float32)
            if bool((weight_cdf(torch.from_numpy(lw))[:, -1] < 1.0).all()):
                break
    else:
        lw = rng.normal(scale=2.0, size=(f, n)).astype(np.float32)
    return torch.from_numpy(lw)


def _cases():
    """(kind, F, N, m, u0) over N; m != N, F = 3 and 64, both ends of u0."""
    cases = []
    for n in NS:
        cases += [("random", 1, n, n, 0.37), ("off_map", 3, n, "more", 0.0),
                  ("one_hot", 1, n, n, LAST_U0), ("equal", 3, n, "fewer", LAST_U0)]
    cases += [("random", 64, 4000, 4000, 0.61), ("off_map", 64, 1000, 1500, LAST_U0),
              ("one_hot", 64, 33, 33, 0.0), ("below_one", 1, 1000, 1000, LAST_U0),
              ("below_one", 3, 4000, 4000, LAST_U0)]
    return [pytest.param(*c, id="-".join(str(v) for v in c)) for c in cases]


def _shape(n, m, cap):
    """N and m of a case, with "cap" the kernel's longest row."""
    n = cap if n == "cap" else n
    m = {"cap": n, "more": n + 7, "fewer": max(1, n // 2)}.get(m, m)
    return n, m


def _first_at_or_above(cdf: torch.Tensor, u0: torch.Tensor, m: int) -> torch.Tensor:
    """The kernel's rule, written out: with g = m*cdf - u0 (float32), slot
    s takes the first j of g[:-1] with g[j] >= s, else N - 1."""
    rows = cdf.reshape(-1, cdf.shape[-1])
    g = m * rows - u0.reshape(-1, 1)
    slots = torch.arange(m, dtype=torch.float64).expand(rows.shape[0], m).contiguous()
    idx = torch.searchsorted(g[:, :-1].double().contiguous(), slots, side="left")
    return idx.clamp(max=rows.shape[1] - 1).to(torch.int32).reshape(cdf.shape[:-1] + (m,))


def _scatter_inversion(cdf, u0, num_samples: int, slot0: int, window: int) -> torch.Tensor:
    """The inversion as first written (the JAX package's form): each source
    j scattered into its first slot ``floor(g[j-1]) + 1`` of the window
    with ``amax``, slot 0 seeded with the source covering ``slot0``, then a
    cumulative max; slots outside the window go to a dropped spare slot."""
    rows = cdf if cdf.dim() == 2 else cdf[None]
    f, n = rows.shape
    g = num_samples * rows - torch.as_tensor(u0).reshape(-1, 1)
    first_slot = torch.cat([torch.zeros((f, 1), dtype=torch.int32),
                            torch.floor(g[:, :-1]).to(torch.int32) + 1], dim=1) - slot0
    inside = (first_slot >= 0) & (first_slot < window)
    target = torch.where(inside, first_slot, window).to(torch.int64)
    target = target + (window + 1) * torch.arange(f)[:, None]
    src = torch.arange(n, dtype=torch.int32).expand(f, n)
    seeded = torch.zeros(f * (window + 1), dtype=torch.int32)
    seeded.scatter_reduce_(0, target.reshape(-1), src.reshape(-1), reduce="amax")
    seeded = seeded.view(f, window + 1)[:, :window]
    j0 = torch.sum((g < slot0).to(torch.int32), dim=1)
    seeded[:, 0] = torch.maximum(seeded[:, 0], j0)
    out = torch.clamp(torch.cummax(seeded, dim=1).values, 0, n - 1)
    return out if cdf.dim() == 2 else out[0]


@pytest.mark.parametrize("kind, f, n, m, u0", _cases())
def test_first_slot_rule_equals_the_scatter_inversion(kind, f, n, m, u0):
    torch.set_num_threads(1)
    n, m = _shape(n, m, H100_MAX_ROW)
    lw = _log_weights(kind, f, n, seed=n + f)
    cdf = weight_cdf(lw)
    u0s = torch.full((f,), u0, dtype=torch.float32)
    rule = _first_at_or_above(cdf, u0s, m)
    # the whole range, a middle window, the last slot and all but the first
    windows = {(0, m), (m // 3, max(1, m // 2)), (m - 1, 1), (min(1, m - 1), m - 1 or 1)}
    for slot0, window in windows:
        want = _scatter_inversion(cdf, u0s, m, slot0, window)
        assert torch.equal(rule[:, slot0:slot0 + window], want)
        assert torch.equal(systematic_invert_cdf_window(cdf, u0s, m, slot0, window), want)
        if f == 1:
            assert torch.equal(systematic_invert_cdf_window(cdf[0], u0s[0], m, slot0, window),
                               want[0])


def test_cpu_rows_take_the_torch_path():
    lw = _log_weights("random", 3, 100, seed=0)
    before = SYSTEMATIC_KERNEL.launch_count
    got = systematic_resample_indices(lw, u0=torch.full((3,), 0.25))
    assert torch.equal(got, systematic_invert_cdf_window(weight_cdf(lw), torch.full((3,), 0.25),
                                                         100, 0, 100))
    assert SYSTEMATIC_KERNEL.launch_count == before
    with pytest.raises(ValueError, match="CUDA"):
        SYSTEMATIC_KERNEL(torch.softmax(lw, -1), torch.zeros(()), 100)


# ----- on a card -----

@pytest.fixture
def cuda():
    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _torch_path(lw, u0, m):
    return systematic_invert_cdf_window(weight_cdf(lw), u0, m, 0, m)


@pytest.mark.cuda
@pytest.mark.parametrize("kind, f, n, m, u0", _cases())
def test_kernel_equals_the_torch_path(cuda, kind, f, n, m, u0):
    n, m = _shape(n, m, SYSTEMATIC_KERNEL.max_row(torch.device("cuda", 0)))
    lw = _log_weights(kind, f, n, seed=n + f).to(cuda)
    u0s = torch.full((f,), u0, dtype=torch.float32, device=cuda)
    before = SYSTEMATIC_KERNEL.launch_count
    got = systematic_resample_indices(lw, num_samples=m, u0=u0s)
    assert SYSTEMATIC_KERNEL.launch_count == before + 1
    assert torch.equal(got, _torch_path(lw, u0s, m))
    if f == 1:  # one filter: (N,) weights and a () offset
        one = systematic_resample_indices(lw[0], num_samples=m, u0=u0s[0])
        assert one.shape == (m,)
        assert torch.equal(one, got[0])


@pytest.mark.cuda
@pytest.mark.parametrize("f", [1, 64])
def test_graph_replay_equals_the_eager_call(cuda, f):
    lw = _log_weights("random", f, 4000, seed=f).to(cuda)
    u0 = torch.rand((f,), device=cuda)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        systematic_resample_indices(lw, u0=u0)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = SYSTEMATIC_KERNEL.launch_count
    with torch.cuda.graph(graph):
        out = systematic_resample_indices(lw, u0=u0)
    assert SYSTEMATIC_KERNEL.launch_count == before + 1
    for seed in (1, 2):
        lw.copy_(_log_weights("off_map", f, 4000, seed=seed))
        u0.uniform_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, systematic_resample_indices(lw, u0=u0))
        assert torch.equal(out, _torch_path(lw, u0, 4000))


@pytest.mark.cuda
def test_a_row_past_the_cap_takes_the_torch_path(cuda):
    cap = SYSTEMATIC_KERNEL.max_row(torch.device("cuda", 0))
    assert cap >= 8192
    lw = _log_weights("random", 1, cap + 1, seed=5)[0].to(cuda)
    u0 = torch.tensor(0.5, device=cuda)
    before = SYSTEMATIC_KERNEL.launch_count
    got = systematic_resample_indices(lw, u0=u0)
    assert SYSTEMATIC_KERNEL.launch_count == before
    assert torch.equal(got, _torch_path(lw, u0, cap + 1))
    with pytest.raises(ValueError, match="rows of 1"):
        SYSTEMATIC_KERNEL(torch.softmax(lw, -1), u0, cap + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("fleet", [0, 3])
def test_a_program_s_replays_count_their_launches(cuda, fleet):
    """After the first calls (warm-up and capture), each replayed
    correction adds one launch: a fleet's rows are one launch."""
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
    SYSTEMATIC_KERNEL.launch_count = 0
    for _ in range(3):
        state, _ = pf.step_many(state, acts, scans)
    for i in range(5):
        state, _ = pf.step(state, acts[i], scans[i])
    torch.cuda.synchronize()
    assert pf.programs.cache
    assert SYSTEMATIC_KERNEL.launch_count == 3 * k + 5
