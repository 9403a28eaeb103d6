"""The port's opt-in likelihood forms against the JAX package's Pallas query:
the sub-bin heading lerp (TPU kernel K3) and the unique-window kernels
(K4 ``dedup_slots``, K5 ``dedup_matmul``).

The same LUT, particles and scan, made by numpy from a seed, go through
``build_lut_query_fn(..., interpret=True)`` and through the port's
``LUTQuery`` on CPU tensors, i.e. its plain versions
``lut_log_weights_reference`` (K3) and ``lut_dedup_reference`` (K4/K5,
which reads every window through the slot table). Tolerance: atol 2e-3,
the JAX tests' own bound (tests/test_pallas_lut.py _assert_close); the
two sides differ in the order of the beam sum. The dedup plain version
must equal the standard one bit for bit, as the kernels must.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from monte_carlo_localization_tpu.ops import pallas_lut as jlut
from monte_carlo_localization_tpu_torch.ops import lut_query as tlut

Z = dict(z_hit=0.80, z_short=0.05, z_max=0.05, z_rand=0.10, sigma_hit=8.0,
         inv_squash=1.0 / 2.2)
RES = 0.05
BEAMS_60 = np.linspace(-2.35, 2.35, 60).astype(np.float32)
BEAMS_1080 = np.linspace(-0.75 * np.pi, 0.75 * np.pi, 1080).astype(np.float32)
CONVERGED = np.array([[0.71, 0.63, 1.1], [0.32, 0.21, -0.4], [1.12, 0.94, 2.0]],
                     np.float32)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _query_kw(beams, height=24, width=32, max_range_px=120):
    t = jlut.suggest_theta_bins(beams)
    dtype = np.uint8 if max_range_px <= 254 else np.uint16
    stride = jlut.required_row_stride(t, beams, itemsize=np.dtype(dtype).itemsize)
    return t, dict(height=height, width=width, resolution=RES, origin_x=0.0,
                   origin_y=0.0, max_range_px=max_range_px, row_stride=stride,
                   lut_dtype=dtype, **Z)


def _build(beams, n, *, block=16, **opts):
    geometry = {k: opts.pop(k) for k in ("height", "width", "max_range_px") if k in opts}
    t, kw = _query_kw(beams, **geometry)
    jq, jinfo = jlut.build_lut_query_fn(t, beams, n, block=block, interpret=True,
                                        **kw, **opts)
    tq = tlut.LUTQuery(t, beams, **kw, block=block, device="cpu", **opts)
    assert tq.info == jinfo
    return jq, tq, t, kw["row_stride"], kw["lut_dtype"]


def _run(rng, particles, beams=BEAMS_60, compact=False, **build):
    """Hold the port's query against the JAX query on one random LUT and
    scan; returns (port query, its output, the plain standard version's
    output on the same inputs)."""
    n = len(particles)
    jq, tq, t, stride, dtype = _build(beams, n, **build)
    h, w = tq.height, tq.width
    n_rows = h * w // 2 + 1 if compact else h * w
    base = rng.integers(0, int(tq.m) + 1, (n_rows, t)).astype(dtype)
    lut = np.tile(base, (1, -(-stride // t)))[:, :stride].reshape(-1).copy()
    row_map = rng.integers(0, n_rows, h * w).astype(np.int32) if compact else None
    obs = rng.uniform(0, tq.m * 1.1, len(beams)).astype(np.float32)
    want = np.asarray(jq(jnp.asarray(lut), jnp.asarray(particles), jnp.asarray(obs),
                         row_map=None if row_map is None else jnp.asarray(row_map)))
    args = [torch.from_numpy(a) for a in (lut, particles, obs)]
    rm = None if row_map is None else torch.from_numpy(row_map)
    got = tq(*args, row_map=rm)
    plain = tlut.lut_log_weights_reference(tq, *args, row_map=rm)
    assert tq.launch_count == tq.dedup_launch_count == 0  # CPU: plain versions
    np.testing.assert_array_equal(got.numpy() == -1e4, want == -1e4)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-3)
    return tq, got, plain


def _unique_cloud(rng, n, width=32):
    """Every particle in its own cell with its own heading."""
    x = (np.arange(n) % width) * RES + 0.026
    y = (np.arange(n) // width) * RES + 0.026
    return np.stack([x, y, rng.uniform(-math.pi, math.pi, n)], 1).astype(np.float32)


@pytest.mark.parametrize("opts", [dict(dedup_slots=8), dict(dedup_slots=8, dedup_matmul=True)],
                         ids=["K4", "K5"])
def test_converged_cloud_reads_slots_only(opts):
    rng = np.random.default_rng(20)
    tq, got, plain = _run(rng, CONVERGED[rng.integers(0, 3, 64)], **opts)
    assert torch.equal(got, plain)
    assert int(tq.last_overflow) == 0


@pytest.mark.parametrize("opts", [dict(dedup_slots=8), dict(dedup_slots=8, dedup_matmul=True)],
                         ids=["K4", "K5"])
def test_unique_cloud_overflows_every_block(opts):
    rng = np.random.default_rng(21)
    tq, got, plain = _run(rng, _unique_cloud(rng, 64), **opts)
    assert torch.equal(got, plain)
    assert int(tq.last_overflow) == 64 // 16


def test_mixed_duplicates_singletons_and_off_map():
    rng = np.random.default_rng(22)
    particles = np.tile(CONVERGED[0], (48, 1))
    particles[3] = CONVERGED[1]
    particles[17] = [-3.0, 0.5, 0.0]  # off the map
    particles[31] = CONVERGED[2]
    rng.shuffle(particles)
    tq, got, plain = _run(rng, particles, dedup_slots=4)
    assert torch.equal(got, plain)
    assert int((got == -1e4).sum()) == 1


@pytest.mark.parametrize("opts", [dict(dedup_slots=4), dict(subbin=True),
                                  dict(dedup_slots=4, subbin=True)],
                         ids=["K4", "K3", "K3+K4"])
def test_u16_lut(opts):
    rng = np.random.default_rng(23)
    tq, got, plain = _run(rng, CONVERGED[rng.integers(0, 2, 32)], max_range_px=600, **opts)
    assert torch.equal(got, plain)


def test_subbin_random_particles_with_off_map_and_full_turns():
    rng = np.random.default_rng(30)
    n = 64
    particles = np.stack([rng.uniform(-0.1, 1.7, n), rng.uniform(-0.1, 1.3, n),
                          rng.uniform(-2 * math.pi, 2 * math.pi, n)], 1).astype(np.float32)
    particles[0, 2], particles[1, 2] = -2 * math.pi, 2 * math.pi
    tq, got, plain = _run(rng, particles, subbin=True)
    assert 0 < int((got == -1e4).sum()) < n
    assert torch.equal(got, plain)


def test_subbin_wraparound_bins():
    rng = np.random.default_rng(31)
    n = 48
    particles = np.stack([rng.uniform(0.11, 1.49, n), rng.uniform(0.11, 1.09, n),
                          rng.uniform(2 * math.pi - 0.3, 2 * math.pi + 0.3, n)],
                         1).astype(np.float32)
    _run(rng, particles, subbin=True)


@pytest.mark.parametrize("opts", [dict(subbin=True), dict(dedup_slots=4)], ids=["K3", "K4"])
def test_1080_beams(opts):
    rng = np.random.default_rng(33)
    particles = np.stack([rng.uniform(0.02, 0.78, 16), rng.uniform(0.02, 0.78, 16),
                          rng.uniform(-math.pi, math.pi, 16)], 1).astype(np.float32)
    _run(rng, particles, beams=BEAMS_1080, height=16, width=16, **opts)


@pytest.mark.parametrize("opts", [dict(subbin=True), dict(dedup_slots=4),
                                  dict(dedup_slots=4, dedup_matmul=True, subbin=True)],
                         ids=["K3", "K4", "K3+K5"])
def test_compact_row_map(opts):
    rng = np.random.default_rng(34)
    tq, got, plain = _run(rng, CONVERGED[rng.integers(0, 3, 64)], compact=True, **opts)
    assert torch.equal(got, plain)


def test_dedup_with_subbin_equals_standard_bit_for_bit():
    rng = np.random.default_rng(35)
    particles = CONVERGED[rng.integers(0, 3, 64)]
    particles[::7, 2] += np.float32(0.003)  # same window, another fraction
    tq, got, plain = _run(rng, particles, dedup_slots=8, subbin=True)
    assert torch.equal(got, plain)
    assert int(tq.last_overflow) == 0


@pytest.mark.parametrize("block", [16, 24])
def test_plan_ranks_and_slots(block):
    """A ragged last block too: ranks count distinct keys per block, the
    slot table holds each block's first S keys, and the plain version
    reads through them."""
    rng = np.random.default_rng(36)
    t, kw = _query_kw(BEAMS_60)
    tq = tlut.LUTQuery(t, BEAMS_60, **kw, block=block, dedup_slots=3, device="cpu")
    stride, dtype = kw["row_stride"], kw["lut_dtype"]
    particles = torch.from_numpy(np.concatenate(
        [CONVERGED[rng.integers(0, 3, 50)], _unique_cloud(rng, 14)]))
    perm, rank, slot_y0, overflow = tlut.dedup_plan(tq, particles)
    row, b0, _, oob = tlut.window_start(tq, particles)
    key = (row * (stride // tq.eps) + b0 // tq.eps)[perm]
    nb = -(-64 // block)
    for b in range(nb):
        k = key[b * block:(b + 1) * block]
        distinct = torch.unique_consecutive(k)
        assert torch.equal(rank[b * block:(b + 1) * block],
                           torch.searchsorted(distinct, k).to(torch.int32))
        assert torch.equal(slot_y0[b * 3:b * 3 + min(3, len(distinct))], distinct[:3])
    assert int(overflow) == sum(
        len(torch.unique(key[b * block:(b + 1) * block])) > 3 for b in range(nb))
    lut = torch.from_numpy(rng.integers(0, 121, 24 * 32 * stride).astype(dtype))
    obs = torch.from_numpy(rng.uniform(0, 130, 60).astype(np.float32))
    got, n_over = tlut.lut_dedup_reference(tq, lut, particles, obs)
    assert torch.equal(got, tlut.lut_log_weights_reference(tq, lut, particles, obs))
    assert int(n_over) == int(overflow)


def test_validation_errors():
    t, kw = _query_kw(BEAMS_60, height=8, width=8, max_range_px=100)
    kw["device"] = "cpu"
    with pytest.raises(ValueError, match="dedup_matmul requires dedup_slots"):
        tlut.LUTQuery(t, BEAMS_60, **kw, dedup_matmul=True)
    with pytest.raises(ValueError, match="at most 128 slots"):
        tlut.LUTQuery(t, BEAMS_60, **kw, dedup_matmul=True, dedup_slots=200, block=256)
    with pytest.raises(ValueError, match="block"):
        tlut.LUTQuery(t, BEAMS_60, **kw, block=0)
    q = tlut.LUTQuery(t, BEAMS_60, **kw, dedup_slots=200, block=16)
    assert q.dedup_slots == q.info["dedup_slots"] == 16  # min(S, block), as JAX
    assert tlut.LUTQuery(t, BEAMS_60, **kw, dedup_slots=-1).dedup_slots == 0
    with pytest.raises(ValueError, match="CUDA"):
        q.launch_dedup(torch.zeros(8 * 8 * kw["row_stride"], dtype=torch.uint8),
                       torch.zeros(4, 3), torch.zeros(60))
