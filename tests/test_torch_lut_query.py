"""The port's fused LUT likelihood against the JAX package's Pallas query.

The same LUT, particles and scan, made by numpy from a seed, go through
``build_lut_query_fn(..., interpret=True)`` (the Pallas kernel as the JAX
tests run it on the CPU) and through the port's ``LUTQuery`` on CPU
tensors, i.e. its plain PyTorch version ``lut_log_weights_reference``.
Tolerance: atol 2e-3, the JAX tests' own bound for this kernel
(tests/test_pallas_lut.py _assert_close); both sides are float32 with the
same A&S erf and differ only in the order of the beam sum.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from monte_carlo_localization_tpu.ops import pallas_lut as jlut
from monte_carlo_localization_tpu_torch.ops import lut_query as tlut

Z_HIT, Z_SHORT, Z_MAX, Z_RAND = 0.80, 0.05, 0.05, 0.10
SIGMA = 8.0
INV_SQUASH = 1.0 / 2.2
H, W, RES = 24, 32, 0.05
OX, OY = -0.3, 0.2
BEAMS_60 = np.linspace(-2.35, 2.35, 60).astype(np.float32)
BEAMS_200 = np.linspace(-2.35, 2.35, 200).astype(np.float32)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _lut_rows(rng, n_rows, stride, t_bins, max_range_px):
    """Random LUT rows with the wraparound tail (entry b = bin b % T)."""
    dtype = np.uint8 if max_range_px <= 254 else np.uint16
    base = rng.integers(0, max_range_px + 1, size=(n_rows, t_bins)).astype(dtype)
    reps = -(-stride // t_bins)
    return np.tile(base, (1, reps))[:, :stride].copy()


def _particles(rng, n):
    """In-map particles plus ones off each edge, ones less than a cell
    below the origin (inside: the cast truncates toward zero) and ones
    more than a cell below (outside); theta in [-2pi, 2pi]."""
    x = rng.uniform(OX + 0.01, OX + W * RES - 0.01, n)
    y = rng.uniform(OY + 0.01, OY + H * RES - 0.01, n)
    x[0], y[1] = OX - 0.5 * RES, OY - 0.5 * RES  # inside by truncation
    x[2], y[3] = OX - 1.5 * RES, OY - 1.5 * RES  # outside
    x[4], y[5] = OX + W * RES + 0.1, OY + H * RES + 0.1  # outside
    theta = rng.uniform(-2 * math.pi, 2 * math.pi, n)
    theta[6], theta[7] = -2 * math.pi, 2 * math.pi
    return np.stack([x, y, theta], 1).astype(np.float32)


def _queries(beams, n, max_range_px):
    t = jlut.suggest_theta_bins(beams)
    dtype = np.uint8 if max_range_px <= 254 else np.uint16
    stride = jlut.required_row_stride(t, beams, itemsize=np.dtype(dtype).itemsize)
    kw = dict(
        height=H, width=W, resolution=RES, origin_x=OX, origin_y=OY,
        max_range_px=max_range_px, row_stride=stride, z_hit=Z_HIT,
        z_short=Z_SHORT, z_max=Z_MAX, z_rand=Z_RAND, sigma_hit=SIGMA,
        inv_squash=INV_SQUASH, lut_dtype=dtype,
    )
    jq, _ = jlut.build_lut_query_fn(t, beams, n, block=8, interpret=True, **kw)
    tq = tlut.LUTQuery(t, beams, **kw, device="cpu")
    return jq, tq, t, stride


@pytest.mark.parametrize("compact", [False, True], ids=["dense", "row_map"])
@pytest.mark.parametrize("max_range_px", [120, 400], ids=["u8", "u16"])
@pytest.mark.parametrize("beams", [BEAMS_60, BEAMS_200], ids=["r60_K2", "r200_K1"])
def test_plain_likelihood_matches_pallas_query(beams, max_range_px, compact):
    rng = np.random.default_rng(len(beams) * 7 + max_range_px + compact)
    n = 24
    jq, tq, t, stride = _queries(beams, n, max_range_px)
    if compact:
        n_rows = H * W // 2 + 1
        row_map = rng.integers(0, n_rows, size=H * W).astype(np.int32)
    else:
        n_rows, row_map = H * W, None
    lut = _lut_rows(rng, n_rows, stride, t, max_range_px).reshape(-1)
    parts = _particles(rng, n)
    obs = rng.uniform(0, max_range_px * 1.1, len(beams)).astype(np.float32)

    want = np.asarray(jq(
        jnp.asarray(lut), jnp.asarray(parts), jnp.asarray(obs),
        row_map=None if row_map is None else jnp.asarray(row_map),
    ))
    got = tq(
        torch.from_numpy(lut), torch.from_numpy(parts), torch.from_numpy(obs),
        row_map=None if row_map is None else torch.from_numpy(row_map),
    ).numpy()
    assert tq.launch_count == 0  # CPU tensors take the plain version
    assert (want[[2, 3, 4, 5]] == -1e4).all() and (want[[0, 1]] > -1e4).all()
    np.testing.assert_array_equal(got == -1e4, want == -1e4)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-3)


@pytest.mark.parametrize("beams", [BEAMS_60, np.linspace(-0.75 * np.pi, 0.75 * np.pi, 1080)])
def test_geometry_helpers_match(beams):
    for target in (720, 1440):
        t = jlut.suggest_theta_bins(beams, target)
        assert tlut.suggest_theta_bins(beams, target) == t
        jb, jk, je = jlut.beam_geometry(beams, t)
        tb, tk, te = tlut.beam_geometry(beams, t)
        assert (jb, jk) == (tb, tk)
        np.testing.assert_array_equal(je, te)
        for itemsize in (1, 2):
            assert tlut.entries_per_subrow(itemsize) == jlut.entries_per_subrow(itemsize)
            assert (tlut.window_entries(t, beams, itemsize)
                    == jlut.window_entries(t, beams, itemsize))
            assert (tlut.required_row_stride(t, beams, itemsize)
                    == jlut.required_row_stride(t, beams, itemsize))


def test_unsupported_geometry_raises():
    t = tlut.suggest_theta_bins(BEAMS_60)
    kw = dict(
        height=H, width=W, resolution=RES, origin_x=OX, origin_y=OY,
        max_range_px=120, row_stride=4096, z_hit=Z_HIT, z_short=Z_SHORT,
        z_max=Z_MAX, z_rand=Z_RAND, sigma_hit=SIGMA, inv_squash=INV_SQUASH,
        device="cpu",
    )
    repeated = np.concatenate([BEAMS_60[:11], BEAMS_60[10:]])  # beam 10 twice
    with pytest.raises(ValueError, match="one LUT entry"):
        tlut.LUTQuery(t, repeated, **kw)
    with pytest.raises(ValueError, match="row_stride"):
        tlut.LUTQuery(t, BEAMS_60, **{**kw, "row_stride": 512})
    full_circle = np.linspace(-np.pi, np.pi, 60)  # first and last beam share a bin
    with pytest.raises(ValueError, match="spans"):
        tlut.LUTQuery(tlut.suggest_theta_bins(full_circle), full_circle, **kw)
