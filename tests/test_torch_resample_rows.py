"""The port's row resamplers (``ops/resample.py`` ``systematic_rows_from_cdf``,
``systematic_resample_rows``, ``resample_rows``, ``_last_valid_scan``)
against the JAX package's, bit for bit on one shared CDF.

JAX computes its CDF as an f32 ``cumsum`` of the softmax, the port as a
float64 doubling prefix sum (``weight_cdf``), so the parity cases hand
both the same f32 CDF: JAX's own, or uniform weights over a power-of-two
count, whose CDF is exact in both. The knife-edge case is an f32 CDF that
ends below 1 with u0 above its last value, where no source covers slot 0
and the covering source is clipped to N - 1 (JAX ``resample.py:147-153``);
it is held to the gather of JAX's ``systematic_invert_cdf_window``."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from monte_carlo_localization_tpu.ops import resample as jres
from monte_carlo_localization_tpu_torch.ops import resample as tres


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _cloud(seed, n):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, 3)).astype(np.float32),
            rng.normal(scale=2.0, size=n).astype(np.float32))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("n, m", [(64, 64), (100, 37), (50, 130)])
def test_systematic_rows_bitwise_on_jax_cdf(seed, n, m):
    particles, logw = _cloud(seed, n)
    key = jax.random.key(seed)
    want = np.asarray(jres.systematic_resample_rows(key, jnp.asarray(logw),
                                                    jnp.asarray(particles), m))
    cdf = np.array(jnp.cumsum(jax.nn.softmax(jnp.asarray(logw))))
    u0 = np.array(jax.random.uniform(key, ()))
    got = tres.systematic_rows_from_cdf(torch.from_numpy(cdf), torch.from_numpy(u0),
                                        torch.from_numpy(particles), m)
    assert got.shape == (m, 3)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", [3, 4])
@pytest.mark.parametrize("n, m", [(64, 64), (128, 45), (64, 200)])
def test_resample_rows_bitwise_on_an_exact_cdf(seed, n, m):
    """Uniform weights over 2^k sources: both CDFs are exact, so the whole
    functions (the port's ``weight_cdf`` inside) meet bit for bit."""
    particles, _ = _cloud(seed, n)
    logw = np.zeros(n, np.float32)
    key = jax.random.key(seed)
    u0 = float(jax.random.uniform(key, ()))
    want = np.asarray(jres.resample_rows(key, jnp.asarray(logw), jnp.asarray(particles),
                                         num_samples=m))
    got = tres.resample_rows(torch.from_numpy(logw), torch.from_numpy(particles),
                             num_samples=m, u0=u0)
    np.testing.assert_array_equal(got.numpy(), want)
    rows = tres.systematic_resample_rows(torch.from_numpy(logw), torch.from_numpy(particles),
                                         num_samples=m, u0=u0)
    np.testing.assert_array_equal(rows.numpy(), want)


@pytest.mark.parametrize("m", [1, 3])
def test_knife_edge_slot_zero_takes_the_last_source(m):
    particles, _ = _cloud(5, 3)
    cdf = np.float32([0.2, 0.5, 0.9999999])  # f32 round-off: ends below 1
    u0 = np.float32(0.99999997)  # above cdf[-1]: every g < 0 when m == 1
    idx = np.asarray(jres.systematic_invert_cdf_window(jnp.asarray(cdf), jnp.asarray(u0), m, 0, m))
    got = tres.systematic_rows_from_cdf(torch.from_numpy(cdf), torch.tensor(u0),
                                        torch.from_numpy(particles), m)
    np.testing.assert_array_equal(got.numpy(), particles[idx])
    if m == 1:  # no j with g[j] >= 0: j0 = 3, clipped to source 2
        np.testing.assert_array_equal(got[0].numpy(), particles[2])


@pytest.mark.parametrize("first_valid", [True, False])
def test_last_valid_scan_matches_jax(first_valid):
    rng = np.random.default_rng(6)
    valid = rng.random(40) < 0.3
    valid[0] = first_valid
    rows = rng.normal(size=(40, 3)).astype(np.float32)
    j_seen, j_rows = jres._last_valid_scan(jnp.asarray(valid), jnp.asarray(rows))
    t_seen, t_rows = tres._last_valid_scan(torch.from_numpy(valid), torch.from_numpy(rows))
    np.testing.assert_array_equal(t_rows.numpy(), np.asarray(j_rows))
    np.testing.assert_array_equal(t_seen.numpy(), np.asarray(j_seen))


def test_rows_equal_the_gather_of_the_indices():
    particles, logw = _cloud(7, 300)
    lw, p = torch.from_numpy(logw), torch.from_numpy(particles)
    idx = tres.systematic_resample_indices(lw, num_samples=200, u0=0.37)
    rows = tres.systematic_resample_rows(lw, p, num_samples=200, u0=0.37)
    assert torch.equal(rows, p[idx.long()])
    gen_a, gen_b = torch.Generator().manual_seed(8), torch.Generator().manual_seed(8)
    multi = tres.resample_rows(lw, p, method="multinomial", generator=gen_a)
    assert torch.equal(multi, p[tres.resample_indices(lw, "multinomial", generator=gen_b).long()])
    with pytest.raises(ValueError, match="Unknown resample method"):
        tres.resample_rows(lw, p, method="stratified")
