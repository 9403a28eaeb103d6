"""The port's sensor, motion, resampling and pose math against the JAX
package on the same inputs, made by numpy from a seed.

Tolerances: pixel indices and resampling indices must be equal (the same
float32 operations); float results hold 1e-5 (float32 transcendentals
and sum orders differ between XLA and PyTorch by a few ulp).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from monte_carlo_localization_tpu.filter.core import expected_pose as j_expected_pose
from monte_carlo_localization_tpu.models.motion import motion_model as j_motion_model
from monte_carlo_localization_tpu.models.sensor import SensorModel as JSensorModel
from monte_carlo_localization_tpu.models.sensor import build_sensor_table as j_sensor_table
from monte_carlo_localization_tpu.ops.resample import (
    systematic_invert_cdf_window as j_invert,
    systematic_resample_indices as j_systematic,
)
from monte_carlo_localization_tpu_torch.filter.core import expected_pose
from monte_carlo_localization_tpu_torch.models.motion import motion_model
from monte_carlo_localization_tpu_torch.models.sensor import (
    SensorModel,
    build_sensor_table,
)
from monte_carlo_localization_tpu_torch.ops.resample import (
    multinomial_resample_indices,
    resample_indices,
    systematic_invert_cdf_window,
)

SENSOR_KW = dict(max_range_px=240, resolution=0.05, z_hit=0.8, z_short=0.01,
                 z_max=0.07, z_rand=0.12, sigma_hit=8.0, squash_factor=2.2)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def test_to_pixel_index_matches_exactly():
    rng = np.random.default_rng(0)
    ranges = rng.uniform(-1.0, 14.0, 500).astype(np.float32)
    ranges[:6] = [np.nan, np.inf, -np.inf, 0.0, 0.025, 12.0 + 0.025]
    ranges[6:10] = (np.arange(4) + 0.5) * 0.05  # exact half pixels
    want = np.asarray(JSensorModel.create(**SENSOR_KW).to_pixel_index(jnp.asarray(ranges)))
    got = SensorModel.create(**SENSOR_KW).to_pixel_index(torch.from_numpy(ranges))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_log_prob_analytic_and_table_match():
    rng = np.random.default_rng(1)
    r = rng.integers(0, 241, (64, 60)).astype(np.float32)
    d = rng.integers(0, 241, (64, 60)).astype(np.float32)
    js, ts = JSensorModel.create(**SENSOR_KW), SensorModel.create(**SENSOR_KW)
    want = np.asarray(js.log_prob_analytic(jnp.asarray(r), jnp.asarray(d)))
    got = ts.log_prob_analytic(torch.from_numpy(r), torch.from_numpy(d)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(build_sensor_table(240), j_sensor_table(240))
    np.testing.assert_array_equal(ts.log_table.numpy(), np.asarray(js.log_table))
    obs_m = rng.uniform(0, 12.5, 60).astype(np.float32)
    exp_m = rng.uniform(0, 12.5, (32, 60)).astype(np.float32)
    for mode in ("table", "analytic"):
        want = np.asarray(js.log_likelihood(jnp.asarray(obs_m), jnp.asarray(exp_m), mode=mode))
        got = ts.log_likelihood(torch.from_numpy(obs_m), torch.from_numpy(exp_m), mode=mode)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-4)


@pytest.mark.parametrize("exact_dt", [True, False])
@pytest.mark.parametrize("action", [
    [0.05, 0.0, 0.01],   # arc
    [0.3, 0.0, -0.2],    # fast arc, saturating dt clamp
    [0.05, 0.0, 0.0],    # straight
    [0.0, 0.0, 0.0],     # standing still
    [0.0005, 0.0, 1e-7],  # below both motion thresholds
])
def test_motion_model_matches_given_jax_noise(action, exact_dt):
    n = 256
    rng = np.random.default_rng(2)
    parts = np.stack([rng.uniform(-5, 5, n), rng.uniform(-5, 5, n),
                      rng.uniform(-np.pi, np.pi, n)], 1).astype(np.float32)
    action = np.asarray(action, np.float32)
    k_mot = jax.random.key(3)
    noise = np.array(jax.random.normal(k_mot, (n, 3), jnp.float32))
    want = np.asarray(j_motion_model(k_mot, jnp.asarray(parts), jnp.asarray(action),
                                     exact_dt_heuristic=exact_dt))
    got = motion_model(torch.from_numpy(parts), torch.from_numpy(action),
                       exact_dt_heuristic=exact_dt, noise=torch.from_numpy(noise))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("slot0,window", [(0, 512), (100, 200), (448, 64)])
def test_systematic_inversion_equal_on_shared_cdf(slot0, window):
    """One CDF (built once, in numpy) and one u0 give equal indices; f32
    cumsum order differs between the packages, so the CDF is shared."""
    rng = np.random.default_rng(4)
    n = 512
    w = rng.gamma(0.3, size=n)
    w[rng.random(n) < 0.3] = 0.0  # zero-count sources collide on slots
    cdf = np.cumsum(w / w.sum()).astype(np.float32)
    for u0 in (0.0, 0.37, 0.9999):
        want = np.asarray(j_invert(jnp.asarray(cdf), jnp.float32(u0), n, slot0, window))
        got = systematic_invert_cdf_window(
            torch.from_numpy(cdf), torch.tensor(u0, dtype=torch.float32), n, slot0, window
        )
        np.testing.assert_array_equal(got.numpy(), want)


def test_systematic_resample_matches_jax_draw():
    rng = np.random.default_rng(5)
    logw = (rng.normal(size=300) * 3).astype(np.float32)
    key = jax.random.key(6)
    u0 = float(jax.random.uniform(key, ()))
    want = np.asarray(j_systematic(key, jnp.asarray(logw)))
    got = resample_indices(torch.from_numpy(logw), "systematic", u0=u0).numpy()
    assert np.mean(got == want) >= 0.99  # a knife-edge slot may flip
    gen = torch.Generator().manual_seed(0)
    idx = multinomial_resample_indices(torch.from_numpy(logw), generator=gen)
    assert idx.dtype == torch.int32 and idx.shape == (300,)
    assert idx.min() >= 0 and idx.max() < 300


def test_expected_pose_matches():
    rng = np.random.default_rng(7)
    parts = np.stack([rng.normal(3, 0.2, 400), rng.normal(-1, 0.2, 400),
                      rng.normal(3.1, 0.3, 400)], 1).astype(np.float32)  # wraps at pi
    logw = (rng.normal(size=400) * 4).astype(np.float32)
    want = np.asarray(j_expected_pose(jnp.asarray(parts), jnp.asarray(logw)))
    got = expected_pose(torch.from_numpy(parts), torch.from_numpy(logw)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
