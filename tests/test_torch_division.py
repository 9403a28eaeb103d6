"""Division by a Python number in the port: ``utils/geometry.py`` ``div``
and the sites that go through it (``SensorModel.to_pixel_index`` and
``log_prob_analytic``, ``reconstruct_velocity``, the plain normaliser
``_log_norm``/``_log_norm_right``), on knife-edge inputs, bit for bit
against numpy float32 IEEE division.

CUDA torch divides a tensor by a Python number as a multiply by its
reciprocal, which misses the IEEE quotient in the last bit on 14-20% of
float32 inputs; the CPU and the kernels divide. ``div`` divides by a 0-d
tensor on the operand's device, so every device gives the CPU's bits
(``tests/test_torch_cuda.py`` holds the card to these same sites). The
erf and exp around a quotient are torch's on both sides of a test, so
the quotients the sites hand them are what is compared.
"""

import numpy as np
import pytest
import torch

from monte_carlo_localization_tpu_torch.models import sensor as sensor_mod
from monte_carlo_localization_tpu_torch.models.motion import reconstruct_velocity
from monte_carlo_localization_tpu_torch.models.sensor import SensorModel
from monte_carlo_localization_tpu_torch.ops import lut_query
from monte_carlo_localization_tpu_torch.utils.geometry import div

RES, MAX_PX = 0.05, 240


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def knife_edges(res: float, max_px: int, seed: int, extra: int = 4000) -> np.ndarray:
    """Float32 ranges at every half pixel (k + 0.5) * res and 1 ulp to
    either side, then ``extra`` uniform ones over the range."""
    half = ((np.arange(max_px + 1) + 0.5) * res).astype(np.float32)
    up, down = np.nextafter(half, np.float32(np.inf)), np.nextafter(half, np.float32(0))
    rest = np.random.default_rng(seed).uniform(0, 1.05 * max_px * res, extra).astype(np.float32)
    return np.concatenate([half, up, down, rest])


def _recording(monkeypatch, module, name):
    """Replace ``module.name`` by a pass-through that records its first
    argument."""
    seen = []
    real = getattr(module, name)

    def record(x, *args, **kwargs):
        seen.append(x.clone())
        return real(x, *args, **kwargs)

    monkeypatch.setattr(module, name, record)
    return seen


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("c", [RES, 5.0, 1.0, 0.0504, 8.0 * 2**0.5])
def test_div_is_ieee_division(dtype, c):
    x = knife_edges(RES, MAX_PX, 0).astype(dtype)
    got = div(torch.from_numpy(x), c)
    assert got.dtype == torch.from_numpy(x).dtype
    np.testing.assert_array_equal(got.numpy().view(np.uint8), (x / dtype(c)).view(np.uint8))


def test_div_of_an_integer_tensor_and_its_cached_divisor():
    got = div(torch.arange(10, dtype=torch.int32), 4.0)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.arange(10, dtype=np.float32) / np.float32(4))
    x = torch.ones(3)
    assert div(x, 0.05).data_ptr() != x.data_ptr()
    from monte_carlo_localization_tpu_torch.utils import geometry

    key = (0.05, torch.float32, x.device)
    assert key in geometry._DIVISORS and geometry._DIVISORS[key].dim() == 0


def test_to_pixel_index_on_knife_edges():
    r = knife_edges(RES, MAX_PX, 1)
    got = SensorModel.create(MAX_PX, RES, device="cpu").to_pixel_index(torch.from_numpy(r))
    px = np.clip(r / np.float32(RES), np.float32(0), np.float32(MAX_PX))
    np.testing.assert_array_equal(got.numpy(), np.floor(px + np.float32(0.5)).astype(np.int32))
    # the knife edges do land on both sides of a half pixel
    k = np.arange(MAX_PX + 1)
    n = MAX_PX + 1
    assert (got.numpy()[n:2 * n] > got.numpy()[2 * n:3 * n]).any()
    assert set(np.unique(got.numpy()[:n] - k)) <= {0, 1}


def test_reconstruct_velocity_on_afwd_over_zero_to_one():
    rng = np.random.default_rng(2)
    n = 20000
    fwd = (rng.uniform(0, 1, n) * rng.choice([-1, 1], n)).astype(np.float32)
    fwd[:4] = [0.1, np.nextafter(np.float32(0.1), np.float32(0)), 0.001, 0.0]
    dth = rng.uniform(-0.5, 0.5, n).astype(np.float32)
    action = np.stack([fwd, np.zeros(n, np.float32), dth], 1)
    dt, v, omega = reconstruct_velocity(torch.from_numpy(action))
    f32 = np.float32
    afwd = np.abs(fwd)
    dt_m = np.clip(np.where(afwd < f32(0.1), afwd / f32(1.0), afwd / f32(5.0)), f32(0.001), f32(0.1))
    has = afwd > f32(0.001)
    want_dt = np.where(has, dt_m, f32(0.01)).astype(np.float32)
    np.testing.assert_array_equal(dt.numpy(), want_dt)
    np.testing.assert_array_equal(v.numpy(), np.where(has, fwd / want_dt, f32(0)))
    np.testing.assert_array_equal(omega.numpy(),
                                  np.where(np.abs(dth) > f32(0.001), dth / want_dt, f32(0)))


def _query():
    beams = np.linspace(-2.3, 2.3, 60).astype(np.float32)
    t = lut_query.suggest_theta_bins(beams)
    return lut_query.LUTQuery(
        t, beams, height=8, width=8, resolution=RES, origin_x=0.0, origin_y=0.0,
        max_range_px=MAX_PX, row_stride=lut_query.required_row_stride(t, beams, 1), z_hit=0.8,
        z_short=0.01, z_max=0.07, z_rand=0.12, sigma_hit=8.0, inv_squash=1 / 2.2,
        device="cpu")


@pytest.mark.parametrize("fn", ["_log_norm", "_log_norm_right"])
def test_log_norm_quotients_on_knife_edges(monkeypatch, fn):
    """The plain normaliser's two erf arguments, (m - d + 0.5) / sq2 and
    (-d - 0.5) / sq2, are numpy's float32 quotients: d on whole and half
    pixels, 1 ulp to either side, and uniform over [0, m]."""
    q = _query()
    d = np.clip(knife_edges(1.0, MAX_PX, 3) - np.float32(0.5), 0, MAX_PX).astype(np.float32)
    seen = _recording(monkeypatch, lut_query, "_erf_as")
    out = getattr(lut_query, fn)(q, torch.from_numpy(d))
    assert torch.isfinite(out).all()
    f32 = np.float32
    want_hi = (f32(q.m) - d + f32(0.5)) / f32(q.sq2)
    want_lo = (-d - f32(0.5)) / f32(q.sq2)
    np.testing.assert_array_equal(seen[0].numpy(), want_hi)
    np.testing.assert_array_equal(seen[1].numpy(), want_lo)


def test_log_prob_analytic_quotients(monkeypatch):
    s = SensorModel.create(MAX_PX, RES, device="cpu")
    rng = np.random.default_rng(4)
    r = rng.integers(0, MAX_PX + 1, (16, 60)).astype(np.float32)
    d = rng.integers(0, MAX_PX + 1, (16, 60)).astype(np.float32)
    seen = _recording(monkeypatch, sensor_mod.torch.special, "erf")
    out = s.log_prob_analytic(torch.from_numpy(r), torch.from_numpy(d))
    assert torch.isfinite(out).all()
    f32 = np.float32
    sq2 = f32(2.0**0.5 * s.sigma_hit)
    np.testing.assert_array_equal(seen[0].numpy(), (f32(MAX_PX) - d + f32(0.5)) / sq2)
    np.testing.assert_array_equal(seen[1].numpy(), (-d - f32(0.5)) / sq2)
