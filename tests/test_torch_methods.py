"""The port's ``sphere``, ``dda`` and ``lut`` likelihood methods against the
JAX package's, on the CPU.

Maps are made from one seeded occupancy array in both packages; every
LUT the port builds here is its own (native route) and is first held
bit-equal to the JAX one. Gates:

- ``cast_rays_lut`` and ``lut_expected_px``: bit-equal (one LUT read per
  ray, the same float32 address math), with negative and > 2 pi angles,
  off-map particles, a dense and a row-compacted LUT;
- ``sensor_update``: ``lut`` within 1e-4 (the same expected ranges; the
  beam sums differ in order and the analytic erf by an ulp, as in
  ``tests/test_torch_models.py``); ``sphere`` and ``dda`` the same on at
  least 95% of particles, and every particle within 0.5: ``cos``/``sin``
  may differ by an ulp, which moves a grazing ray by one cell
  (``tests/test_torch_raycast.py``);
- chained ``step_many`` on the JAX key chain's draws: poses within 1e-3,
  at least 99% of particle rows within 1e-4, as ``tests/test_torch_filter.py``
  holds ``lut_pallas``;
- a fleet on a shared and on a stacked map under ``lut`` (and ``sphere``)
  the same way as ``tests/test_torch_fleet.py``;
- an auto-selected fused kernel on a beam set it cannot serve falls back
  to ``lut`` with the JAX warning; an explicit one raises, and so does a
  LUT build that fails (no fallback hides it).
"""

import math
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from monte_carlo_localization_tpu.config import MCLConfig as JMCLConfig
from monte_carlo_localization_tpu.filter import ParticleFilter as JParticleFilter
from monte_carlo_localization_tpu.filter.core import sensor_update as j_sensor_update
from monte_carlo_localization_tpu.mapping import map_from_occupancy as j_map_from_occupancy
from monte_carlo_localization_tpu.models.sensor import SensorModel as JSensorModel
from monte_carlo_localization_tpu.ops import raycast as jray
from monte_carlo_localization_tpu.parallel import FleetFilter as JFleetFilter
from monte_carlo_localization_tpu.parallel import stack_maps as j_stack_maps
from monte_carlo_localization_tpu_torch import MCLConfig, MCLState, ParticleFilter
from monte_carlo_localization_tpu_torch.filter.core import sensor_update
from monte_carlo_localization_tpu_torch.mapping import GridMap, map_from_occupancy
from monte_carlo_localization_tpu_torch.models.sensor import SensorModel
from monte_carlo_localization_tpu_torch.ops import raycast as tray
from monte_carlo_localization_tpu_torch.parallel import FleetFilter, FleetState, stack_maps

RES = 0.05
BEAMS = np.linspace(-2.35, 2.35, 60).astype(np.float32)
SENSOR = dict(z_hit=0.8, z_short=0.01, z_max=0.07, z_rand=0.12, sigma_hit=8.0,
              squash_factor=2.2)
METHODS = ["sphere", "dda", "lut"]


@pytest.fixture(autouse=True)
def _one_thread_private_lut_cache(monkeypatch, tmp_path):
    torch.set_num_threads(1)
    monkeypatch.setenv("MCL_LUT_CACHE", str(tmp_path / "lut_cache"))


def _occupancy(h, w, seed, obstacles=5):
    rng = np.random.default_rng(seed)
    occ = np.zeros((h, w), np.int8)
    occ[:3, :] = occ[-3:, :] = occ[:, :3] = occ[:, -3:] = 100
    for _ in range(obstacles):
        oh, ow = rng.integers(3, 9, 2)
        r, c = rng.integers(8, h - 8 - oh), rng.integers(8, w - 8 - ow)
        occ[r:r + oh, c:c + ow] = 100
    return occ


def _map_pair(h=64, w=80, origin=(-1.0, 0.5, 0.0), seed=1, max_range_meters=3.0):
    occ = _occupancy(h, w, seed)
    kw = dict(resolution=RES, origin=origin, max_range_meters=max_range_meters)
    return j_map_from_occupancy(occ, **kw), map_from_occupancy(occ, **kw, device="cpu")


@pytest.fixture(scope="module")
def pair():
    return _map_pair()


def _particles(tm, n, seed, spread=0.4):
    """Particles over the map and up to ``spread`` m past its edges, with
    headings in [-4 pi, 4 pi]."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(tm.origin_x - spread, tm.origin_x + tm.width * RES + spread, n)
    y = rng.uniform(tm.origin_y - spread, tm.origin_y + tm.height * RES + spread, n)
    a = rng.uniform(-4 * np.pi, 4 * np.pi, n)
    return np.stack([x, y, a], 1).astype(np.float32)


def _truth_scan(jm, pose, beams=BEAMS):
    q = np.stack([np.full(len(beams), pose[0]), np.full(len(beams), pose[1]),
                  pose[2] + beams], 1).astype(np.float32)
    return np.asarray(jray.cast_rays_dda(jm, jnp.asarray(q)))


@pytest.mark.parametrize("compact", [False, True], ids=["dense", "row_map"])
def test_lut_casts_equal_jax(pair, compact):
    jm, tm = pair
    t = 90
    if compact:
        jl, tl = jm.with_compact_range_lut(t, 512), tm.with_compact_range_lut(t, 512)
        np.testing.assert_array_equal(tl.lut_row_map.numpy(), np.asarray(jl.lut_row_map))
    else:
        jl = jm.with_range_lut(t, use_cache=False)
        tl = tm.with_range_lut(t, use_cache=False)
    np.testing.assert_array_equal(tl.range_lut.numpy(), np.asarray(jl.range_lut).reshape(-1))
    q = _particles(tm, 3000, seed=2)
    want = np.asarray(jray.cast_rays_lut(jl, jnp.asarray(q)))
    got = tray.cast_rays_lut(tl, torch.from_numpy(q)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got == 0).any() and (got == np.float32(tm.max_range_meters)).any()
    parts = _particles(tm, 400, seed=3)
    want = np.asarray(jray.lut_expected_px(jl, jnp.asarray(parts), jnp.asarray(BEAMS)))
    got = tray.lut_expected_px(tl, torch.from_numpy(parts), torch.from_numpy(BEAMS)).numpy()
    np.testing.assert_array_equal(got, want)
    off = (got == 0).all(axis=1)
    assert 0 < off.sum() < len(parts)  # some particles off the map read 0 px
    np.testing.assert_array_equal(
        tray.cast_rays(tl, torch.from_numpy(q), method="lut").numpy(),
        tray.cast_rays_lut(tl, torch.from_numpy(q)).numpy())


def test_lut_cast_reads_u16_entries():
    jm, tm = _map_pair(300, 300, max_range_meters=16.0)  # 320 px: u16 entries
    jl, tl = jm.with_range_lut(36, use_cache=False), tm.with_range_lut(36, use_cache=False)
    assert tl.range_lut.dtype == torch.uint16
    q = _particles(tm, 2000, seed=4, spread=0.0)
    want = np.asarray(jray.cast_rays_lut(jl, jnp.asarray(q)))
    np.testing.assert_array_equal(tray.cast_rays_lut(tl, torch.from_numpy(q)).numpy(), want)
    assert want.max() > 254 * RES


def test_lut_cast_refuses_what_it_cannot_read(pair):
    _, tm = pair
    q = torch.zeros((4, 3))
    with pytest.raises(ValueError, match="with_range_lut"):
        tray.cast_rays_lut(tm, q)
    with pytest.raises(ValueError, match="Unknown raycast method"):
        tray.cast_rays(tm, q, method="nope")
    fleet = stack_maps([tm, tm]).with_member_luts(90, 512, 512)
    with pytest.raises(ValueError, match="tight member blocks"):
        tray.cast_rays_lut(fleet, torch.zeros((2, 4, 3)))


@pytest.mark.parametrize("mode", ["analytic", "table"])
@pytest.mark.parametrize("method", METHODS)
def test_sensor_update_matches_jax(pair, method, mode):
    jm, tm = pair
    if method == "lut":
        jm, tm = jm.with_range_lut(180, use_cache=False), tm.with_range_lut(180, use_cache=False)
    js = JSensorModel.create(max_range_px=jm.max_range_px, resolution=RES, **SENSOR)
    ts = SensorModel.create(max_range_px=tm.max_range_px, resolution=RES, **SENSOR, device="cpu")
    parts = _particles(tm, 256, seed=5, spread=0.1)
    obs = _truth_scan(jm, parts[0]) + np.random.default_rng(6).normal(0, 0.03, 60).astype(np.float32)
    kw = dict(raycast_method=method, sphere_march_iters=48, sensor_mode=mode)
    want = np.asarray(j_sensor_update(jnp.asarray(parts), jnp.asarray(obs), jnp.asarray(BEAMS),
                                      jm, js, **kw))
    got = sensor_update(torch.from_numpy(parts), torch.from_numpy(obs), torch.from_numpy(BEAMS),
                        tm, ts, **kw).numpy()
    assert got.shape == want.shape == (256,)
    diff = np.abs(got - want)
    if method == "lut":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-4)
    else:
        assert (diff <= 1e-4).mean() >= 0.95, f"{(diff <= 1e-4).mean():.3f} particles equal"
        assert diff.max() <= 0.5, diff.max()


def _jax_draws(key, n, steps):
    """(u0 (K,), noise (K, N, 3)) that K chained JAX corrections draw."""
    u0, noise = [], []
    for _ in range(steps):
        key, kr, km = jax.random.split(key, 3)
        u0.append(float(jax.random.uniform(kr, ())))
        noise.append(np.array(jax.random.normal(km, (n, 3), jnp.float32)))
    return np.float32(u0), np.stack(noise)


def _close(tposes, jposes, tparts, jparts, what):
    np.testing.assert_allclose(tposes, jposes, rtol=0, atol=1e-3, err_msg=what)
    row_ok = np.all(np.abs(tparts - jparts) <= 1e-4, axis=-1)
    assert row_ok.mean() >= 0.99, f"{what}: {row_ok.mean():.3f} rows equal"


@pytest.mark.parametrize("method", METHODS)
def test_step_many_matches_jax_on_its_draws(pair, method):
    jm, tm = pair
    n, steps = 128, 3
    cfg = dict(max_particles=n, raycast_method=method, lut_theta_bins=180, seed=7)
    jpf = JParticleFilter(jm, JMCLConfig(**cfg), beam_angles=BEAMS)
    pf = ParticleFilter(tm, MCLConfig(**cfg), beam_angles=BEAMS)
    assert pf.likelihood is None and pf.config.raycast_method == method
    if method == "lut":
        np.testing.assert_array_equal(pf.grid_map.range_lut.numpy(),
                                      np.asarray(jpf.grid_map.range_lut).reshape(-1))
        assert pf.grid_map.lut_route in ("native", "plain")
    truth = np.float32([1.1, 1.3, 0.4])
    rng = np.random.default_rng(8)
    scans = np.stack([_truth_scan(jm, truth) + rng.normal(0, 0.02, 60).astype(np.float32)
                      for _ in range(steps)])
    actions = np.float32([[0.04, 0.0, 0.02]] * steps)
    js = jpf.init_pose(truth + np.float32([0.1, -0.1, 0.05]), seed=1)
    ts = MCLState.from_numpy(np.asarray(js.particles), np.asarray(js.log_weights), seed=0,
                             device="cpu")
    u0, noise = _jax_draws(js.key, n, steps)
    js, jposes = jpf.step_many(js, actions, scans)
    ts, tposes = pf.step_many(ts, actions, scans, u0=u0, noise=noise)
    _close(tposes.numpy(), np.asarray(jposes), ts.particles.numpy(), np.asarray(js.particles),
           method)
    assert abs(pf.log_quality(ts) - float(js.log_quality)) < 1e-3


@pytest.mark.parametrize("method", ["lut", "sphere"])
def test_step_with_injection_and_profile_phases(pair, method):
    _, tm = pair
    pf = ParticleFilter(tm, MCLConfig(max_particles=64, raycast_method=method,
                                      lut_theta_bins=180), beam_angles=BEAMS)
    state = pf.init_pose(np.float32([1.1, 1.3, 0.4]), seed=2)
    scan = np.full(60, 1.5, np.float32)
    state, pose = pf.step(state, np.float32([0.02, 0.0, 0.0]), scan, inject_fraction=0.5)
    assert np.isfinite(pose.numpy()).all()
    stats = pf.profile_phases(state, np.float32([0.02, 0.0, 0.0]), scan, iters=2)
    assert stats.measurement_count == 2 and stats.sensor_model_time > 0


def test_global_localization_runs_under_every_method(pair):
    """``converge_global`` (config #4's loop) drives a filter of any
    method: the cloud from ``init_global`` reaches the scan's pose."""
    from monte_carlo_localization_tpu_torch.runtime import converge_global

    jm, tm = pair
    truth = np.float32([1.1, 1.3, 0.4])
    for method in ("lut", "sphere"):
        pf = ParticleFilter(tm, MCLConfig(max_particles=2000, raycast_method=method,
                                          lut_theta_bins=360), beam_angles=BEAMS)
        res = converge_global(pf, _truth_scan(jm, truth), truth, seed=0, chunk=5,
                              max_updates=20)
        assert res.overflow_share == () and np.isfinite(res.poses).all()
        assert res.updates is not None and res.err_m < 0.5, (method, res.updates, res.err_m)


def _member_draws(keys, n):
    u0, noise = [], []
    for key in keys:
        _, kr, km = jax.random.split(key, 3)
        u0.append(float(jax.random.uniform(kr, ())))
        noise.append(np.array(jax.random.normal(km, (n, 3), jnp.float32)))
    return np.float32(u0), np.stack(noise)


@pytest.mark.parametrize("stacked, method", [(False, "lut"), (True, "lut"), (True, "sphere")],
                         ids=["shared_lut", "stacked_lut", "stacked_sphere"])
def test_fleet_matches_jax_on_its_draws(stacked, method):
    specs = [((64, 80), (-1.0, 0.5, 0.0), 1), ((48, 96), (0.3, -0.7, 0.2), 2)]
    pairs = [_map_pair(h, w, origin, seed) for (h, w), origin, seed in specs]
    f, n, steps = 2, 96, 3
    if stacked:
        jm, tm = j_stack_maps([j for j, _ in pairs]), stack_maps([t for _, t in pairs])
        member_maps = [j for j, _ in pairs]
    else:
        jm, tm = pairs[0]
        member_maps = [jm, jm]
    cfg = dict(max_particles=n, raycast_method=method, lut_theta_bins=120)
    jff = JFleetFilter(jm, fleet_size=f, config=JMCLConfig(**cfg), beam_angles=BEAMS)
    ff = FleetFilter(tm, f, MCLConfig(**cfg), beam_angles=BEAMS)
    assert ff.likelihood is None
    if method == "lut":
        np.testing.assert_array_equal(ff.map.range_lut.numpy(),
                                      np.asarray(jff.map.range_lut).reshape(-1))
    poses0 = np.float32([[1.0, 1.2, 0.3], [1.5, 0.2, 0.1]])
    scans = np.stack([_truth_scan(m, p + np.float32([0.05, -0.05, 0.02]))
                      for m, p in zip(member_maps, poses0)])
    js = jff.init_pose(poses0, seed=1)
    ts = FleetState.from_numpy(np.asarray(js.particles), np.asarray(js.log_weights), seed=0,
                               device="cpu")
    for i in range(steps):
        actions = np.tile(np.float32([0.04, 0.0, 0.02]) * (i + 1), (f, 1))
        u0, noise = _member_draws(js.keys, n)
        js, jposes = jff.step(js, actions, scans)
        ts, tposes = ff.step(ts, actions, scans, u0=u0, noise=noise)
        _close(tposes.numpy(), np.asarray(jposes), ts.particles.numpy(),
               np.asarray(js.particles), f"{method} step {i}")


def test_fleet_map_assignment_needs_the_fused_kernel(pair):
    _, tm = pair
    with pytest.raises(ValueError, match="map_assignment requires"):
        FleetFilter(stack_maps([tm, tm]), 4, MCLConfig(max_particles=32, raycast_method="lut"),
                    map_assignment=[0, 1, 0, 1])


BAD_BEAMS = np.array([0.0, 0.0, 0.1, 0.2], np.float32)  # two beams in one bin


def test_auto_kernel_falls_back_to_lut_on_bad_geometry(pair):
    jm, tm = pair
    pf = ParticleFilter(tm, MCLConfig(max_particles=64, lut_theta_bins=180))
    assert pf._auto_raycast and pf.config.raycast_method == "lut_pallas"
    with pytest.warns(UserWarning, match="falling back to 'lut'"):
        pf.set_beam_angles(BAD_BEAMS)
    assert pf.config.raycast_method == "lut" and pf.likelihood is None
    assert pf.grid_map.lut_theta_bins == 180 and pf.grid_map.lut_row_map is None
    pose = np.float32([1.1, 1.3, 0.4])
    state, est = pf.step(pf.init_pose(pose, seed=0), np.zeros(3, np.float32),
                         _truth_scan(jm, pose, BAD_BEAMS))
    assert np.isfinite(est.numpy()).all()


def test_explicit_kernel_raises_on_bad_geometry(pair):
    _, tm = pair
    pf = ParticleFilter(tm, MCLConfig(max_particles=64, raycast_method="lut_pallas"))
    with pytest.raises(ValueError, match="two beams"):
        pf.set_beam_angles(BAD_BEAMS)


def test_auto_kernel_does_not_hide_a_failed_lut_build(pair, monkeypatch):
    """Only a beam-geometry ValueError falls back: a LUT build (the sweep
    kernel on a card) that fails raises through the auto selection."""
    _, tm = pair

    def boom(*a, **k):
        raise RuntimeError("range_lut_sweep launch failed")

    monkeypatch.setattr(GridMap, "with_kernel_lut", boom)
    pf = ParticleFilter(tm, MCLConfig(max_particles=64))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        with pytest.raises(RuntimeError, match="launch failed"):
            pf.set_beam_angles(BEAMS)


def test_methods_on_a_batched_map_equal_each_map_alone():
    pairs = [_map_pair(64, 80, (-1.0, 0.5, 0.0), 1), _map_pair(48, 96, (0.3, -0.7, 0.2), 2)]
    maps = [t for _, t in pairs]
    batched = stack_maps(maps).with_range_lut(90, use_cache=False)
    parts = np.stack([_particles(m, 50, seed=9 + i) for i, m in enumerate(maps)])
    beams = torch.from_numpy(BEAMS)
    for i, m in enumerate(maps):
        single = tray.lut_expected_px(stack_maps([m]).with_range_lut(90, use_cache=False),
                                      torch.from_numpy(parts[i:i + 1]), beams)[0]
        got = tray.lut_expected_px(batched, torch.from_numpy(parts), beams)[i]
        inside = ((parts[i, :, 0] - m.origin_x) / RES < m.width) & (
            (parts[i, :, 1] - m.origin_y) / RES < m.height)
        np.testing.assert_array_equal(got.numpy()[inside], single.numpy()[inside])
    q = torch.from_numpy(parts.copy())
    for fn in (tray.cast_rays_dda, tray.cast_rays_sphere):
        got = fn(batched, q)
        for i, m in enumerate(maps):
            own = fn(m, q[i])
            inside = ((q[i, :, 0] - m.origin_x) / RES < m.width) & (
                (q[i, :, 1] - m.origin_y) / RES < m.height)
            assert torch.equal(got[i][inside], own[inside])
    with pytest.raises(ValueError, match="map axis first"):
        tray.cast_rays_dda(batched, q[0])
    assert math.isfinite(float(got.sum()))
