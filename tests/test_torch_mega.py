"""The port's mega step (``ops/mega_step.py``, ``filter/mega.py``) against
the JAX package's ``ops/pallas_mega.py`` and ``filter/mega.py``.

The plain version ``mega_step_reference`` and the port's ``pallas_mega``
filter run on the CPU; the JAX side runs ``build_mega_step_fn`` in
interpret mode, as ``tests/test_mega.py`` does. Inputs come from numpy
seeds and one dense u8 LUT buffer serves both packages.

Tolerances: proposal rows within 1e-5 (1e-4 after three chained steps)
on at least 99% of rows, because the float32 weight CDFs are summed in
different orders (the TPU with triangular matmuls, the port in double)
and a knife-edge slot may pick the neighbouring ancestor; log weights
within 2e-3 on those rows (the JAX tests' own bound for the LUT kernel);
moment sums within relative 1e-4 (float32 sums on the TPU, double here).
"""

import math
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from monte_carlo_localization_tpu.config import MCLConfig as JMCLConfig
from monte_carlo_localization_tpu.filter import ParticleFilter as JParticleFilter
from monte_carlo_localization_tpu.mapping import random_obstacle_world
from monte_carlo_localization_tpu.ops.pallas_lut import (
    required_row_stride,
    suggest_theta_bins,
)
from monte_carlo_localization_tpu.ops.pallas_mega import build_mega_step_fn
from monte_carlo_localization_tpu_torch import (
    GridMap,
    MCLConfig,
    MCLState,
    ParticleFilter,
    load_map,
)
from monte_carlo_localization_tpu_torch.mapping import map_from_occupancy
from monte_carlo_localization_tpu_torch.models.motion import reconstruct_velocity
from monte_carlo_localization_tpu_torch.ops.mega_step import (
    MegaStep,
    mega_step_reference,
    scaled_cdf,
    systematic_ancestors,
)

REPO = Path(__file__).resolve().parents[1]
N = 256
BLOCK = 64  # the JAX kernel's particles per grid step; divides N
DISP = (0.05, 0.025, 0.25)
BEAMS = {
    "r60_K2": np.linspace(-2.35, 2.35, 60).astype(np.float32),
    "r200_K1": np.linspace(-2.35, 2.35, 200).astype(np.float32),
}
SCALARS = {  # [ds, dtheta, straight, u0, 0, 0, 0, 0]
    "straight": [0.05, 0.0, 1.0, 0.37],
    "arc": [0.04, 0.03, 0.0, 0.81],
}
MODEL = dict(z_hit=0.8, z_short=0.01, z_max=0.07, z_rand=0.12, sigma_hit=8.0,
             inv_squash=1.0 / 2.2)


@pytest.fixture(autouse=True)
def _one_thread_private_lut_cache(monkeypatch, tmp_path):
    torch.set_num_threads(1)
    monkeypatch.setenv("MCL_LUT_CACHE", str(tmp_path / "lut_cache"))


@pytest.fixture(scope="module")
def small_jax_map():
    return random_obstacle_world(height=72, width=96, num_obstacles=4, seed=5)


@pytest.fixture(scope="module")
def cases(small_jax_map):
    """Per beam set: the JAX mega call (interpret mode), its obs layout,
    the port's MegaStep and the shared dense u8 LUT."""
    out = {}
    jm = small_jax_map
    for name, beams in BEAMS.items():
        t = suggest_theta_bins(beams)
        stride = required_row_stride(t, beams, itemsize=1)
        jml = jm.with_range_lut(t, use_cache=False, row_stride=stride)
        lut = np.array(jml.range_lut).reshape(-1)
        assert lut.dtype == np.uint8
        geo = dict(height=jm.height, width=jm.width, resolution=jm.resolution,
                   origin_x=float(jm.origin_x), origin_y=float(jm.origin_y),
                   max_range_px=jm.max_range_px, row_stride=stride)
        mega, prep_obs, info = build_mega_step_fn(
            t, beams, N, **geo, **MODEL, motion_dispersion=DISP, block=BLOCK,
            interpret=True, lut_dtype=np.uint8,
        )
        assert info["compact_beams"] == (name == "r60_K2")
        step = MegaStep(t, beams, **geo, **MODEL, motion_dispersion=DISP,
                        lut_dtype=np.uint8, device="cpu")
        out[name] = dict(
            jax=jax.jit(mega), prep_obs=prep_obs, step=step,
            lut=lut, lut3=jnp.asarray(lut.reshape(-1, 4, 128)), map=jm,
        )
    return out


def _inputs(rng, jm, num_beams, noise_scale=1.0):
    """Particles over the map with a few off it, log weights ~ N(0, 3),
    N(0, 1) noise and a scan in pixels."""
    w, h, res = jm.width * jm.resolution, jm.height * jm.resolution, jm.resolution
    ox, oy = float(jm.origin_x), float(jm.origin_y)
    parts = np.stack([rng.uniform(ox + res, ox + w - res, N),
                      rng.uniform(oy + res, oy + h - res, N),
                      rng.uniform(-math.pi, math.pi, N)], 1).astype(np.float32)
    parts[:6, 0] = ox - 2.0  # off the map
    logw = rng.normal(0.0, 3.0, N).astype(np.float32)
    logw[:6] = 6.0  # resampled, so the proposal holds off-map rows
    noise = (rng.normal(size=(N, 3)) * noise_scale).astype(np.float32)
    obs = np.floor(rng.uniform(0, jm.max_range_px, num_beams)).astype(np.float32)
    return parts, logw, noise, obs


def _run_both(case, parts, logw, noise, obs, scalars):
    sc = np.zeros(8, np.float32)
    sc[:4] = scalars
    obs_lanes = case["prep_obs"](jnp.asarray(obs)[None])[0]
    jprop, jlw, jsums = case["jax"](
        case["lut3"], jnp.asarray(parts), jnp.asarray(logw.reshape(-1, 128)),
        jnp.asarray(noise), obs_lanes, jnp.asarray(sc),
    )
    t = torch.from_numpy
    prop, lw, sums = mega_step_reference(
        case["step"], t(case["lut"]), t(parts), t(logw), t(noise), t(obs), t(sc)
    )
    want = (np.asarray(jprop)[:N], np.asarray(jlw).reshape(-1)[:N], np.asarray(jsums)[0])
    return (prop.numpy(), lw.numpy(), sums.numpy()), want


@pytest.mark.parametrize("motion", list(SCALARS))
@pytest.mark.parametrize("beams", list(BEAMS))
def test_reference_matches_jax_mega_kernel(cases, beams, motion):
    case = cases[beams]
    rng = np.random.default_rng(len(beams) + len(motion))
    parts, logw, noise, obs = _inputs(rng, case["map"], len(BEAMS[beams]))
    (prop, lw, sums), (jprop, jlw, jsums) = _run_both(case, parts, logw, noise, obs, SCALARS[motion])
    rows = np.all(np.abs(prop - jprop) <= 1e-5, axis=1)
    assert rows.mean() >= 0.99, f"{rows.mean():.4f} of rows equal"
    np.testing.assert_allclose(lw[rows], jlw[rows], rtol=0, atol=2e-3)
    np.testing.assert_allclose(sums[:5], jsums[:5], rtol=1e-4)
    assert abs(sums[5] - jsums[5]) <= 2e-3 and (sums[6:] == 0).all()
    # the case reaches the off-map rule and resamples non-trivially
    assert (lw + sums[5] == -1e4).any()
    u0 = torch.tensor(SCALARS[motion][3])
    idx, _ = systematic_ancestors(scaled_cdf(torch.from_numpy(logw), u0), u0)
    assert len(np.unique(idx.numpy())) < N / 2


@pytest.mark.parametrize("u0", [0.0, 1.5], ids=["first_slot", "last_slot"])
def test_uncovered_slot_gives_zero_row(cases, u0):
    """u0 = 0 leaves slot 0 uncovered (g_{-1} = -0 is not < 0); u0 = 1.5
    puts the last g below N - 1. Both packages give that row (0, 0, 0)."""
    case = cases["r60_K2"]
    rng = np.random.default_rng(11)
    parts, logw, _, obs = _inputs(rng, case["map"], 60)
    noise = np.zeros((N, 3), np.float32)
    (prop, _, _), (jprop, _, _) = _run_both(case, parts, logw, noise, obs, [0.0, 0.0, 1.0, u0])
    slot = 0 if u0 == 0.0 else N - 1
    np.testing.assert_array_equal(prop[slot], [0.0, 0.0, 0.0])
    np.testing.assert_array_equal(jprop[slot], [0.0, 0.0, 0.0])
    g = scaled_cdf(torch.from_numpy(logw), torch.tensor(u0))
    _, valid = systematic_ancestors(g, torch.tensor(u0))
    assert not bool(valid[slot]) and int(valid.sum()) == N - 1


def _carry_map(jm) -> GridMap:
    return GridMap.from_numpy(
        occupancy=np.asarray(jm.occupancy), free_cells=np.asarray(jm.free_cells),
        num_free=int(jm.num_free), clearance=np.asarray(jm.clearance),
        origin_x=float(jm.origin_x), origin_y=float(jm.origin_y),
        resolution=jm.resolution, max_range_px=jm.max_range_px,
        max_range_meters=jm.max_range_meters, range_lut=np.asarray(jm.range_lut),
        lut_theta_bins=jm.lut_theta_bins, lut_row_stride=jm.lut_row_stride,
        device="cpu",
    )


def test_mega_filter_matches_jax_mega_filter(clutter_map, beams60, make_scan):
    n, steps = 128, 3
    cfg_kw = dict(max_particles=n, raycast_method="lut_pallas", seed=7, pallas_mega=True)
    jpf = JParticleFilter(clutter_map, JMCLConfig(**cfg_kw))
    jpf.set_beam_angles(beams60)
    pf = ParticleFilter(_carry_map(jpf.grid_map), MCLConfig(**cfg_kw))
    pf.set_beam_angles(beams60)
    assert pf.mega is not None

    truth = np.array([10.0, 10.0, 0.5], np.float32)
    rng = np.random.default_rng(0)
    actions = np.stack([np.float32([0.05, 0.0, 0.02]) * (i + 1) for i in range(steps)])
    scans = np.stack([make_scan(clutter_map, truth, beams60)
                      + rng.normal(0, 0.02, 60).astype(np.float32) for _ in range(steps)])
    js = jpf.init_pose(truth + np.float32([0.1, -0.1, 0.05]), seed=1)
    # the JAX chain's draws, rebuilt from its key chain (filter/mega.py:146-156)
    key, u0, noise = js.key, [], []
    for _ in range(steps):
        key, k_res, k_mot = jax.random.split(key, 3)
        u0.append(float(jax.random.uniform(k_res, ())))
        noise.append(np.array(jax.random.normal(k_mot, (n, 3), jnp.float32)))
    ts = MCLState.from_numpy(np.asarray(js.particles), np.asarray(js.log_weights),
                             seed=0, device="cpu")
    js, jposes = jpf.step_many(js, actions, scans)
    ts, tposes = pf.step_many(ts, actions, scans, u0=np.float32(u0), noise=np.stack(noise))
    np.testing.assert_allclose(tposes.numpy(), np.asarray(jposes), rtol=0, atol=1e-3)
    parts, _ = ts.to_numpy()
    rows = np.all(np.abs(parts - np.asarray(js.particles)) <= 1e-4, axis=1)
    assert rows.mean() >= 0.99, f"{rows.mean():.3f} rows equal"
    assert abs(pf.log_quality(ts) - float(js.log_quality)) < 1e-2
    assert pf.likelihood.launch_count == 0 and pf.mega.mega.launch_count == 0


@pytest.fixture(scope="module")
def small_map(small_jax_map):
    return map_from_occupancy(np.asarray(small_jax_map.occupancy), resolution=0.05,
                              origin=(-1.0, 0.5, 0.0), device="cpu")


def test_mega_matches_classic_step_without_noise(small_map, beams60):
    """One seed, zero motion noise, uniform weights: the resample is the
    identity for both, so the proposals agree (theta to 1 ulp: the
    classic wrap goes through atan2, the mega step's through floor)."""
    zero = dict(motion_dispersion_x=0.0, motion_dispersion_y=0.0, motion_dispersion_theta=0.0)
    pf_m = ParticleFilter(small_map, MCLConfig(max_particles=96, pallas_mega=True, **zero),
                          beam_angles=beams60)
    pf_c = ParticleFilter(small_map, MCLConfig(max_particles=96, **zero), beam_angles=beams60)
    pose = np.array([1.4, 1.9, 0.4], np.float32)
    scan = np.random.default_rng(3).uniform(0.3, 3.0, 60).astype(np.float32)
    a = np.float32([[0.05, 0.0, 0.02]])
    s_m, p_m = pf_m.step_many(pf_m.init_pose(pose, seed=3), a, scan[None])
    s_c, p_c = pf_c.step_many(pf_c.init_pose(pose, seed=3), a, scan[None])
    pm, pc = s_m.particles.numpy(), s_c.particles.numpy()
    np.testing.assert_array_equal(pm[:, :2], pc[:, :2])
    np.testing.assert_allclose(pm[:, 2], pc[:, 2], rtol=0, atol=1e-6)
    np.testing.assert_allclose(s_m.log_weights.numpy(), s_c.log_weights.numpy(), rtol=0, atol=1e-3)
    np.testing.assert_allclose(p_m.numpy(), p_c.numpy(), rtol=0, atol=1e-4)
    assert abs(pf_m.log_quality(s_m) - pf_c.log_quality(s_c)) < 1e-2


def test_compact_map_rejected(small_map, beams60, monkeypatch):
    monkeypatch.setenv("MCL_LUT_DENSE_MAX", "1")
    with pytest.raises(ValueError, match="dense"):
        ParticleFilter(small_map, MCLConfig(max_particles=32, pallas_mega=True),
                       beam_angles=beams60)


def test_off_map_particles_get_floor_weight(small_map, beams60):
    pf = ParticleFilter(small_map, MCLConfig(max_particles=64, pallas_mega=True),
                        beam_angles=beams60)
    s = pf.init_pose(np.array([1.4, 1.9, 0.4], np.float32), seed=1)
    parts = s.particles.clone()
    parts[:8, 0] = -50.0
    step = pf.mega.mega
    obs = torch.full((60,), 40.0)
    scalars = torch.tensor([0.0, 0.0, 1.0, 0.5, 0, 0, 0, 0])
    out_p, out_w, sums = torch.empty(64, 3), torch.empty(64), torch.empty(8)
    step(pf.grid_map.range_lut, parts, s.log_weights, torch.zeros(64, 3), obs, scalars,
         out_p, out_w, sums)
    off = out_p[:, 0] < -10.0
    assert int(off.sum()) == 8  # uniform weights: the identity resample
    np.testing.assert_allclose((out_w[off] + sums[5]).numpy(), -1e4, rtol=0, atol=1e-3)
    assert bool((out_w[~off] + sums[5] > -1e4 + 1.0).all())
    assert float(out_w.max()) == 0.0 and step.launch_count == 0


def test_reconstruct_velocity_batched_equals_single():
    acts = torch.tensor([[0.05, 0.0, 0.01], [0.3, 0.0, -0.2], [0.05, 0.0, 0.0],
                         [0.0, 0.0, 0.0], [0.0005, 0.0, 1e-7]], dtype=torch.float32)
    batched = reconstruct_velocity(acts)
    for i in range(acts.shape[0]):
        for got, want in zip(batched, reconstruct_velocity(acts[i])):
            assert torch.equal(got[i], want)


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_map(REPO / "maps" / "map_1753950572.yaml")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MCLState.from_numpy(np.zeros((4, 3), np.float32), np.zeros(4, np.float32), seed=0)
