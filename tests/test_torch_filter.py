"""The port's filter slice against the JAX filter, and its entry points.

The slice test runs chained corrections of both ``ParticleFilter``s
(JAX: ``lut_pallas`` in interpret mode) on one LUT buffer and one particle
cloud, carried across with ``GridMap.from_numpy`` / ``MCLState.from_numpy``.
The port is fed the JAX filter's own random draws, rebuilt from its key
chain as ``filter/mega.py:146-156`` does. Gates: poses within 1e-3, and at
least 99% of particle rows equal within 1e-4 (the f32 weight CDFs are
summed in different orders, so a knife-edge resample slot may flip).
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from monte_carlo_localization_tpu.config import MCLConfig as JMCLConfig
from monte_carlo_localization_tpu.config import load_config as j_load_config
from monte_carlo_localization_tpu.filter import ParticleFilter as JParticleFilter
from monte_carlo_localization_tpu.mapping import random_obstacle_world
from monte_carlo_localization_tpu_torch import (
    GridMap,
    MCLConfig,
    MCLState,
    ParticleFilter,
    load_config,
    load_map,
)
from monte_carlo_localization_tpu_torch.mapping import map_from_occupancy
from monte_carlo_localization_tpu_torch.runtime import replay_chained, trace_actions

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _one_thread_private_lut_cache(monkeypatch, tmp_path):
    torch.set_num_threads(1)
    monkeypatch.setenv("MCL_LUT_CACHE", str(tmp_path / "lut_cache"))


@pytest.fixture(scope="module")
def small_map():
    occ = np.asarray(
        random_obstacle_world(height=72, width=96, num_obstacles=4, seed=5).occupancy
    )
    return map_from_occupancy(occ, resolution=0.05, origin=(-1.0, 0.5, 0.0), device="cpu")


def _carry_map(jm) -> GridMap:
    return GridMap.from_numpy(
        occupancy=np.asarray(jm.occupancy), free_cells=np.asarray(jm.free_cells),
        num_free=int(jm.num_free), clearance=np.asarray(jm.clearance),
        origin_x=float(jm.origin_x), origin_y=float(jm.origin_y),
        resolution=jm.resolution, max_range_px=jm.max_range_px,
        max_range_meters=jm.max_range_meters,
        range_lut=np.asarray(jm.range_lut),
        lut_row_map=None if jm.lut_row_map is None else np.asarray(jm.lut_row_map),
        lut_theta_bins=jm.lut_theta_bins, lut_row_stride=jm.lut_row_stride,
        device="cpu",
    )


def test_slice_matches_jax_filter_on_its_draws(clutter_map, beams60, make_scan):
    _chained_parity(clutter_map, beams60, make_scan)


@pytest.mark.parametrize(
    "opts",
    [dict(pallas_subbin=True), dict(pallas_dedup_slots=4),
     dict(pallas_dedup_slots=4, pallas_dedup_matmul=True)],
    ids=["subbin_K3", "dedup_K4", "dedup_matmul_K5"],
)
def test_slice_matches_jax_filter_under_kernel_options(clutter_map, beams60, make_scan, opts):
    pf = _chained_parity(clutter_map, beams60, make_scan, **opts)
    assert pf.likelihood.subbin == opts.get("pallas_subbin", False)
    assert pf.likelihood.dedup_slots == opts.get("pallas_dedup_slots", 0)
    assert pf.likelihood.dedup_matmul == opts.get("pallas_dedup_matmul", False)


def _chained_parity(clutter_map, beams60, make_scan, **opts):
    """3 chained corrections of both filters on one LUT and cloud, the
    port fed the JAX filter's draws; returns the port's filter."""
    n, steps = 128, 3
    cfg_kw = dict(max_particles=n, raycast_method="lut_pallas", seed=7, **opts)
    jpf = JParticleFilter(clutter_map, JMCLConfig(**cfg_kw))
    jpf.set_beam_angles(beams60)
    pf = ParticleFilter(_carry_map(jpf.grid_map), MCLConfig(**cfg_kw))
    pf.set_beam_angles(beams60)
    np.testing.assert_array_equal(
        pf.grid_map.range_lut.numpy(), np.asarray(jpf.grid_map.range_lut).reshape(-1)
    )

    truth = np.array([10.0, 10.0, 0.5], np.float32)
    rng = np.random.default_rng(0)
    js = jpf.init_pose(truth + np.float32([0.1, -0.1, 0.05]), seed=1)
    ts = MCLState.from_numpy(np.asarray(js.particles), np.asarray(js.log_weights), seed=0,
                             device="cpu")
    for i in range(steps):
        action = np.float32([0.05, 0.0, 0.02]) * (i + 1)
        scan = make_scan(clutter_map, truth, beams60) + rng.normal(0, 0.02, 60).astype(np.float32)
        _, k_res, k_mot = jax.random.split(js.key, 3)
        u0 = float(jax.random.uniform(k_res, ()))
        noise = np.array(jax.random.normal(k_mot, (n, 3), jnp.float32))
        js, jpose = jpf.step(js, action, scan)
        ts, tpose = pf.step(ts, action, scan, u0=u0, noise=noise)
        np.testing.assert_allclose(tpose.numpy(), np.asarray(jpose), rtol=0, atol=1e-3)
        parts, _ = ts.to_numpy()
        row_ok = np.all(np.abs(parts - np.asarray(js.particles)) <= 1e-4, axis=1)
        assert row_ok.mean() >= 0.99, f"step {i}: {row_ok.mean():.3f} rows equal"
        assert abs(pf.log_quality(ts) - float(js.log_quality)) < 1e-3
    # CPU tensors: the plain versions
    assert pf.likelihood.launch_count == pf.likelihood.dedup_launch_count == 0
    return pf


def test_step_many_equals_chained_steps(small_map, beams60):
    pf = ParticleFilter(small_map, MCLConfig(max_particles=64), beam_angles=beams60)
    truth = np.array([1.5, 2.0, 0.5], np.float32)
    scans = np.random.default_rng(1).uniform(0.2, 12.0, (4, 60)).astype(np.float32)
    actions = np.tile(np.float32([0.04, 0.0, 0.01]), (4, 1))
    a, poses = pf.step_many(pf.init_pose(truth, seed=3), actions, scans)
    b = pf.init_pose(truth, seed=3)
    for i in range(4):
        b, pose = pf.step(b, actions[i], scans[i])
        np.testing.assert_array_equal(pose.numpy(), poses[i].numpy())
    np.testing.assert_array_equal(a.particles.numpy(), b.particles.numpy())
    with pytest.raises(ValueError, match="noise shape"):
        pf.step_many(b, actions, scans, noise=np.zeros((4, 3, 3), np.float32))


def test_config_file_loads_like_jax():
    path = REPO / "config" / "mcl_config.yaml"
    assert load_config(path).__dict__ == j_load_config(path).__dict__


def test_kernel_options_build_and_mega_refuses_them(small_map, beams60, clutter_map):
    for opts, want in (
        (dict(pallas_subbin=True), (True, 0, False)),
        (dict(pallas_dedup_slots=4), (False, 4, False)),
        (dict(pallas_dedup_slots=4, pallas_dedup_matmul=True), (False, 4, True)),
        (dict(pallas_dedup_matmul=True), (False, 0, False)),  # ignored without slots
        (dict(pallas_dedup_slots=-1), (False, 0, False)),  # auto: off
    ):
        q = ParticleFilter(small_map, MCLConfig(max_particles=64, **opts),
                           beam_angles=beams60).likelihood
        assert (q.subbin, q.dedup_slots, q.dedup_matmul) == want, opts
    for opts in (dict(pallas_subbin=True), dict(pallas_dedup_slots=4)):
        with pytest.raises(ValueError, match="pallas_mega"):
            ParticleFilter(small_map, MCLConfig(max_particles=64, pallas_mega=True, **opts),
                           beam_angles=beams60)
        jpf = JParticleFilter(clutter_map, JMCLConfig(
            max_particles=64, raycast_method="lut_pallas", pallas_mega=True, **opts))
        with pytest.raises(ValueError, match="pallas_mega"):
            jpf.set_beam_angles(beams60)
            jpf.step_many(jpf.init_global(seed=0), np.zeros((2, 3), np.float32),
                          np.ones((2, 60), np.float32))


def test_init_global_samples_free_space(small_map):
    gm = small_map
    pf = ParticleFilter(gm, MCLConfig(max_particles=500))
    s = pf.init_global(seed=2)
    col = ((s.particles[:, 0] - gm.origin_x) / gm.resolution).round().long()
    row = ((s.particles[:, 1] - gm.origin_y) / gm.resolution).round().long()
    assert gm.permissible[row, col].all()
    assert (s.particles[:, 2] >= 0).all() and (s.particles[:, 2] < 2 * np.pi).all()
    again = pf.init_global(seed=2)
    np.testing.assert_array_equal(s.particles.numpy(), again.particles.numpy())


def test_replay_chained_tracks_config1_trace(tmp_path):
    full = np.load(REPO / "traces" / "config1_map_1753950572.npz")
    short = {k: full[k] for k in full.files}
    keep = short["scan_t"] <= short["scan_t"][47]
    short["scan_t"], short["scan_ranges"] = short["scan_t"][keep], short["scan_ranges"][keep]
    path = tmp_path / "short.npz"
    np.savez(path, **short)
    pf = ParticleFilter(load_map(REPO / "maps" / "map_1753950572.yaml", device="cpu"),
                        MCLConfig(max_particles=300, angle_step=18))
    res = replay_chained(pf, path, chunk=16)
    assert res.corrections == 48 and res.poses.shape == (48, 3)
    assert res.rmse_xy < 0.15, res.rmse_xy
    acts = trace_actions(short["odom_t"], short["odom_twist"], short["scan_t"])
    assert acts.shape == (48, 3) and np.all(acts[:, 1] == 0)


def test_package_imports_without_jax():
    code = (
        "import sys, monte_carlo_localization_tpu_torch as m\n"
        "import monte_carlo_localization_tpu_torch.runtime, "
        "monte_carlo_localization_tpu_torch.cli, "
        "monte_carlo_localization_tpu_torch.runtime.node, "
        "monte_carlo_localization_tpu_torch.runtime.loop, "
        "monte_carlo_localization_tpu_torch.runtime.checkpoint, "
        "monte_carlo_localization_tpu_torch.runtime.trace, "
        "monte_carlo_localization_tpu_torch.runtime.sinks, "
        "monte_carlo_localization_tpu_torch.runtime.tracker, "
        "monte_carlo_localization_tpu_torch.utils.validation, "
        "monte_carlo_localization_tpu_torch.ops._cuda_build, "
        "monte_carlo_localization_tpu_torch.ops.mega_step, "
        "monte_carlo_localization_tpu_torch.filter.mega, "
        "monte_carlo_localization_tpu_torch.parallel, "
        "monte_carlo_localization_tpu_torch.ops.probes, "
        "monte_carlo_localization_tpu_torch.tools.mega_probe, "
        "monte_carlo_localization_tpu_torch.runtime.fleet_node, "
        "monte_carlo_localization_tpu_torch.runtime.viz, "
        "monte_carlo_localization_tpu_torch.runtime.webviz, "
        "monte_carlo_localization_tpu_torch.runtime.rosbag, "
        "monte_carlo_localization_tpu_torch.runtime.ros2_bridge, "
        "monte_carlo_localization_tpu_torch.mapping.synthetic, "
        "monte_carlo_localization_tpu_torch.parallel.sharded, "
        "monte_carlo_localization_tpu_torch.parallel.multihost, "
        "monte_carlo_localization_tpu_torch.parallel.collectives, "
        "monte_carlo_localization_tpu_torch.baseline, "
        "monte_carlo_localization_tpu_torch.tools.dryrun_multichip, "
        "monte_carlo_localization_tpu_torch.bench, "
        "monte_carlo_localization_tpu_torch.tools.mega_ab, "
        "monte_carlo_localization_tpu_torch.tools.perf_ablate, "
        "monte_carlo_localization_tpu_torch.examples.localize_on_map, "
        "monte_carlo_localization_tpu_torch.examples.fleet_racing, "
        "monte_carlo_localization_tpu_torch.examples.fleet_live_loop\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith('jax.')"
        " or k.startswith('monte_carlo_localization_tpu.')"
        " or k == 'monte_carlo_localization_tpu')\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO, timeout=120)
