"""Checkpoints: a file written by either package loads in the other (the
same npz keys and versions), and the port resumes its own files bit for
bit. The random streams of the two packages cannot match: a JAX file
seeds the port's generator from its ``key_data``, and a port file hands
JAX its generator's seed as a key."""

import numpy as np
import pytest
import torch

import jax

from monte_carlo_localization_tpu.parallel.fleet import FleetState as JFleetState
from monte_carlo_localization_tpu.runtime import OdometryTracker as JTracker
from monte_carlo_localization_tpu.runtime import load_fleet_state as j_load_fleet_state
from monte_carlo_localization_tpu.runtime import load_state as j_load_state
from monte_carlo_localization_tpu.runtime import save_fleet_state as j_save_fleet_state
from monte_carlo_localization_tpu.runtime import save_state as j_save_state
from monte_carlo_localization_tpu.filter import MCLState as JMCLState
from monte_carlo_localization_tpu_torch import MCLConfig, ParticleFilter
from monte_carlo_localization_tpu_torch.mapping import map_from_occupancy
from monte_carlo_localization_tpu_torch.parallel.fleet import FleetFilter, FleetState
from monte_carlo_localization_tpu_torch.runtime import (
    OdometryTracker,
    load_fleet_state,
    load_state,
    save_fleet_state,
    save_state,
)


@pytest.fixture(autouse=True)
def _one_thread_private_lut_cache(monkeypatch, tmp_path):
    torch.set_num_threads(1)
    monkeypatch.setenv("MCL_LUT_CACHE", str(tmp_path / "lut_cache"))


@pytest.fixture(scope="module")
def pf():
    occ = np.zeros((60, 80), np.int8)
    occ[:2, :] = occ[-2:, :] = occ[:, :2] = occ[:, -2:] = 100
    occ[20:30, 35:45] = 100
    gm = map_from_occupancy(occ, resolution=0.05, device="cpu")
    beams = np.linspace(-2.0, 2.0, 30).astype(np.float32)
    return ParticleFilter(gm, MCLConfig(max_particles=96), beam_angles=beams)


def _tracker(cls):
    t = cls()
    t.on_odometry(0.5, 0.2, 0.1, 1.2, -0.3, stamp=4.5)
    t.anchor(np.array([1.0, 1.2, 0.4]), avg_mcl_ms=3.0)
    t.on_odometry(0.6, 0.25, 0.12, 1.1, -0.2, stamp=4.6)
    return t


def _assert_trackers_equal(a, b):
    sa, sb = a.snapshot(), b.snapshot()
    for u, v in zip((sa.pose, sa.last_odom_pose, sa.velocity, sa.angular_velocity, sa.last_stamp),
                    (sb.pose, sb.last_odom_pose, sb.velocity, sb.angular_velocity, sb.last_stamp)):
        np.testing.assert_array_equal(u, v)
    assert (a.active, a.pose_initialized_from_seed, a._reference_odom_pending) == \
        (b.active, b.pose_initialized_from_seed, b._reference_odom_pending)
    np.testing.assert_array_equal(a._reference_pose, b._reference_pose)
    np.testing.assert_array_equal(a._reference_odom, b._reference_odom)


def test_port_resumes_its_own_checkpoint_bitwise(pf, tmp_path):
    scan = np.full(30, 1.5, np.float32)
    action = np.float32([0.03, 0.0, 0.01])
    s, _ = pf.step(pf.init_pose([2.0, 1.5, 0.3], seed=5), action, scan)
    save_state(tmp_path / "ck.npz", s, iters=1, inferred_pose=np.zeros(3),
               tracker=_tracker(OdometryTracker), extra={"note": 3})
    s_cont, p_cont = pf.step(s, action, scan)
    s_cont, p_cont = pf.step(s_cont, action, scan)
    tracker = OdometryTracker()
    r, meta = load_state(tmp_path / "ck.npz", tracker=tracker, device="cpu")
    assert meta["iters"] == 1 and int(meta["extra"]["note"]) == 3
    _assert_trackers_equal(tracker, _tracker(OdometryTracker))
    r, _ = pf.step(r, action, scan)
    r, p_res = pf.step(r, action, scan)
    assert torch.equal(p_res, p_cont)
    assert torch.equal(r.particles, s_cont.particles)
    assert torch.equal(r.log_weights, s_cont.log_weights)
    assert torch.equal(r.log_quality, s_cont.log_quality)


def test_jax_reads_the_port_checkpoint(pf, tmp_path):
    s = pf.init_global(seed=123)
    save_state(tmp_path / "port.npz", s, iters=7, inferred_pose=np.ones(3),
               tracker=_tracker(OdometryTracker))
    tracker = JTracker()
    js, meta = j_load_state(tmp_path / "port.npz", tracker=tracker)
    assert meta["iters"] == 7
    np.testing.assert_array_equal(meta["inferred_pose"], np.ones(3))
    np.testing.assert_array_equal(np.asarray(js.particles), s.particles.numpy())
    np.testing.assert_array_equal(np.asarray(js.log_weights), s.log_weights.numpy())
    np.testing.assert_array_equal(np.asarray(jax.random.key_data(js.key)),
                                  np.asarray(jax.random.key_data(jax.random.key(123))))
    _assert_trackers_equal(tracker, _tracker(JTracker))


def test_port_reads_the_jax_checkpoint(tmp_path):
    rng = np.random.default_rng(0)
    key = jax.random.split(jax.random.key(9))[1]
    js = JMCLState(particles=jax.numpy.asarray(rng.normal(size=(50, 3)), jax.numpy.float32),
                   log_weights=jax.numpy.asarray(rng.normal(size=50), jax.numpy.float32),
                   key=key, log_quality=jax.numpy.float32(-3.5))
    j_save_state(tmp_path / "jax.npz", js, iters=4, tracker=_tracker(JTracker))
    tracker = OdometryTracker()
    s, meta = load_state(tmp_path / "jax.npz", tracker=tracker, device="cpu")
    assert meta["iters"] == 4
    np.testing.assert_array_equal(s.particles.numpy(), np.asarray(js.particles))
    np.testing.assert_array_equal(s.log_weights.numpy(), np.asarray(js.log_weights))
    assert float(s.log_quality) == -3.5
    hi, lo = (int(v) for v in np.asarray(jax.random.key_data(key)))
    assert s.generator.initial_seed() == (hi << 32) | lo
    _assert_trackers_equal(tracker, _tracker(JTracker))
    placed, _ = load_state(tmp_path / "jax.npz", place=lambda st: st.particles, device="cpu")
    assert torch.equal(placed, s.particles)  # ``place`` gets the restored state


def test_fleet_checkpoints_cross_both_ways(pf, tmp_path):
    f, n = 3, 40
    ff = FleetFilter(pf.grid_map, f, MCLConfig(max_particles=n))
    s = ff.init_pose(np.tile([2.0, 1.5, 0.3], (f, 1)), seed=4)
    save_fleet_state(tmp_path / "port.npz", s, iters=2, poses=np.zeros((f, 3)))
    js, meta = j_load_fleet_state(tmp_path / "port.npz")
    assert meta["iters"] == 2 and meta["poses"].shape == (f, 3)
    np.testing.assert_array_equal(np.asarray(js.particles), s.particles.numpy())
    assert js.keys.shape == (f,)

    back, _ = load_fleet_state(tmp_path / "port.npz", fleet=ff)
    assert torch.equal(back.particles, s.particles)
    assert torch.equal(back.generator.get_state(), s.generator.get_state())

    j_save_fleet_state(tmp_path / "jax.npz", JFleetState(
        particles=js.particles, log_weights=js.log_weights,
        keys=jax.random.split(jax.random.key(2), f)), iters=5)
    r, meta = load_fleet_state(tmp_path / "jax.npz", fleet=ff)
    assert meta["iters"] == 5 and isinstance(r, FleetState)
    np.testing.assert_array_equal(r.log_weights.numpy(), s.log_weights.numpy())
    with pytest.raises(ValueError, match="members"):
        load_fleet_state(tmp_path / "jax.npz", fleet=FleetFilter(pf.grid_map, 2,
                                                                MCLConfig(max_particles=n)))
    save_state(tmp_path / "single.npz", pf.init_global(seed=0))
    with pytest.raises(ValueError, match="not a fleet checkpoint"):
        load_fleet_state(tmp_path / "single.npz", device="cpu")
