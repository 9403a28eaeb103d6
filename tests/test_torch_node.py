"""The port's ``MCLNode`` and Augmented-MCL injection against the JAX
package's, on the JAX filter's own random draws.

One JAX ``ParticleFilter`` (``lut_pallas``, interpret mode) serves every
JAX node here, so its step compiles once for the module. The port's node
takes a draw source that replays the JAX key chain (``JaxDraws``): the
clouds of ``init_global``/``init_pose`` with the node's seeds, and each
step's resample offset, motion noise and injection draws, split from the
state key as ``filter/core.py`` ``mcl_step`` splits it. The trace is a
kidnap: its second half carries the scans of another drive, so the
monitor fires in ``reinit`` mode and injects in ``inject`` mode. Gates:
poses and tracked poses within 1e-3 at every correction, and the same
``inject_steps``/``auto_reinits``.
"""

import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from monte_carlo_localization_tpu.config import MCLConfig as JMCLConfig
from monte_carlo_localization_tpu.filter import ParticleFilter as JParticleFilter
from monte_carlo_localization_tpu.filter.init import initialize_global as j_initialize_global
from monte_carlo_localization_tpu.mapping import random_obstacle_world
from monte_carlo_localization_tpu.runtime import MCLNode as JMCLNode
from monte_carlo_localization_tpu.runtime import Trace as JTrace
from monte_carlo_localization_tpu.runtime import synthesize_trace as j_synthesize_trace
from monte_carlo_localization_tpu_torch import GridMap, MCLConfig, MCLState, ParticleFilter
from monte_carlo_localization_tpu_torch.runtime import CallbackSink, LiveRunner, MCLNode, Trace

N = 128
BASE = dict(max_particles=N, raycast_method="lut_pallas", angle_step=1)
MODES = {
    "default": {},
    "inject": dict(auto_reinit=True, reinit_mode="inject", reinit_min_iters=5),
    "reinit": dict(auto_reinit=True, reinit_mode="reinit", reinit_min_iters=5,
                   reinit_patience=3),
}
POSE_TOL = 1e-3


@pytest.fixture(autouse=True)
def _one_thread_private_lut_cache(monkeypatch, tmp_path):
    torch.set_num_threads(1)
    monkeypatch.setenv("MCL_LUT_CACHE", str(tmp_path / "lut_cache"))


def carry_map(jm) -> GridMap:
    """The JAX map's grids on the CPU; the port builds its own LUT."""
    return GridMap.from_numpy(
        occupancy=np.asarray(jm.occupancy), free_cells=np.asarray(jm.free_cells),
        num_free=int(jm.num_free), clearance=np.asarray(jm.clearance),
        origin_x=float(jm.origin_x), origin_y=float(jm.origin_y),
        resolution=jm.resolution, max_range_px=jm.max_range_px,
        max_range_meters=jm.max_range_meters, name=jm.name, device="cpu",
    )


class JaxDraws:
    """The draw source of the port's node: the JAX filter's key chain."""

    def __init__(self, jpf):
        self.jpf = jpf
        self.key = None

    def init(self, kind, seed, pose):
        s = self.jpf.init_global(seed) if kind == "global" else self.jpf.init_pose(pose, seed)
        self.key = s.key
        return np.asarray(s.particles), np.asarray(s.log_weights)

    def step(self, inject):
        if inject:
            self.key, k_res, k_mot, k_inj, k_mask = jax.random.split(self.key, 5)
        else:
            self.key, k_res, k_mot = jax.random.split(self.key, 3)
        d = dict(u0=float(jax.random.uniform(k_res, ())),
                 noise=np.asarray(jax.random.normal(k_mot, (N, 3), jnp.float32)))
        if inject:
            injected, _ = j_initialize_global(k_inj, self.jpf.grid_map, N, dtype=jnp.float32)
            d["injected"] = np.asarray(injected)
            d["mask_u"] = np.asarray(jax.random.uniform(k_mask, (N,)))
        return d


@pytest.fixture(scope="module")
def world():
    jm = random_obstacle_world(height=100, width=100, num_obstacles=6, seed=3)
    a = j_synthesize_trace(jm, duration_s=1.2, num_beams=60, seed=0)
    b = j_synthesize_trace(jm, duration_s=1.2, num_beams=60, seed=5)
    kidnap = dict(a.__dict__, scan_ranges=np.concatenate([a.scan_ranges[:12], b.scan_ranges[12:]]))
    jpf = JParticleFilter(jm, JMCLConfig(**BASE))
    jpf.set_beam_angles(a.beam_angles)
    return dict(jmap=jm, map=carry_map(jm), jtrace=JTrace(**kidnap), trace=Trace(**kidnap),
                jpf=jpf)


@pytest.fixture(scope="module")
def jax_runs(world):
    """Each mode's JAX replay: (result, inject_steps, auto_reinits)."""
    runs = {}
    for mode, kw in MODES.items():
        node = JMCLNode(world["jmap"], JMCLConfig(**BASE, **kw), rng_seed=1)
        node.filter = world["jpf"]  # one compiled step for every mode
        node.lidar_initialized = True
        node.initialize_pose(world["jtrace"].truth_pose[0])
        runs[mode] = (node.replay(world["jtrace"]), node.inject_steps, node.auto_reinits)
    return runs


def port_node(world, draws=True, **kw) -> MCLNode:
    return MCLNode(world["map"], MCLConfig(**BASE, **kw), rng_seed=1,
                   draws=JaxDraws(world["jpf"]) if draws else None)


@pytest.mark.parametrize("mode", list(MODES))
def test_node_replay_matches_jax_node(world, jax_runs, mode):
    node = port_node(world, **MODES[mode])
    node.initialize_pose(world["trace"].truth_pose[0])
    res = node.replay(world["trace"])
    jres, j_inject, j_reinits = jax_runs[mode]
    np.testing.assert_array_equal(res.times, jres.times)
    np.testing.assert_allclose(res.poses, jres.poses, rtol=0, atol=POSE_TOL)
    np.testing.assert_allclose(res.tracked, jres.tracked, rtol=0, atol=POSE_TOL)
    assert (node.inject_steps, node.auto_reinits) == (j_inject, j_reinits)
    assert res.corrections == len(jres.times) == len(world["trace"].scan_t) - 1
    if mode == "inject":
        assert node.inject_steps > 0
    if mode == "reinit":
        assert node.auto_reinits > 0


def test_step_injection_matches_jax_on_its_draws(world):
    jpf, n = world["jpf"], N
    pf = ParticleFilter(world["map"], MCLConfig(**BASE))
    pf.set_beam_angles(world["trace"].beam_angles)
    draws = JaxDraws(jpf)
    truth = world["trace"].truth_pose[0]
    parts, logw = draws.init("pose", 11, truth)
    js = jpf.init_pose(truth, 11)
    ts = MCLState.from_numpy(parts, logw, seed=0, device="cpu")
    for i, frac in enumerate((0.3, 0.0, 1.0)):
        action = np.float32([0.04, 0.0, 0.02])
        scan = world["trace"].scan_ranges[i]
        d = draws.step(True)
        js, jpose = jpf.step(js, action, scan, inject_fraction=frac)
        ts, tpose = pf.step(ts, action, scan, inject_fraction=frac, **d)
        np.testing.assert_allclose(tpose.numpy(), np.asarray(jpose), rtol=0, atol=POSE_TOL)
        rows = np.all(np.abs(ts.particles.numpy() - np.asarray(js.particles)) <= 1e-4, axis=1)
        assert rows.mean() >= 0.99, f"step {i}: {rows.mean():.3f} rows equal"
        if frac == 1.0:
            np.testing.assert_array_equal(ts.particles.numpy(), d["injected"])


def test_injection_draws_only_with_a_fraction(world):
    """None leaves the plain step's draws (and bits) as they are; a
    fraction of 0 draws the mask and poses and replaces nothing."""
    pf = ParticleFilter(world["map"], MCLConfig(**BASE))
    pf.set_beam_angles(world["trace"].beam_angles)
    truth = world["trace"].truth_pose[0]
    scan = world["trace"].scan_ranges[0]
    action = np.float32([0.04, 0.0, 0.02])
    a, pa = pf.step(pf.init_pose(truth, seed=2), action, scan)
    c, pc = pf.step(pf.init_pose(truth, seed=2), action, scan, inject_fraction=0.0)
    np.testing.assert_array_equal(pa.numpy(), pc.numpy())
    assert not torch.equal(a.generator.get_state(), c.generator.get_state())
    with pytest.raises(ValueError, match="inject_fraction"):
        pf.step(a, action, scan, mask_u=np.zeros(N, np.float32))


def _recording(node):
    """Record every pose the node's filter returns, in dispatch order."""
    dispatched = []
    step, step_many = node.filter.step, node.filter.step_many

    def rec_step(*a, **k):
        s, p = step(*a, **k)
        dispatched.append(p.numpy().copy())
        return s, p

    def rec_step_many(*a, **k):
        s, p = step_many(*a, **k)
        dispatched.extend(p.numpy().copy())
        return s, p

    node.filter.step, node.filter.step_many = rec_step, rec_step_many
    return dispatched


@pytest.mark.parametrize("chunk", [1, 4])
def test_async_paths_publish_every_correction_in_order(world, chunk):
    node = port_node(world, draws=False, async_correction=True, live_chunk=chunk)
    tr = world["trace"]
    node.initialize_pose(tr.truth_pose[0])
    published = []
    node.add_sink(CallbackSink(lambda topic, t, p: published.append(p["pose"]), topics=("pose",)))
    dispatched = _recording(node)
    t = 0.0
    for i in range(len(tr.scan_t)):
        node.on_odometry(*tr.odom_pose[4 * i], *tr.odom_twist[4 * i], stamp=t)
        node.on_scan(tr.scan_ranges[i], beam_angles=tr.beam_angles)
        pose = node.update(now=t)
        if pose is not None:
            node.publish_correction(t, pose)
        t += 0.04
    assert len(dispatched) >= 8 and len(dispatched) % chunk == 0
    np.testing.assert_array_equal(np.asarray(published), np.asarray(dispatched, np.float64))
    assert node.stats.measurement_count == len(dispatched)


def test_live_runner_publishes_every_correction(world):
    """The threaded scheduler on the chunked async path: the sinks see
    each dispatched pose once, in order (no assertion on wall time)."""
    node = port_node(world, draws=False, async_correction=True, live_chunk=2,
                     timer_frequency=200.0)
    tr = world["trace"]
    node.initialize_pose(tr.truth_pose[0])
    published = []
    node.add_sink(CallbackSink(lambda topic, t, p: published.append(p["pose"]), topics=("pose",)))
    dispatched = _recording(node)
    with LiveRunner(node) as runner:
        for i in range(len(tr.scan_t)):
            node.on_odometry(*tr.odom_pose[4 * i], *tr.odom_twist[4 * i])
            node.on_scan(tr.scan_ranges[i], beam_angles=tr.beam_angles)
            time.sleep(0.005)
        for _ in range(5000):  # the runner shares the CPU with other tests
            if runner.corrections > 0 or runner.error is not None:
                break
            time.sleep(0.002)
    assert runner.corrections > 0
    np.testing.assert_array_equal(np.asarray(published), np.asarray(dispatched, np.float64))


def test_profile_phases_times_each_phase(world):
    pf = ParticleFilter(world["map"], MCLConfig(**BASE))
    pf.set_beam_angles(world["trace"].beam_angles)
    s = pf.init_pose(world["trace"].truth_pose[0], seed=0)
    before = s.particles.clone()
    stats = pf.profile_phases(s, np.float32([0.04, 0, 0.01]), world["trace"].scan_ranges[0],
                              iters=3)
    assert stats.measurement_count == 3
    for name in ("resampling_time", "motion_model_time", "sensor_model_time", "total_mcl_time"):
        assert getattr(stats, name) > 0, name
    assert torch.equal(s.particles, before)
