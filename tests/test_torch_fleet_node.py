"""The port's ``FleetNode`` (``runtime/fleet_node.py``) against the JAX
package's, case for case with ``tests/test_fleet_node.py``.

Both nodes run on one small world made from the same numpy seed, with
scans cast by the JAX DDA oracle. The port's node takes a draw source
(``JaxDraws``) that replays the JAX fleet's key chain: each member's
clouds from ``init_global``/``init_pose`` with the node's seeds, and per
correction each member's resample offset and motion noise, split from its
key as ``mcl_step`` and the fleet's ``propose`` split it. Gates: poses
within 1e-3 at every synchronous correction and at least 99% of particle
rows within 1e-4 (``tests/test_torch_fleet.py``'s tolerance); tracked
poses within 1e-3 where the odometry stands still (the tracker's delay
compensation reads the wall time of each step, which differs between the
packages); the same errors for a refused beam geometry. The async
pipeline is held for order and counts, never for wall time.
"""

import threading
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from monte_carlo_localization_tpu.config import MCLConfig as JMCLConfig
from monte_carlo_localization_tpu.mapping import random_obstacle_world as j_world
from monte_carlo_localization_tpu.ops.raycast import cast_rays_dda as j_cast_rays_dda
from monte_carlo_localization_tpu.runtime import FleetNode as JFleetNode
from monte_carlo_localization_tpu.runtime import LiveRunner as JLiveRunner
from monte_carlo_localization_tpu_torch import MCLConfig
from monte_carlo_localization_tpu_torch.mapping import random_obstacle_world
from monte_carlo_localization_tpu_torch.runtime import CallbackSink, FleetNode, LiveRunner
from monte_carlo_localization_tpu_torch.runtime import node as node_mod

F, N = 3, 128
POSE_TOL = 1e-3
ROW_TOL, ROWS_MIN = 1e-4, 0.99
BEAMS = np.linspace(-2.35, 2.35, 60).astype(np.float32)
POSES = np.array([[2.3, 2.1, 0.2], [4.2, 3.3, 1.1], [3.1, 4.4, -0.7]], np.float64)
WORLD = dict(height=120, width=120, num_obstacles=8, seed=3)


@pytest.fixture(autouse=True)
def _one_thread_private_lut_cache(monkeypatch, tmp_path):
    torch.set_num_threads(1)
    monkeypatch.setenv("MCL_LUT_CACHE", str(tmp_path / "lut_cache"))


@pytest.fixture(scope="module")
def world():
    jm = j_world(**WORLD)
    scans = []
    for p in POSES:
        q = np.stack([np.full(60, p[0]), np.full(60, p[1]), p[2] + BEAMS], 1).astype(np.float32)
        scans.append(np.asarray(j_cast_rays_dda(jm, jnp.asarray(q))))
    return dict(jmap=jm, map=random_obstacle_world(**WORLD, device="cpu"), scans=scans)


class JaxDraws:
    """The port node's draw source: the JAX fleet's per-member key chain."""

    def __init__(self, jff):
        self.jff = jff
        self.keys = None

    def init(self, kind, seed, poses):
        s = self.jff.init_global(seed) if kind == "global" else self.jff.init_pose(poses, seed)
        self.keys = s.keys
        return np.asarray(s.particles), np.asarray(s.log_weights)

    def step(self):
        keys, u0, noise = [], [], []
        for key in self.keys:
            key, kr, km = jax.random.split(key, 3)
            keys.append(key)
            u0.append(float(jax.random.uniform(kr, ())))
            noise.append(np.asarray(jax.random.normal(km, (N, 3), jnp.float32)))
        self.keys = jnp.stack(keys)
        return dict(u0=np.float32(u0), noise=np.stack(noise))


def pair(world, method="lut", **kw):
    """A JAX node and the port's node on its draws, same config and seed."""
    cfg = dict(max_particles=N, raycast_method=method, angle_step=1, **kw)
    jn = JFleetNode(world["jmap"], fleet_size=F, config=JMCLConfig(**cfg), rng_seed=0)
    tn = FleetNode(world["map"], fleet_size=F, config=MCLConfig(**cfg), rng_seed=0,
                   draws=JaxDraws(jn.filter))
    return jn, tn


def feed(node, world, t, twist=(0.0, 0.0)):
    for m in range(F):
        node.on_scan(m, world["scans"][m], beam_angles=BEAMS)
        node.on_odometry(m, *POSES[m], *twist, stamp=t)


def assert_same_belief(jn, tn, jposes, tposes, what):
    np.testing.assert_allclose(tposes, jposes, rtol=0, atol=POSE_TOL, err_msg=what)
    rows = np.all(np.abs(tn.state.particles.numpy() - np.asarray(jn.state.particles))
                  <= ROW_TOL, axis=2)
    assert rows.mean() >= ROWS_MIN, f"{what}: {rows.mean():.3f} of rows equal"


@pytest.mark.parametrize("method", ["lut", "lut_pallas"])
def test_tracked_correction_loop(world, method):
    jn, tn = pair(world, method)
    for node in (jn, tn):
        node.initialize_pose(POSES)
        feed(node, world, 0.0)
    np.testing.assert_array_equal(tn.state.particles.numpy(), np.asarray(jn.state.particles))
    t = 0.0
    assert jn.update(now=t) is None and tn.update(now=t) is None
    for i in range(6):
        t += 0.05
        jp, tp = jn.update(now=t), tn.update(now=t)
        assert tp.shape == (F, 3) and tp.dtype == np.float64
        assert_same_belief(jn, tn, jp, tp, f"{method} correction {i}")
        # the odometry stands still, so the tracked poses agree too
        np.testing.assert_allclose(tn.current_poses(), jn.current_poses(), rtol=0,
                                   atol=POSE_TOL)
    assert np.linalg.norm(tp[:, :2] - POSES[:, :2], axis=1).max() < 0.5
    cur = tn.current_poses()
    assert cur.shape == (F, 3)
    assert np.linalg.norm(cur[:, :2] - POSES[:, :2], axis=1).max() < 0.5
    assert all(tr.active for tr in tn.trackers) and all(tr.active for tr in jn.trackers)
    np.testing.assert_allclose(tn.base_link_poses(), jn.base_link_poses(), rtol=0,
                               atol=POSE_TOL)
    if method == "lut_pallas":
        assert tn.filter.likelihood.fleet_launch_count == 0  # CPU tensors: the plain version


def test_moving_fleet_matches_jax_on_its_draws(world):
    """Members driving at their own twists: each tick's action is twist x
    dt at the caller's clock, so the motion model runs on equal actions."""
    jn, tn = pair(world)
    for node in (jn, tn):
        node.initialize_pose(POSES)
        for m in range(F):
            node.on_scan(m, world["scans"][m], beam_angles=BEAMS)
            node.on_odometry(m, *POSES[m], 0.3 * m, 0.2 - 0.1 * m, stamp=0.0)
    t = 0.0
    jn.update(now=t)
    tn.update(now=t)
    for i in range(5):
        t += 0.04
        assert_same_belief(jn, tn, jn.update(now=t), tn.update(now=t), f"correction {i}")
    assert tn.iters == jn.iters == 5


def test_update_gates(world):
    jn, tn = pair(world)
    seen = {}
    for name, node in (("jax", jn), ("port", tn)):
        got = [node.update(now=0.0), node.update(now=0.05)]  # no scans yet
        # a partial fleet (one member's scan missing) must not step
        node.on_scan(0, world["scans"][0], beam_angles=BEAMS)
        got.append(node.update(now=0.10))
        feed(node, world, 0.1)
        got.append(node.update(now=5.0))  # dt > 1 s gap skip (reference :750-752)
        got.append(node.update(now=5.05))
        seen[name] = [g is not None for g in got]
    assert seen["port"] == seen["jax"] == [False, False, False, False, True]


def _raises(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


def test_mismatched_beam_count_rejected(world):
    msgs = []
    for node in pair(world):
        node.on_scan(0, world["scans"][0], beam_angles=BEAMS)
        msgs.append(_raises(lambda: node.on_scan(1, np.ones(24, np.float32))))
    assert msgs[0] == msgs[1] and "beams" in msgs[1]


def test_heterogeneous_beam_geometry_rejected(world):
    """A member with another lidar model (same beam count, other
    angle_min or increment) fails at ingest in both packages, with the
    same message; a matching geometry in either form passes."""
    inc = float(BEAMS[1] - BEAMS[0])
    msgs = []
    for node in pair(world):
        node.on_scan(0, world["scans"][0], beam_angles=BEAMS)
        ones = np.ones(len(BEAMS), np.float32)
        shifted = _raises(lambda: node.on_scan(1, ones, beam_angles=BEAMS + 0.1))
        wider = _raises(lambda: node.on_scan(1, ones, angle_min=float(BEAMS[0]),
                                             angle_increment=inc * 1.5))
        node.on_scan(1, ones, beam_angles=BEAMS.copy())
        node.on_scan(2, ones, angle_min=float(BEAMS[0]), angle_increment=inc)
        msgs.append((shifted, wider))
    assert msgs[0] == msgs[1]
    assert all("geometry" in m for m in msgs[1])


def test_scan_rows_swapped_not_mutated(world):
    """Ingest never writes into a row update() may be stacking: rows are
    swapped by reference."""
    for node in pair(world):
        feed(node, world, 0.0)
        before = node._scan_rows[0]
        kept = before.copy()
        node.on_scan(0, world["scans"][0] + 0.1, beam_angles=BEAMS)
        assert node._scan_rows[0] is not before
        np.testing.assert_array_equal(before, kept)


def _async_node(world, jn, depth):
    tn = FleetNode(world["map"], fleet_size=F, rng_seed=0, draws=JaxDraws(jn.filter),
                   config=MCLConfig(max_particles=N, raycast_method="lut", angle_step=1,
                                    async_correction=True, async_depth=depth))
    seen = []
    tn.add_sink(CallbackSink(lambda top, t, p: seen.append((t, p["poses"].copy())),
                             topics=("fleet_pose",)))
    return tn, seen


@pytest.mark.parametrize("ready", [True, False], ids=["ready", "never_ready"])
def test_async_pipeline_and_sinks(world, monkeypatch, ready):
    """The async pipeline, held for order and counts against the JAX
    node's synchronous corrections on the same draws (the odometry stands
    still, so no action reads the wall clock). A CPU readback is ready at
    once: each tick dispatches and harvests its own correction. With
    readbacks never ready, the queue fills to ``async_depth`` and each
    tick harvests the oldest: the poses come back in dispatch order, one
    tick late."""
    depth = 2
    jn, _ = pair(world)
    tn, seen = _async_node(world, jn, depth)
    if not ready:
        monkeypatch.setattr(node_mod._Readback, "ready", lambda self: False)
    for node in (jn, tn):
        node.initialize_pose(POSES)
        feed(node, world, 0.0)
    t, ticks = 0.0, 8
    jn.update(now=t)
    tn.update(now=t)
    want, got = [], []
    for _ in range(ticks):
        t += 0.05
        want.append(jn.update(now=t))
        p = tn.update(now=t)
        if p is not None:
            got.append(p)
            tn.publish_correction(t, p)
    lag = 0 if ready else depth - 1
    assert len(got) == ticks - lag and len(tn._inflight_q) == lag
    assert tn.stats.measurement_count == len(got)
    for k, p in enumerate(got):
        np.testing.assert_allclose(p, want[k], rtol=0, atol=POSE_TOL, err_msg=f"harvest {k}")
    assert [s[1].shape for s in seen] == [(F, 3)] * len(got)
    assert np.linalg.norm(got[-1][:, :2] - POSES[:, :2], axis=1).max() < 0.5
    # a re-initialization drops what is in flight
    tn.initialize_pose(POSES)
    assert not tn._inflight_q


def test_fleet_sinks_publish_batches(world):
    _, tn = pair(world)
    seen = {}
    tn.add_sink(CallbackSink(lambda top, t, p: seen.setdefault(top, []).append(p),
                             topics=("fleet_tf", "fleet_pose", "fleet_particles")))
    tn.initialize_pose(POSES)
    feed(tn, world, 0.0)
    tn.update(now=0.0)
    poses = tn.update(now=0.05)
    tn.publish_tick(0.05)
    tn.publish_correction(0.05, poses)
    assert seen["fleet_tf"][0]["poses"].shape == (F, 3)
    np.testing.assert_array_equal(seen["fleet_pose"][0]["poses"], poses)
    clouds = seen["fleet_particles"][0]["clouds"]
    assert clouds.shape == (F, min(tn.config.max_viz_particles, N), 3)
    assert np.linalg.norm(clouds[..., :2].mean(1) - POSES[:, :2], axis=1).max() < 0.5


def test_live_chunk_refused_as_jax_does(world):
    cfg = dict(max_particles=N, raycast_method="lut", async_correction=True, live_chunk=4)
    with pytest.raises(ValueError, match="micro-chunked"):
        JFleetNode(world["jmap"], fleet_size=F, config=JMCLConfig(**cfg))
    with pytest.raises(ValueError, match="micro-chunked"):
        FleetNode(world["map"], fleet_size=F, config=MCLConfig(**cfg))


def test_dedup_slots_build_the_fleet_form(world, monkeypatch):
    """``pallas_dedup_slots`` on a fleet node: both packages build it, the
    port's query resolves the slots to 0 as JAX's fleet does, and a
    correction runs the fleet form of the likelihood, not the dedup path."""
    from monte_carlo_localization_tpu_torch.ops import lut_query as tlut

    jn, tn = pair(world, "lut_pallas", pallas_dedup_slots=4)
    for node in (jn, tn):  # the first scan sets the beams and builds the query
        node.initialize_pose(POSES)
        feed(node, world, 0.0)
    assert jn.filter.map.range_lut is not None  # JAX built its fleet query
    q = tn.filter.likelihood
    assert q.fleet and q.dedup_slots == 0
    seen = []
    plain = tlut.lut_log_weights_reference
    monkeypatch.setattr(tlut, "lut_dedup_reference",
                        lambda *a, **k: pytest.fail("a fleet reached the dedup path"))
    monkeypatch.setattr(tlut, "lut_log_weights_reference",
                        lambda qq, *a, **k: seen.append(qq.fleet) or plain(qq, *a, **k))
    assert tn.update(now=0.0) is None
    assert tn.update(now=0.05).shape == (F, 3)
    assert seen == [True] and q.fleet_launch_count == q.dedup_launch_count == 0


def _drive_live(node, runner_cls, scans):
    node.initialize_pose(POSES)
    for m in range(F):
        node.on_scan(m, scans[m], beam_angles=BEAMS)
        node.on_odometry(m, *POSES[m], 0.0, 0.0, stamp=0.0)
    stop = threading.Event()

    def odom_pump():  # high-rate odometry from another thread
        while not stop.is_set():
            for m in range(F):
                node.on_odometry(m, *POSES[m], 0.0, 0.0)
            time.sleep(0.002)

    pump = threading.Thread(target=odom_pump, daemon=True)
    pump.start()
    with runner_cls(node) as runner:
        time.sleep(1.0)
    stop.set()
    pump.join(timeout=2.0)
    return runner


def test_live_runner_drives_a_fleet(world):
    """LiveRunner needs no fleet-specific changes (duck typing), in both
    packages; wall-clock runs, so only their outcomes are compared."""
    cfg = dict(max_particles=N, raycast_method="lut", angle_step=1, timer_frequency=50.0)
    jn = JFleetNode(world["jmap"], fleet_size=F, config=JMCLConfig(**cfg), rng_seed=0)
    tn = FleetNode(world["map"], fleet_size=F, config=MCLConfig(**cfg), rng_seed=0)
    for node, runner_cls in ((jn, JLiveRunner), (tn, LiveRunner)):
        runner = _drive_live(node, runner_cls, world["scans"])
        assert runner.corrections > 0 and runner.ticks >= runner.corrections
        cur = node.current_poses()
        assert np.linalg.norm(cur[:, :2] - POSES[:, :2], axis=1).max() < 0.5
