"""The port's numpy runtime pieces against the JAX package's: the odometry
tracker (exact), traces (save/load both ways, event order, synthesis bit
for bit with the native caster), the sinks' files, and the geometry,
validation and timing helpers."""

import json

import numpy as np
import pytest
import torch

from monte_carlo_localization_tpu import native as j_native
from monte_carlo_localization_tpu.mapping import map_from_occupancy as j_map_from_occupancy
from monte_carlo_localization_tpu.mapping import random_obstacle_world
from monte_carlo_localization_tpu.runtime import CallbackSink as JCallbackSink
from monte_carlo_localization_tpu.runtime import JsonlSink as JJsonlSink
from monte_carlo_localization_tpu.runtime import NpzSink as JNpzSink
from monte_carlo_localization_tpu.runtime import OdometryTracker as JTracker
from monte_carlo_localization_tpu.runtime import Trace as JTrace
from monte_carlo_localization_tpu.runtime import TraceReader as JTraceReader
from monte_carlo_localization_tpu.runtime import synthesize_trace as j_synthesize_trace
from monte_carlo_localization_tpu.utils import geometry as j_geometry
from monte_carlo_localization_tpu.utils.timing import TimingStats as JTimingStats
from monte_carlo_localization_tpu.utils.validation import is_pose_valid as j_is_pose_valid
from monte_carlo_localization_tpu_torch import GridMap, native
from monte_carlo_localization_tpu_torch.runtime import (
    CallbackSink,
    HostRaycaster,
    JsonlSink,
    NpzSink,
    OdometryTracker,
    Trace,
    TraceReader,
    synthesize_trace,
)
from monte_carlo_localization_tpu_torch.utils import geometry, timing
from monte_carlo_localization_tpu_torch.utils.validation import is_pose_valid


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def maps():
    occ = np.asarray(random_obstacle_world(height=90, width=110, num_obstacles=5,
                                           seed=4).occupancy).copy()
    # an unknown band, so the synthesizer's drive grid differs from its scan grid
    occ[:, 95:] = np.where(occ[:, 95:] == 0, -1, occ[:, 95:])
    jm = j_map_from_occupancy(occ, resolution=0.05, origin=(-1.0, 0.5, 0.0), name="band")
    pm = GridMap.from_numpy(
        occupancy=np.asarray(jm.occupancy), free_cells=np.asarray(jm.free_cells),
        num_free=int(jm.num_free), clearance=np.asarray(jm.clearance),
        origin_x=float(jm.origin_x), origin_y=float(jm.origin_y),
        resolution=jm.resolution, max_range_px=jm.max_range_px,
        max_range_meters=jm.max_range_meters, name=jm.name, device="cpu",
    )
    return jm, pm


def _drive(tracker):
    """One script of odometry, anchors, deactivation; the snapshots and
    priority-chain poses it passes through."""
    out = []
    rng = np.random.default_rng(0)
    tracker.anchor(np.array([1.0, 2.0, 0.3]), from_seed=True)  # before any odometry
    for i in range(40):
        pose = rng.normal(size=3)
        tracker.on_odometry(*pose, velocity=rng.normal(), angular_velocity=rng.normal(),
                            stamp=0.01 * i)
        if i % 7 == 3:
            tracker.anchor(rng.normal(size=3) * 5, avg_mcl_ms=rng.uniform(0, 20),
                           delay_compensation_factor=1.5)
        if i == 25:
            tracker.deactivate()
        s = tracker.snapshot()
        out.append((s.pose, s.velocity, s.angular_velocity, s.last_odom_pose, s.last_stamp))
        mean = rng.normal(size=3).astype(np.float32)
        out.append(tracker.current_pose(None if i % 3 else rng.normal(size=3), mean))
        out.append(tracker.current_pose(np.array([np.nan, 0, 0]), None))
    return out


def test_tracker_matches_jax_exactly():
    a, b = _drive(OdometryTracker()), _drive(JTracker())
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(x, tuple):
            for u, v in zip(x, y):
                if u is None:
                    assert v is None
                else:
                    np.testing.assert_array_equal(u, v)
        else:
            np.testing.assert_array_equal(x, y)


def test_tracker_reads_a_lazy_particle_mean_only_when_needed():
    t = OdometryTracker()
    calls = []

    def mean():
        calls.append(1)
        return np.array([1.0, 2.0, 0.0])

    np.testing.assert_array_equal(t.current_pose(np.array([3.0, 4.0, 0.0]), mean), [3, 4, 0])
    assert not calls
    np.testing.assert_array_equal(t.current_pose(None, mean), [1, 2, 0])
    assert calls == [1]


def test_synthesize_trace_bit_equal_to_jax(maps, tmp_path):
    jm, pm = maps
    assert native.available() and j_native.available()
    a = synthesize_trace(pm, duration_s=1.0, num_beams=90, seed=3)
    b = j_synthesize_trace(jm, duration_s=1.0, num_beams=90, seed=3)
    for k in ("odom_t", "odom_pose", "odom_twist", "scan_t", "scan_ranges", "beam_angles",
              "truth_t", "truth_pose"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k), err_msg=k)
    assert a.map_name == b.map_name
    # save/load both ways, and the merged event order
    pa, pb = a.save(tmp_path / "port"), b.save(tmp_path / "jax")
    assert pa.name == "port.npz"
    for t, u in ((JTrace.load(pa), b), (Trace.load(pb), a)):
        for k in ("odom_pose", "scan_ranges", "truth_pose"):
            np.testing.assert_array_equal(getattr(t, k), getattr(u, k))
        assert t.map_name == u.map_name and t.duration == u.duration
    ev = [(e.t, e.kind, e.index) for e in TraceReader(a)]
    assert ev == [(e.t, e.kind, e.index) for e in JTraceReader(b)]
    assert len(ev) == len(a.odom_t) + len(a.scan_t)


def test_host_raycaster_matches_jax_native_and_its_torch_fallback(maps):
    jm, pm = maps
    from monte_carlo_localization_tpu.runtime import HostRaycaster as JHostRaycaster

    rng = np.random.default_rng(1)
    free = np.asarray(jm.free_cells)[rng.integers(0, int(jm.num_free), 64)]
    q = np.stack([free[:, 1] * jm.resolution + float(jm.origin_x),
                  free[:, 0] * jm.resolution + float(jm.origin_y),
                  rng.uniform(-np.pi, np.pi, 64)], 1).astype(np.float32)
    ours = HostRaycaster(pm)
    np.testing.assert_array_equal(ours(q), JHostRaycaster(jm)(q))
    fallback = HostRaycaster(pm)
    fallback._native = False  # the path without a C++ toolchain
    # float32 torch steps against the C++ double march: ~2 px (as the oracle tests)
    assert np.mean(np.abs(fallback(q) - ours(q)) <= 2 * jm.resolution) >= 0.95


def _publish(sink):
    rng = np.random.default_rng(2)
    for i in range(5):
        t = 0.1 * i
        sink.publish("tf", t, {"pose": rng.normal(size=3)})
        sink.publish("odom", t, {"pose": rng.normal(size=3), "velocity": float(rng.normal()),
                                 "angular_velocity": 0.5})
        sink.publish("pose", t, {"pose": rng.normal(size=3)})
        # a cloud that changes size mid-run: the npz sink NaN-pads it
        sink.publish("particles", t, {"cloud": rng.normal(size=(4 + (i > 2), 3))})
    sink.close()


def test_sinks_write_the_jax_files(tmp_path):
    _publish(JsonlSink(tmp_path / "port.jsonl"))
    _publish(JJsonlSink(tmp_path / "jax.jsonl"))
    assert (tmp_path / "port.jsonl").read_bytes() == (tmp_path / "jax.jsonl").read_bytes()
    assert json.loads((tmp_path / "port.jsonl").read_text().splitlines()[0])["topic"] == "tf"
    _publish(NpzSink(tmp_path / "port.npz"))
    _publish(JNpzSink(tmp_path / "jax.npz"))
    a, b = NpzSink.load(tmp_path / "port.npz"), JNpzSink.load(tmp_path / "jax.npz")
    assert sorted(a) == sorted(b) and "particles_cloud_len" in a
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    seen, jseen = [], []
    for cls, out in ((CallbackSink, seen), (JCallbackSink, jseen)):
        s = cls(lambda topic, t, p, out=out: out.append((topic, t)), topics=("pose",))
        assert s.wants("pose") and not s.wants("tf")
        _publish(s)
    assert seen == jseen


def test_geometry_and_validation_match_jax():
    rng = np.random.default_rng(3)
    poses = rng.normal(size=(7, 3)).astype(np.float32)
    for p in (poses, poses[0], poses.astype(np.float64)):
        np.testing.assert_array_equal(geometry.apply_vehicle_offset(p, 0.27),
                                      j_geometry.apply_vehicle_offset(p, 0.27))
    for yaw in (-3.0, -0.5, 0.0, 1.2, 3.1):
        q = geometry.yaw_to_quaternion(yaw)
        assert q == j_geometry.yaw_to_quaternion(yaw)
        assert geometry.quaternion_to_yaw(*q) == j_geometry.quaternion_to_yaw(*q)
    for p in ([0, 0, 0], [1e5, 0, 0], [0, np.inf, 0], [np.nan, 0, 0], [9999.0, -9999.0, 7.0]):
        assert is_pose_valid(p) == j_is_pose_valid(p)
        assert is_pose_valid(p, 100.0) == j_is_pose_valid(p, 100.0)


def test_timing_stats_print_like_jax(tmp_path):
    a, b = timing.TimingStats(), JTimingStats()
    for s in (a, b):
        s.total_mcl_time, s.sensor_model_time, s.resampling_time = 12.5, 4.0, 3.0
        s.measurement_count = 5
    la, lb = [], []
    a.print_stats(la.append)
    b.print_stats(lb.append)
    assert la == lb and a.avg_total_ms == b.avg_total_ms == 2.5
    with timing.Stopwatch(a, "motion_model_time"):
        pass
    assert a.motion_model_time >= 0
    logged = []
    with timing.device_trace(tmp_path / "trace", log=logged.append):
        torch.ones(8).sum()
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert "traceEvents" in trace and logged
