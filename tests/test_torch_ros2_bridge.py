"""The port's ROS2 bridge (``runtime/ros2_bridge.py``): its pure message
fillers and ingest converters against the JAX package's on the same
duck-typed messages (``tests/test_ros2_bridge.py``), and its main loop
against a stubbed rclpy, case for case with
``tests/test_ros2_bridge_loop.py`` (the stub is this file's own copy):
scan and odometry callbacks, the MCL timer, the latched 5 Hz map
republish, and the /initialpose and /clicked_point recoveries, on a CPU
map (reference src/particle_filter.cpp:115-165 wiring, :355-379
interactive init, :857-983 outputs). No ROS install is needed; without
rclpy the bridge raises a clear ImportError.
"""

from __future__ import annotations

import sys
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from monte_carlo_localization_tpu.mapping import box_world as j_box_world
from monte_carlo_localization_tpu.ops.raycast import cast_rays_dda as j_cast_rays_dda
from monte_carlo_localization_tpu.runtime import ros2_bridge as jrb
from monte_carlo_localization_tpu_torch import MCLConfig
from monte_carlo_localization_tpu_torch.mapping import box_world
from monte_carlo_localization_tpu_torch.runtime import ros2_bridge as rb
from monte_carlo_localization_tpu_torch.utils.geometry import quaternion_to_yaw

BOX = dict(height=60, width=80)
BEAMS = np.linspace(-2.35, 2.35, 60).astype(np.float32)
POSE = np.array([2.31, 2.12, 0.4], np.float32)


@pytest.fixture(autouse=True)
def _one_thread_private_lut_cache(monkeypatch, tmp_path):
    torch.set_num_threads(1)
    monkeypatch.setenv("MCL_LUT_CACHE", str(tmp_path / "lut_cache"))


@pytest.fixture(scope="module")
def maps():
    return j_box_world(**BOX), box_world(**BOX, device="cpu")


@pytest.fixture(scope="module")
def scan(maps):
    q = np.stack([np.full(60, POSE[0]), np.full(60, POSE[1]), POSE[2] + BEAMS], 1)
    return np.asarray(j_cast_rays_dda(maps[0], jnp.asarray(q.astype(np.float32))))


# ----- duck-typed ROS message stand-ins -----

class AutoMsg:
    """Attribute-materializing message stub: ``msg.pose.position.x = 1``
    works without declaring the nesting (mirrors rosidl message field
    access closely enough for the bridge's fillers)."""

    def __getattr__(self, name):
        child = AutoMsg()
        object.__setattr__(self, name, child)
        return child


def _msg_class(name):
    return type(name, (AutoMsg,), {})


class FakeTime:
    def __init__(self, t):
        self._t = t

    def seconds_nanoseconds(self):
        s = int(self._t)
        return s, int((self._t - s) * 1e9)

    def to_msg(self):
        m = AutoMsg()
        m.sec, m.nanosec = self.seconds_nanoseconds()
        return m


class FakeClock:
    def __init__(self, holder):
        self._holder = holder

    def now(self):
        return FakeTime(self._holder["t"])


class FakePublisher:
    def __init__(self, topic, qos):
        self.topic = topic
        self.qos = qos
        self.msgs = []

    def publish(self, msg):
        self.msgs.append(msg)


class FakeBroadcaster:
    def __init__(self, node):
        self.sent = []

    def sendTransform(self, t):
        self.sent.append(t)


class FakeRosNode:
    def __init__(self, name):
        self.name = name
        self.pubs = {}
        self.subs = {}
        self.timers = []  # (period, callback)
        self.clock_holder = {"t": 100.0}

    def create_publisher(self, typ, topic, qos):
        p = FakePublisher(topic, qos)
        self.pubs[topic] = p
        return p

    def create_subscription(self, typ, topic, cb, qos):
        self.subs[topic] = cb

    def create_timer(self, period, cb):
        self.timers.append((period, cb))

    def get_clock(self):
        return FakeClock(self.clock_holder)

    # test helpers
    def tick(self, dt):
        """Advance sim time and fire every timer once (executor turn)."""
        self.clock_holder["t"] += dt
        for _, cb in list(self.timers):
            cb()

    def timer_with_period(self, period):
        for p, cb in self.timers:
            if abs(p - period) < 1e-9:
                return cb
        raise AssertionError(f"no timer with period {period}: {self.timers}")


@pytest.fixture
def stub_ros(monkeypatch):
    """Install a fake rclpy + message stack into sys.modules."""
    rclpy = types.ModuleType("rclpy")
    rclpy_node = types.ModuleType("rclpy.node")
    rclpy_node.Node = FakeRosNode
    rclpy.node = rclpy_node
    rclpy_qos = types.ModuleType("rclpy.qos")

    class QoSProfile:
        def __init__(self, depth, durability=None):
            self.depth = depth
            self.durability = durability

    class DurabilityPolicy:
        TRANSIENT_LOCAL = "transient_local"
        VOLATILE = "volatile"

    rclpy_qos.QoSProfile = QoSProfile
    rclpy_qos.DurabilityPolicy = DurabilityPolicy
    rclpy.qos = rclpy_qos

    geo = types.ModuleType("geometry_msgs")
    geo_msg = types.ModuleType("geometry_msgs.msg")
    for n in ("PointStamped", "PoseArray", "PoseStamped",
              "PoseWithCovarianceStamped", "TransformStamped", "Pose"):
        setattr(geo_msg, n, _msg_class(n))
    geo.msg = geo_msg

    nav = types.ModuleType("nav_msgs")
    nav_msg = types.ModuleType("nav_msgs.msg")
    for n in ("OccupancyGrid", "Odometry"):
        setattr(nav_msg, n, _msg_class(n))
    nav.msg = nav_msg

    sensor = types.ModuleType("sensor_msgs")
    sensor_msg = types.ModuleType("sensor_msgs.msg")
    sensor_msg.LaserScan = _msg_class("LaserScan")
    sensor.msg = sensor_msg

    tf2 = types.ModuleType("tf2_ros")
    tf2.TransformBroadcaster = FakeBroadcaster

    mods = {
        "rclpy": rclpy, "rclpy.node": rclpy_node, "rclpy.qos": rclpy_qos,
        "geometry_msgs": geo, "geometry_msgs.msg": geo_msg,
        "nav_msgs": nav, "nav_msgs.msg": nav_msg,
        "sensor_msgs": sensor, "sensor_msgs.msg": sensor_msg,
        "tf2_ros": tf2,
    }
    for k, v in mods.items():
        monkeypatch.setitem(sys.modules, k, v)
    return mods


def _fields(msg, prefix=""):
    """Every leaf attribute a filler set on a duck-typed message."""
    out = {}
    for k, v in vars(msg).items():
        if isinstance(v, AutoMsg):
            out.update(_fields(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


# ----- the fillers against the JAX package's -----

@pytest.mark.parametrize("pose", [[1.5, -2.0, 0.7], [0.0, 3.0, -3.1], [4.0, 5.0, 1.0]])
def test_pose_fillers_equal_jax(pose):
    for fill in ("fill_pose", "fill_transform"):
        a, b = AutoMsg(), AutoMsg()
        getattr(rb, fill)(a, np.asarray(pose))
        getattr(jrb, fill)(b, np.asarray(pose))
        assert _fields(a) == _fields(b), fill
    m = AutoMsg()
    rb.fill_pose(m, np.asarray(pose))
    np.testing.assert_array_equal(rb.pose_from_msg(m), jrb.pose_from_msg(m))
    np.testing.assert_allclose(rb.pose_from_msg(m), pose, atol=1e-9)
    yaw = quaternion_to_yaw(m.orientation.x, m.orientation.y, m.orientation.z, m.orientation.w)
    assert abs(yaw - pose[2]) < 1e-9


def test_cloud_and_odometry_fillers_equal_jax():
    cloud = np.array([[0.0, 1.0, 0.1], [2.0, 3.0, -0.5]])
    msgs = []
    for mod in (rb, jrb):
        pa = AutoMsg()
        pa.poses = [AutoMsg(), AutoMsg()]
        mod.fill_pose_array(pa, cloud)
        om = AutoMsg()
        mod.fill_odometry(om, [1.0, 2.0, 0.3], velocity=1.5, angular_velocity=-0.2)
        msgs.append(([_fields(p) for p in pa.poses], _fields(om)))
    assert msgs[0] == msgs[1]
    om = AutoMsg()
    rb.fill_odometry(om, [1.0, 2.0, 0.3], velocity=0.9, angular_velocity=0.1)
    assert rb.odom_to_args(om) == jrb.odom_to_args(om)
    x, y, th, v, w = rb.odom_to_args(om)
    assert (x, y, v, w) == (1.0, 2.0, 0.9, 0.1) and abs(th - 0.3) < 1e-9


def test_occupancy_grid_filler_equals_jax(maps):
    jm, tm = maps
    a, b = AutoMsg(), AutoMsg()
    rb.fill_occupancy_grid(a, tm)
    jrb.fill_occupancy_grid(b, jm)
    assert _fields(a) == _fields(b)
    assert a.info.width == tm.width and a.info.height == tm.height
    assert a.data[: tm.width] == [int(v) for v in tm.occupancy[0].tolist()]


def test_scan_converter_equals_jax():
    msg = AutoMsg()
    msg.ranges = [1.0, 2.0, 3.0]
    msg.angle_min, msg.angle_increment = -1.5, 0.1
    (r, amin, ainc), (jr, jamin, jainc) = rb.scan_to_arrays(msg), jrb.scan_to_arrays(msg)
    np.testing.assert_array_equal(r, jr)
    assert r.dtype == np.float32 and (amin, ainc) == (jamin, jainc) == (-1.5, 0.1)


def test_bridge_raises_clear_import_error_without_rclpy(maps, monkeypatch):
    monkeypatch.setitem(sys.modules, "rclpy", None)
    with pytest.raises(ImportError, match="rclpy"):
        rb.ROS2Bridge(maps[1])


def _make_bridge(tm, sim_mode=False, **cfg_kw):
    cfg = MCLConfig(
        max_particles=128, angle_step=1, timer_frequency=50.0,
        max_viz_particles=32, raycast_method="lut", lut_theta_bins=360, **cfg_kw,
    )
    return rb.ROS2Bridge(tm, cfg, sim_mode=sim_mode)


def _scan_msg(stub_ros, ranges, beams):
    msg = stub_ros["sensor_msgs.msg"].LaserScan()
    msg.ranges = ranges.tolist()
    msg.angle_min = float(beams[0])
    msg.angle_increment = float(beams[1] - beams[0])
    return msg


def _odom_msg(stub_ros, x, y, theta, v, w):
    msg = stub_ros["nav_msgs.msg"].Odometry()
    rb.fill_pose(msg.pose.pose, np.array([x, y, theta]))
    msg.twist.twist.linear.x = v
    msg.twist.twist.angular.z = w
    return msg


def _initialpose(stub_ros, pose):
    ip = stub_ros["geometry_msgs.msg"].PoseWithCovarianceStamped()
    rb.fill_pose(ip.pose.pose, pose)
    return ip


def test_wiring_matches_reference_topics(stub_ros, maps):
    tm = maps[1]
    b = _make_bridge(tm)
    n = b.ros_node
    assert set(n.pubs) == {
        "/pf/viz/inferred_pose", "/pf/viz/particles", "/pf/pose/odom", "/map",
    }
    assert n.pubs["/map"].qos.durability == "transient_local"
    assert set(n.subs) == {
        b.config.scan_topic, b.config.odom_topic, "/initialpose", "/clicked_point",
    }
    n.timer_with_period(1.0 / b.config.timer_frequency)
    n.timer_with_period(0.2)
    (m,) = n.pubs["/map"].msgs
    assert m.info.width == tm.width and m.info.height == tm.height
    assert len(m.data) == tm.width * tm.height
    assert b.node.device == torch.device("cpu")


def test_sim_mode_switches_odom_topic(stub_ros, maps):
    b = _make_bridge(maps[1], sim_mode=True)
    assert "/ego_racecar/odom" in b.ros_node.subs
    assert b.config.odom_topic not in b.ros_node.subs


def test_timer_driven_correction_publishes(stub_ros, maps, scan):
    """Scan and odometry callbacks, then timer ticks: corrections run and
    the inferred pose, particle cloud, TF and odometry all fan out."""
    b = _make_bridge(maps[1])
    n = b.ros_node
    n.subs[b.config.scan_topic](_scan_msg(stub_ros, scan, BEAMS))
    assert b.node.lidar_initialized
    n.subs[b.config.odom_topic](_odom_msg(stub_ros, *POSE, 0.3, 0.0))
    n.subs["/initialpose"](_initialpose(stub_ros, POSE))
    for _ in range(4):
        n.tick(0.02)
    assert len(n.pubs["/pf/viz/inferred_pose"].msgs) >= 3
    assert len(n.pubs["/pf/viz/particles"].msgs) >= 3
    assert len(n.pubs["/pf/pose/odom"].msgs) >= 4  # every tick
    assert len(b.tf_broadcaster.sent) >= 4
    est = n.pubs["/pf/viz/inferred_pose"].msgs[-1].pose.position
    assert abs(est.x - POSE[0]) < 0.5 and abs(est.y - POSE[1]) < 0.5
    assert len(n.pubs["/pf/viz/particles"].msgs[-1].poses) == 32
    last = n.pubs["/pf/viz/inferred_pose"].msgs[-1]
    assert last.header.frame_id == "map" and last.header.stamp.sec >= 100


def test_clicked_point_triggers_global_reinit(stub_ros, maps, scan):
    b = _make_bridge(maps[1])
    n = b.ros_node
    n.subs[b.config.scan_topic](_scan_msg(stub_ros, scan, BEAMS))
    n.subs["/initialpose"](_initialpose(stub_ros, POSE))
    assert b.node.inferred_pose is not None
    n.subs["/clicked_point"](stub_ros["geometry_msgs.msg"].PointStamped())
    assert b.node.inferred_pose is None  # belief reset, like the reference
    for _ in range(3):
        n.tick(0.02)
    assert np.isfinite(np.asarray(b.node.current_pose(), dtype=float)).all()


def test_map_republish_reuses_cached_grid(stub_ros, maps):
    b = _make_bridge(maps[1])
    n = b.ros_node
    republish = n.timer_with_period(0.2)
    first = n.pubs["/map"].msgs[0]
    n.clock_holder["t"] += 0.2
    republish()
    second = n.pubs["/map"].msgs[1]
    assert second is first  # payload built once, only the stamp refreshed
    assert second.header.stamp.sec >= 100
