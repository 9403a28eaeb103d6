"""rosbag2 (sqlite3 + CDR) interchange for recorded traces, a copy of the
JAX package's ``runtime/rosbag.py`` over the port's :class:`Trace` (the
two write the same bytes and read each other's bags).

The reference's validation workflow is rosbag replay of recorded
``/scan`` + ``/odom`` topics (SURVEY §4; reference README.md:77), while
this engine's golden traces use a compact ``.npz`` schema
(:mod:`~monte_carlo_localization_tpu_torch.runtime.trace`). This module
bridges the two without a ROS installation (no ``rosbags`` or
``rclpy``): a pure-Python rosbag2 sqlite3 reader/writer plus hand-rolled
XCDR1 (little-endian) serializers for exactly the two message types the
reference consumes — ``sensor_msgs/msg/LaserScan`` and
``nav_msgs/msg/Odometry`` (reference src/particle_filter.cpp:286-345).

* :func:`export_bag` — Trace -> a rosbag2 directory (``<name>.db3`` +
  ``metadata.yaml``, humble-compatible schema v3 / metadata v5) that
  ``ros2 bag play`` and rviz tooling accept.
* :func:`import_bag` — a rosbag2 directory (or bare ``.db3``) -> Trace,
  so real recorded F1TENTH bags feed ``cli replay`` directly.

CDR notes: XCDR1 little-endian, 4-byte encapsulation header
``00 01 00 00``; primitive alignment is relative to the start of the
payload AFTER the header; strings carry a trailing NUL inside their
length. Round-trip fidelity is pinned by tests/test_torch_rosbag.py.
"""

from __future__ import annotations

import sqlite3
import struct
from pathlib import Path

import numpy as np

from monte_carlo_localization_tpu_torch.runtime.trace import Trace
from monte_carlo_localization_tpu_torch.utils.geometry import (
    quaternion_to_yaw,
    yaw_to_quaternion,
)

LASERSCAN_TYPE = "sensor_msgs/msg/LaserScan"
ODOMETRY_TYPE = "nav_msgs/msg/Odometry"
_ENCAPSULATION = b"\x00\x01\x00\x00"  # XCDR1 little-endian


# ---------------------------------------------------------------------------
# CDR primitives
# ---------------------------------------------------------------------------


class _CdrWriter:
    def __init__(self):
        self._buf = bytearray()

    def _align(self, n: int) -> None:
        pad = (-len(self._buf)) % n
        self._buf += b"\x00" * pad

    def u32(self, v: int) -> "_CdrWriter":
        self._align(4)
        self._buf += struct.pack("<I", v & 0xFFFFFFFF)
        return self

    def i32(self, v: int) -> "_CdrWriter":
        self._align(4)
        self._buf += struct.pack("<i", int(v))
        return self

    def f32(self, v: float) -> "_CdrWriter":
        self._align(4)
        self._buf += struct.pack("<f", float(v))
        return self

    def f64(self, v: float) -> "_CdrWriter":
        self._align(8)
        self._buf += struct.pack("<d", float(v))
        return self

    def string(self, s: str) -> "_CdrWriter":
        raw = s.encode("utf-8") + b"\x00"
        self.u32(len(raw))
        self._buf += raw
        return self

    def f32_seq(self, a: np.ndarray) -> "_CdrWriter":
        a = np.ascontiguousarray(a, dtype="<f4")
        self.u32(a.shape[0])
        self._buf += a.tobytes()
        return self

    def f64_array(self, a: np.ndarray) -> "_CdrWriter":
        """Fixed-size f64 array (no length prefix — e.g. covariance[36])."""
        self._align(8)
        self._buf += np.ascontiguousarray(a, dtype="<f8").tobytes()
        return self

    def message(self) -> bytes:
        return _ENCAPSULATION + bytes(self._buf)


class _CdrReader:
    def __init__(self, data: bytes):
        if len(data) < 4:
            raise ValueError("CDR message shorter than its header")
        if data[1] not in (0x01, 0x03):  # CDR_LE / PL_CDR_LE
            raise ValueError(
                f"only little-endian CDR supported (header {data[:4]!r})"
            )
        self._d = memoryview(data)[4:]
        self._o = 0

    def _align(self, n: int) -> None:
        self._o += (-self._o) % n

    def u32(self) -> int:
        self._align(4)
        v = struct.unpack_from("<I", self._d, self._o)[0]
        self._o += 4
        return v

    def i32(self) -> int:
        self._align(4)
        v = struct.unpack_from("<i", self._d, self._o)[0]
        self._o += 4
        return v

    def f32(self) -> float:
        self._align(4)
        v = struct.unpack_from("<f", self._d, self._o)[0]
        self._o += 4
        return v

    def f64(self) -> float:
        self._align(8)
        v = struct.unpack_from("<d", self._d, self._o)[0]
        self._o += 8
        return v

    def string(self) -> str:
        n = self.u32()
        raw = bytes(self._d[self._o : self._o + n])
        self._o += n
        return raw.rstrip(b"\x00").decode("utf-8")

    def f32_seq(self) -> np.ndarray:
        n = self.u32()
        a = np.frombuffer(self._d, dtype="<f4", count=n, offset=self._o)
        self._o += 4 * n
        return np.array(a, dtype=np.float32)

    def f64_array(self, n: int) -> np.ndarray:
        self._align(8)
        a = np.frombuffer(self._d, dtype="<f8", count=n, offset=self._o)
        self._o += 8 * n
        return np.array(a)


def _write_header(w: _CdrWriter, t: float, frame_id: str) -> None:
    sec = int(t)
    w.i32(sec).u32(int(round((t - sec) * 1e9)) % 1_000_000_000)
    w.string(frame_id)


def _read_header(r: _CdrReader) -> tuple[float, str]:
    sec = r.i32()
    nsec = r.u32()
    return sec + nsec * 1e-9, r.string()


# ---------------------------------------------------------------------------
# Message codecs
# ---------------------------------------------------------------------------


def encode_laserscan(
    t: float,
    ranges: np.ndarray,
    angle_min: float,
    angle_increment: float,
    range_max: float,
    frame_id: str = "laser",
    scan_time: float = 0.0,
) -> bytes:
    w = _CdrWriter()
    _write_header(w, t, frame_id)
    n = len(ranges)
    w.f32(angle_min)
    w.f32(angle_min + angle_increment * max(n - 1, 0))
    w.f32(angle_increment)
    w.f32(0.0)  # time_increment
    w.f32(scan_time)
    w.f32(0.0)  # range_min
    w.f32(range_max)
    w.f32_seq(ranges)
    w.u32(0)  # empty intensities
    return w.message()


def decode_laserscan(data: bytes) -> dict:
    r = _CdrReader(data)
    t, frame_id = _read_header(r)
    out = dict(t=t, frame_id=frame_id)
    out["angle_min"] = r.f32()
    out["angle_max"] = r.f32()
    out["angle_increment"] = r.f32()
    out["time_increment"] = r.f32()
    out["scan_time"] = r.f32()
    out["range_min"] = r.f32()
    out["range_max"] = r.f32()
    out["ranges"] = r.f32_seq()
    return out


def encode_odometry(
    t: float,
    pose: np.ndarray,
    v: float,
    omega: float,
    frame_id: str = "odom",
    child_frame_id: str = "base_link",
) -> bytes:
    w = _CdrWriter()
    _write_header(w, t, frame_id)
    w.string(child_frame_id)
    w.f64(pose[0]).f64(pose[1]).f64(0.0)  # position
    qx, qy, qz, qw = yaw_to_quaternion(float(pose[2]))
    w.f64(qx).f64(qy).f64(qz).f64(qw)
    w.f64_array(np.zeros(36))  # pose covariance
    w.f64(v).f64(0.0).f64(0.0)  # twist.linear
    w.f64(0.0).f64(0.0).f64(omega)  # twist.angular
    w.f64_array(np.zeros(36))  # twist covariance
    return w.message()


def decode_odometry(data: bytes) -> dict:
    r = _CdrReader(data)
    t, frame_id = _read_header(r)
    child = r.string()
    x, y = r.f64(), r.f64()
    r.f64()  # z
    qx, qy, qz, qw = r.f64(), r.f64(), r.f64(), r.f64()
    r.f64_array(36)
    vx = r.f64()
    r.f64(), r.f64(), r.f64(), r.f64()  # vy vz wx wy
    wz = r.f64()
    return dict(
        t=t,
        frame_id=frame_id,
        child_frame_id=child,
        pose=np.array([x, y, quaternion_to_yaw(qx, qy, qz, qw)]),
        v=vx,
        omega=wz,
    )


# ---------------------------------------------------------------------------
# rosbag2 sqlite3 storage
# ---------------------------------------------------------------------------

_SCHEMA = """
CREATE TABLE schema(
  schema_version INTEGER PRIMARY KEY,
  ros_distro TEXT NOT NULL);
CREATE TABLE metadata(
  id INTEGER PRIMARY KEY,
  metadata_version INTEGER NOT NULL,
  metadata TEXT NOT NULL);
CREATE TABLE topics(
  id INTEGER PRIMARY KEY,
  name TEXT NOT NULL,
  type TEXT NOT NULL,
  serialization_format TEXT NOT NULL,
  offered_qos_profiles TEXT NOT NULL);
CREATE TABLE messages(
  id INTEGER PRIMARY KEY,
  topic_id INTEGER NOT NULL,
  timestamp INTEGER NOT NULL,
  data BLOB NOT NULL);
CREATE INDEX timestamp_idx ON messages (timestamp ASC);
"""


def export_bag(
    trace: Trace,
    out_dir: str | Path,
    scan_topic: str = "/scan",
    odom_topic: str = "/odom",
    truth_topic: str = "/ground_truth",
    range_max: float = 30.0,
) -> Path:
    """Write a trace as a rosbag2 directory. Returns the directory path.

    Layout matches ``ros2 bag record`` output on humble: a directory
    holding ``<name>_0.db3`` (sqlite3 storage, schema v3) and a
    ``metadata.yaml`` (bagfile information v5). Timestamps are the trace's
    relative seconds as nanoseconds-since-epoch, which keeps ``ros2 bag
    play``'s relative pacing intact.
    """
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    db_name = out_dir.name + "_0.db3"
    db_path = out_dir / db_name
    if db_path.exists():
        db_path.unlink()

    inc = (
        float(trace.beam_angles[1] - trace.beam_angles[0])
        if trace.num_beams > 1
        else 0.0
    )
    a0 = float(trace.beam_angles[0])
    scan_dt = (
        float(np.median(np.diff(trace.scan_t)))
        if len(trace.scan_t) > 1
        else 0.0
    )

    con = sqlite3.connect(db_path)
    try:
        con.executescript(_SCHEMA)
        con.execute(
            "INSERT INTO schema(schema_version, ros_distro) VALUES (3, ?)",
            ("humble",),
        )
        topics = [(1, scan_topic, LASERSCAN_TYPE), (2, odom_topic, ODOMETRY_TYPE)]
        if trace.truth_t is not None:
            topics.append((3, truth_topic, ODOMETRY_TYPE))
        for tid, name, typ in topics:
            con.execute(
                "INSERT INTO topics(id, name, type, serialization_format, "
                "offered_qos_profiles) VALUES (?, ?, ?, 'cdr', '')",
                (tid, name, typ),
            )

        rows: list[tuple[int, int, bytes]] = []
        for i, t in enumerate(trace.scan_t):
            rows.append((
                1,
                int(round(float(t) * 1e9)),
                encode_laserscan(
                    float(t), trace.scan_ranges[i], a0, inc, range_max,
                    scan_time=scan_dt,
                ),
            ))
        for i, t in enumerate(trace.odom_t):
            v, om = float(trace.odom_twist[i, 0]), float(trace.odom_twist[i, 1])
            rows.append((
                2,
                int(round(float(t) * 1e9)),
                encode_odometry(float(t), trace.odom_pose[i], v, om),
            ))
        if trace.truth_t is not None:
            for i, t in enumerate(trace.truth_t):
                rows.append((
                    3,
                    int(round(float(t) * 1e9)),
                    encode_odometry(
                        float(t), trace.truth_pose[i], 0.0, 0.0,
                        frame_id="map",
                    ),
                ))
        rows.sort(key=lambda r: r[1])
        con.executemany(
            "INSERT INTO messages(topic_id, timestamp, data) VALUES (?, ?, ?)",
            rows,
        )
        con.commit()

        counts = {tid: 0 for tid, _, _ in topics}
        for tid, _, _ in rows:
            counts[tid] += 1
        t_first = rows[0][1] if rows else 0
        t_last = rows[-1][1] if rows else 0
        _write_metadata_yaml(
            out_dir, db_name, topics, counts, t_first, t_last
        )
    finally:
        con.close()
    return out_dir


def _write_metadata_yaml(out_dir, db_name, topics, counts, t_first, t_last):
    lines = [
        "rosbag2_bagfile_information:",
        "  version: 5",
        "  storage_identifier: sqlite3",
        f"  duration:\n    nanoseconds: {t_last - t_first}",
        f"  starting_time:\n    nanoseconds_since_epoch: {t_first}",
        f"  message_count: {sum(counts.values())}",
        "  topics_with_message_count:",
    ]
    for tid, name, typ in topics:
        lines += [
            "    - topic_metadata:",
            f"        name: {name}",
            f"        type: {typ}",
            "        serialization_format: cdr",
            '        offered_qos_profiles: ""',
            f"      message_count: {counts[tid]}",
        ]
    lines += [
        '  compression_format: ""',
        '  compression_mode: ""',
        "  relative_file_paths:",
        f"    - {db_name}",
        "  files:",
        f"    - path: {db_name}",
        f"      starting_time:\n        nanoseconds_since_epoch: {t_first}",
        f"      duration:\n        nanoseconds: {t_last - t_first}",
        f"      message_count: {sum(counts.values())}",
    ]
    (Path(out_dir) / "metadata.yaml").write_text("\n".join(lines) + "\n")


def _find_db(path: Path) -> Path:
    if path.is_file():
        return path
    dbs = sorted(path.glob("*.db3")) or sorted(path.glob("*.db"))
    if not dbs:
        raise FileNotFoundError(f"no .db3 storage file under {path}")
    return dbs[0]


def import_bag(
    bag: str | Path,
    scan_topic: str | None = None,
    odom_topic: str | None = None,
    truth_topic: str | None = None,
    map_name: str = "",
) -> Trace:
    """Read a rosbag2 directory (or bare .db3) into a Trace.

    Topics default to auto-detection by type: the first LaserScan topic
    becomes the scan stream and the first Odometry topic the odometry
    stream (explicit names override — a bag with several Odometry topics,
    e.g. ground truth, should name them). Odometry twist is taken from the
    message's ``twist`` field, matching what the reference's odomCB
    consumes (reference src/particle_filter.cpp:335-345); timestamps are
    rebased so the trace starts at t=0.
    """
    db = _find_db(Path(bag))
    con = sqlite3.connect(f"file:{db}?mode=ro", uri=True)
    try:
        topics = {
            tid: (name, typ)
            for tid, name, typ in con.execute(
                "SELECT id, name, type FROM topics"
            )
        }
        by_name = {name: (tid, typ) for tid, (name, typ) in topics.items()}

        def pick(want_name, want_type, skip=()):
            if want_name is not None:
                if want_name not in by_name:
                    raise KeyError(
                        f"topic {want_name!r} not in bag "
                        f"(has: {sorted(by_name)})"
                    )
                tid, typ = by_name[want_name]
                if typ != want_type:
                    raise ValueError(
                        f"topic {want_name!r} has type {typ}, need {want_type}"
                    )
                return tid
            for tid, (name, typ) in sorted(topics.items()):
                if typ == want_type and tid not in skip:
                    return tid
            return None

        scan_tid = pick(scan_topic, LASERSCAN_TYPE)
        if scan_tid is None:
            raise ValueError("bag has no LaserScan topic")
        odom_tid = pick(odom_topic, ODOMETRY_TYPE)
        if odom_tid is None:
            raise ValueError("bag has no Odometry topic")
        truth_tid = (
            pick(truth_topic, ODOMETRY_TYPE, skip={odom_tid})
            if (truth_topic is not None or len(
                [1 for _, (n, ty) in topics.items() if ty == ODOMETRY_TYPE]
            ) > 1)
            else None
        )

        scans, odoms, truths = [], [], []
        for tid, ts, data in con.execute(
            "SELECT topic_id, timestamp, data FROM messages ORDER BY timestamp"
        ):
            if tid == scan_tid:
                scans.append((ts, decode_laserscan(bytes(data))))
            elif tid == odom_tid:
                odoms.append((ts, decode_odometry(bytes(data))))
            elif tid == truth_tid:
                truths.append((ts, decode_odometry(bytes(data))))
    finally:
        con.close()

    if not scans:
        raise ValueError("bag contains no LaserScan messages")
    n_beams = {len(m["ranges"]) for _, m in scans}
    if len(n_beams) != 1:
        raise ValueError(f"inconsistent beam counts across scans: {n_beams}")
    t0 = min(ts for ts, _ in (scans + odoms))

    first = scans[0][1]
    beams = (
        first["angle_min"]
        + np.arange(len(first["ranges"])) * first["angle_increment"]
    ).astype(np.float32)
    return Trace(
        odom_t=np.array([(ts - t0) * 1e-9 for ts, _ in odoms]),
        odom_pose=np.stack([m["pose"] for _, m in odoms])
        if odoms
        else np.zeros((0, 3)),
        odom_twist=np.array([[m["v"], m["omega"]] for _, m in odoms])
        if odoms
        else np.zeros((0, 2)),
        scan_t=np.array([(ts - t0) * 1e-9 for ts, _ in scans]),
        scan_ranges=np.stack([m["ranges"] for _, m in scans]).astype(
            np.float32
        ),
        beam_angles=beams,
        truth_t=(
            np.array([(ts - t0) * 1e-9 for ts, _ in truths])
            if truths
            else None
        ),
        truth_pose=(
            np.stack([m["pose"] for _, m in truths]) if truths else None
        ),
        map_name=map_name,
    )
