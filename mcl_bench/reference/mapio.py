"""Maps and traces as the reference reads them: a ROS map_server YAML and
image (trinary occupancy, row 0 at the world origin side) and a recorded
trace (odometry, scans, truth)."""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np
import yaml
from PIL import Image

OCCUPIED, FREE, UNKNOWN = 100, 0, -1


@dataclass(frozen=True)
class RefMap:
    occupied: np.ndarray  # (H, W) bool: occupancy > 50
    free_cells: np.ndarray  # (K, 2) int64 (row, col) of free cells, row-major
    resolution: float
    origin_x: float  # float32 values, as the map keeps them
    origin_y: float
    max_range_px: int

    @property
    def shape(self) -> tuple[int, int]:
        return self.occupied.shape


def load_map(yaml_path: str | Path, max_range_m: float) -> RefMap:
    yaml_path = Path(yaml_path)
    meta = yaml.safe_load(yaml_path.read_text())
    with Image.open(yaml_path.parent / meta["image"]) as im:
        img = np.asarray(im.convert("L"), dtype=np.float64)
    p = img / 255.0 if int(meta.get("negate", 0)) else (255.0 - img) / 255.0
    occ = np.full(img.shape, UNKNOWN, np.int8)
    occ[p > float(meta.get("occupied_thresh", 0.65))] = OCCUPIED
    occ[p < float(meta.get("free_thresh", 0.196))] = FREE
    occ = np.flipud(occ)
    rows, cols = np.nonzero(occ == FREE)
    res = float(meta["resolution"])
    origin = meta.get("origin", [0.0, 0.0, 0.0])
    return RefMap(
        occupied=np.ascontiguousarray(occ > 50),
        free_cells=np.stack([rows, cols], axis=1).astype(np.int64),
        resolution=res,
        origin_x=float(np.float32(origin[0])),
        origin_y=float(np.float32(origin[1])),
        max_range_px=int(max_range_m / res),
    )


@dataclass(frozen=True)
class RefTrace:
    odom_t: np.ndarray
    odom_twist: np.ndarray  # (No, 2) [v, omega]
    scan_t: np.ndarray
    scan_ranges: np.ndarray  # (Ns, B) float32, every beam of the lidar
    beam_angles: np.ndarray  # (B,) float32
    truth_t: np.ndarray
    truth_pose: np.ndarray

    @property
    def duration(self) -> float:
        return float(max(self.odom_t[-1], self.scan_t[-1]))


def load_trace(path: str | Path) -> RefTrace:
    with np.load(path, allow_pickle=False) as z:
        return RefTrace(**{k: z[k] for k in RefTrace.__dataclass_fields__})


def scan_actions(trace: RefTrace) -> np.ndarray:
    """(Ns, 3) float32 [d_forward, 0, d_theta] a scan: every odometry twist
    up to the scan integrated (left Riemann sum over the odometry stamps),
    differenced between consecutive scans; the first scan's is what
    accrued up to it."""
    ot = np.asarray(trace.odom_t, np.float64)
    tw = np.asarray(trace.odom_twist, np.float64)
    st = np.asarray(trace.scan_t, np.float64)
    dt = np.diff(ot, prepend=ot[:1])
    s = np.cumsum(tw[:, 0] * dt)
    th = np.cumsum(tw[:, 1] * dt)
    last = np.searchsorted(ot, st, side="right") - 1
    s_at = np.where(last >= 0, s[np.clip(last, 0, None)], 0.0)
    th_at = np.where(last >= 0, th[np.clip(last, 0, None)], 0.0)
    out = np.zeros((len(st), 3))
    out[:, 0] = np.diff(s_at, prepend=0.0)
    out[:, 2] = np.diff(th_at, prepend=0.0)
    return out.astype(np.float32)


def tick_action(trace: RefTrace, t: float, dt: float) -> np.ndarray:
    """The node's action at a timer tick at trace time ``t``, ``dt`` after
    the previous one: the latest odometry twist (v, omega) times dt, or
    zero when the robot stands still."""
    i = int(np.searchsorted(trace.odom_t, t, side="right")) - 1
    v, w = (float(x) for x in trace.odom_twist[i])
    if dt >= 1e-4 and (abs(v) > 1e-4 or abs(w) > 1e-4):
        return np.array([v * dt, 0.0, w * dt])
    return np.zeros(3)


def latest_scan(trace: RefTrace, t: float) -> int:
    return int(np.searchsorted(trace.scan_t, t, side="right")) - 1


def on_map(ref_map: RefMap, particles: np.ndarray) -> int:
    """Particles whose cell (float32 truncating address math) is on the map."""
    p = np.asarray(particles, np.float32)
    res = np.float32(ref_map.resolution)
    gx = ((p[:, 0] - np.float32(ref_map.origin_x)) / res).astype(np.int32)
    gy = ((p[:, 1] - np.float32(ref_map.origin_y)) / res).astype(np.int32)
    h, w = ref_map.shape
    return int(np.sum((gx >= 0) & (gx < w) & (gy >= 0) & (gy < h)))
