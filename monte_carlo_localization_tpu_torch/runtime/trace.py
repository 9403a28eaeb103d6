"""Recorded-trace I/O and synthesis, as in the JAX package's
``runtime/trace.py``: a compact ``.npz`` trace of timestamped odometry and
scan streams (plus optional ground truth), a merged-event reader, the
per-scan actions of a chained replay, and a synthesizer that drives a
simulated car through a map with the native DDA oracle (the port's
``cast_rays_dda`` without a C++ toolchain). The same map and seed give the
JAX package's trace bit for bit.

Trace layout (single .npz):
  odom_t (No,), odom_pose (No,3), odom_twist (No,2)         [v, omega]
  scan_t (Ns,), scan_ranges (Ns, B) float32
  beam_angles (B,)
  truth_t (Nt,), truth_pose (Nt,3)                           [optional]
  map_name
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from pathlib import Path
from typing import Iterator

import numpy as np
import torch

from monte_carlo_localization_tpu_torch import native
from monte_carlo_localization_tpu_torch.mapping.grid_map import GridMap
from monte_carlo_localization_tpu_torch.ops.raycast import cast_rays_dda
from monte_carlo_localization_tpu_torch.utils.geometry import normalize_angle


@dataclass
class Trace:
    odom_t: np.ndarray  # (No,)
    odom_pose: np.ndarray  # (No, 3) odom-frame pose
    odom_twist: np.ndarray  # (No, 2) [v, omega]
    scan_t: np.ndarray  # (Ns,)
    scan_ranges: np.ndarray  # (Ns, B)
    beam_angles: np.ndarray  # (B,)
    truth_t: np.ndarray | None = None
    truth_pose: np.ndarray | None = None
    map_name: str = ""

    @property
    def num_beams(self) -> int:
        return self.beam_angles.shape[0]

    @property
    def duration(self) -> float:
        return float(
            max(self.odom_t[-1] if len(self.odom_t) else 0.0,
                self.scan_t[-1] if len(self.scan_t) else 0.0)
        )

    def save(self, path: str | Path) -> Path:
        """Write the trace; returns the ACTUAL path written (np.savez
        appends .npz to suffix-less paths, so `--out foo` lands at
        foo.npz — callers must report/consume the returned path)."""
        path = Path(path)
        if path.suffix != ".npz":
            path = path.with_name(path.name + ".npz")
        arrays = dict(
            odom_t=self.odom_t,
            odom_pose=self.odom_pose,
            odom_twist=self.odom_twist,
            scan_t=self.scan_t,
            scan_ranges=self.scan_ranges,
            beam_angles=self.beam_angles,
            map_name=np.asarray(self.map_name),
        )
        if self.truth_t is not None:
            arrays["truth_t"] = self.truth_t
            arrays["truth_pose"] = self.truth_pose
        np.savez_compressed(path, **arrays)
        return path

    @classmethod
    def load(cls, path: str | Path) -> "Trace":
        with np.load(path, allow_pickle=False) as z:
            return cls(
                odom_t=z["odom_t"],
                odom_pose=z["odom_pose"],
                odom_twist=z["odom_twist"],
                scan_t=z["scan_t"],
                scan_ranges=z["scan_ranges"],
                beam_angles=z["beam_angles"],
                truth_t=z["truth_t"] if "truth_t" in z else None,
                truth_pose=z["truth_pose"] if "truth_pose" in z else None,
                map_name=str(z["map_name"]) if "map_name" in z else "",
            )


@dataclass(order=True)
class TraceEvent:
    t: float
    kind: str = field(compare=False)  # "odom" | "scan"
    index: int = field(compare=False)


class TraceReader:
    """Time-merged event iterator over a trace."""

    def __init__(self, trace: Trace):
        self.trace = trace

    def __iter__(self) -> Iterator[TraceEvent]:
        events = [
            TraceEvent(float(t), "odom", i) for i, t in enumerate(self.trace.odom_t)
        ] + [
            TraceEvent(float(t), "scan", i) for i, t in enumerate(self.trace.scan_t)
        ]
        events.sort()
        return iter(events)


# alias for symmetry with readers; writing is Trace.save
TraceWriter = Trace


def trace_actions(odom_t, odom_twist, scan_t) -> np.ndarray:
    """(K, 3) float32 [d_forward, 0, d_theta] per scan: every odometry
    twist between consecutive scans integrated (the CPU reference
    harness's accumulation), as the JAX node's ``replay_chained`` derives
    its actions (``runtime/node.py:766-789``)."""
    ot = np.asarray(odom_t, np.float64)
    tw = np.asarray(odom_twist, np.float64)
    st = np.asarray(scan_t, np.float64)
    dt_o = np.diff(ot, prepend=ot[:1])
    cum_s = np.cumsum(tw[:, 0] * dt_o)
    cum_th = np.cumsum(tw[:, 1] * dt_o)
    idx = np.searchsorted(ot, st, side="right") - 1
    has = idx >= 0
    s_at = np.where(has, cum_s[np.clip(idx, 0, None)], 0.0)
    th_at = np.where(has, cum_th[np.clip(idx, 0, None)], 0.0)
    return np.stack(
        [np.diff(s_at, prepend=0.0), np.zeros_like(st), np.diff(th_at, prepend=0.0)],
        axis=1,
    ).astype(np.float32)


class HostRaycaster:
    """Host-side batch DDA oracle with the map cached as numpy: the native
    C++/OpenMP caster when it builds, else the port's ``cast_rays_dda`` on
    the CPU. ``occupancy`` replaces the map's grid (the synthesizer's
    driving controller counts unknown cells as walls)."""

    def __init__(self, grid_map: GridMap, occupancy: np.ndarray | None = None):
        self.grid_map = grid_map
        self._occ = np.ascontiguousarray(
            grid_map.occupancy.cpu().numpy() if occupancy is None else occupancy,
            dtype=np.int8,
        )
        self._native = native.available()
        self._cpu_map: GridMap | None = None

    def __call__(self, queries: np.ndarray) -> np.ndarray:
        gm = self.grid_map
        if self._native:
            return native.native_cast_rays(
                self._occ,
                gm.origin_x,
                gm.origin_y,
                gm.resolution,
                gm.max_range_px,
                gm.max_range_meters,
                queries,
            )
        if self._cpu_map is None:
            occ = torch.from_numpy(self._occ)
            self._cpu_map = dataclasses.replace(gm.to("cpu"), occupancy=occ, occupied=occ > 50)
        q = torch.as_tensor(np.asarray(queries, np.float32))
        return cast_rays_dda(self._cpu_map, q).numpy()

    def scan(self, pose: np.ndarray, beams: np.ndarray) -> np.ndarray:
        b = beams.shape[0]
        queries = np.stack(
            [np.full(b, pose[0]), np.full(b, pose[1]), pose[2] + beams], axis=1
        ).astype(np.float32)
        return self(queries)


def synthesize_trace(
    grid_map: GridMap,
    duration_s: float = 20.0,
    odom_hz: float = 100.0,
    scan_hz: float = 25.0,
    num_beams: int = 1080,
    fov_rad: float = 2 * np.pi * 270.0 / 360.0,  # 270° lidar as on F1TENTH
    speed: float = 1.5,
    scan_noise_std: float = 0.01,
    odom_drift_std: tuple[float, float] = (0.003, 0.002),  # per-tick v/omega noise
    start_pose: np.ndarray | None = None,
    seed: int = 0,
) -> Trace:
    """Drive a simulated car through the map and record odom + scans.

    The controller is a simple wall-avoider: it probes three rays ahead and
    steers toward clearance, which produces smooth exploratory laps in any
    map. Ground truth is recorded at odom rate; the odometry stream
    integrates NOISY twists in its own frame, so it drifts like a real one.
    """
    rng = np.random.default_rng(seed)
    beams = (np.linspace(-fov_rad / 2, fov_rad / 2, num_beams)).astype(np.float32)
    probe = np.array([-0.5, -0.25, 0.0, 0.25, 0.5], dtype=np.float32)
    caster = HostRaycaster(grid_map)
    # The DRIVING controller must not wander into UNKNOWN space: rays pass
    # through unknown cells (reference semantics, occupancy > 50 is the
    # only obstacle test), so to the wall-avoider an unknown region looks
    # wide open — and a trace whose truth leaves the mapped free space is
    # unlocalizable by construction (recorded SLAM maps like
    # basement_fixed are mostly unknown). Steering probes and the
    # traversability guard below use a map where unknown counts as an
    # obstacle; the recorded SCANS still come from the real map.
    occ_drive = grid_map.occupancy.cpu().numpy().copy()
    occ_drive[occ_drive < 0] = 100
    drive_caster = HostRaycaster(grid_map, occupancy=occ_drive)
    permissible = grid_map.permissible.cpu().numpy()
    h_cells, w_cells = permissible.shape[-2:]

    if start_pose is None:
        free = grid_map.free_cells[: grid_map.num_free].cpu().numpy()
        clear = grid_map.clearance.cpu().numpy()
        good = free[clear[free[:, 0], free[:, 1]] > 8.0]
        cell = good[rng.integers(0, len(good))] if len(good) else free[
            rng.integers(0, len(free))
        ]
        start_pose = np.array(
            [
                float(cell[1]) * grid_map.resolution + float(grid_map.origin_x),
                float(cell[0]) * grid_map.resolution + float(grid_map.origin_y),
                rng.uniform(0, 2 * np.pi),
            ]
        )

    dt = 1.0 / odom_hz
    steps = int(duration_s * odom_hz)
    scan_every = max(1, int(round(odom_hz / scan_hz)))

    truth = np.empty((steps, 3))
    odom_pose = np.empty((steps, 3))
    odom_twist = np.empty((steps, 2))
    odom_t = np.arange(steps) * dt
    scan_t: list[float] = []
    scans: list[np.ndarray] = []

    pose = np.asarray(start_pose, dtype=np.float64).copy()
    odo = np.zeros(3)  # odometry frame starts at identity
    omega = 0.0

    for i in range(steps):
        # steer toward the most open probe direction
        q = np.stack(
            [
                np.full(probe.shape, pose[0]),
                np.full(probe.shape, pose[1]),
                pose[2] + probe,
            ],
            axis=1,
        ).astype(np.float32)
        pr = drive_caster(q)
        ahead = pr[2]
        best = float(probe[int(np.argmax(pr))])
        v = speed * min(1.0, max(0.2, ahead / 3.0))
        target_omega = 1.8 * best if ahead < 3.0 else 0.6 * best
        omega += 0.25 * (target_omega - omega)

        # traversability guard: never step onto a non-free cell (walls OR
        # unknown) — turn in place toward clearance instead
        nx = pose[0] + v * dt * np.cos(pose[2])
        ny = pose[1] + v * dt * np.sin(pose[2])
        col = int((nx - float(grid_map.origin_x)) / grid_map.resolution)
        row = int((ny - float(grid_map.origin_y)) / grid_map.resolution)
        if not (
            0 <= row < h_cells
            and 0 <= col < w_cells
            and permissible[row, col]
        ):
            v = 0.0
            omega += 0.5 * (1.8 * (best if best != 0.0 else 0.5) - omega)

        # true kinematics
        pose[0] += v * dt * np.cos(pose[2])
        pose[1] += v * dt * np.sin(pose[2])
        pose[2] = normalize_angle(pose[2] + omega * dt)
        truth[i] = pose

        # odometry integrates noisy twist in its own frame
        v_n = v + rng.normal(0, odom_drift_std[0])
        om_n = omega + rng.normal(0, odom_drift_std[1])
        odo[0] += v_n * dt * np.cos(odo[2])
        odo[1] += v_n * dt * np.sin(odo[2])
        odo[2] = normalize_angle(odo[2] + om_n * dt)
        odom_pose[i] = odo
        odom_twist[i] = (v_n, om_n)

        if i % scan_every == 0:
            ranges = caster.scan(pose, beams)
            ranges = ranges + rng.normal(0, scan_noise_std, ranges.shape).astype(
                np.float32
            )
            scans.append(np.maximum(ranges, 0.0).astype(np.float32))
            scan_t.append(i * dt)

    return Trace(
        odom_t=odom_t,
        odom_pose=odom_pose,
        odom_twist=odom_twist,
        scan_t=np.asarray(scan_t),
        scan_ranges=np.stack(scans),
        beam_angles=beams,
        truth_t=odom_t.copy(),
        truth_pose=truth,
        map_name=grid_map.name,
    )
