"""Host-side dual-rate odometry tracking, a numpy copy of the JAX
package's ``runtime/tracker.py``.

The reference anchors a dead-reckoned pose to the last MCL correction and
advances it with raw odometry deltas at 100-200 Hz while MCL corrections
arrive at ~6 Hz (reference src/particle_filter.cpp:988-1013, callsites
:325-352, :781-807).

Kept quirks (documented, reference-faithful):
* the odometry delta is applied component-wise in the map frame WITHOUT
  rotating into the reference heading (reference :1004-1013) — correct for
  small inter-correction windows, biased for long ones;
* delay compensation advances the anchor along the inferred heading by
  v * avg_mcl_ms * factor (reference :790-806).

Unlike the reference, whose odomCB writes shared state with no lock, the
tracker is thread-safe via a small mutex.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Callable

import numpy as np

from monte_carlo_localization_tpu_torch.utils.validation import is_pose_valid


@dataclass
class TrackerSnapshot:
    pose: np.ndarray | None  # dead-reckoned pose, None if tracking inactive
    velocity: float
    angular_velocity: float
    last_odom_pose: np.ndarray | None
    last_stamp: float | None


class OdometryTracker:
    """Anchor + delta dead reckoner with delay compensation."""

    def __init__(self, max_pose_range: float = 10000.0):
        self._lock = threading.Lock()
        self.max_pose_range = max_pose_range
        self.active = False
        self.pose_initialized_from_seed = False
        self._odom_pose: np.ndarray | None = None  # dead-reckoned map-frame pose
        self._reference_pose = np.zeros(3)  # map-frame anchor (last correction)
        self._reference_odom = np.zeros(3)  # odom-frame pose at anchor time
        # anchor() ran before any odometry: the delta baseline is taken
        # from the FIRST message instead of the zeroed placeholder
        self._reference_odom_pending = False
        self._last_odom_pose: np.ndarray | None = None
        self._last_stamp: float | None = None
        self.velocity = 0.0
        self.angular_velocity = 0.0

    # --- odometry stream (high rate) — reference odomCB :325-352 ---
    def on_odometry(
        self,
        x: float,
        y: float,
        theta: float,
        velocity: float,
        angular_velocity: float,
        stamp: float | None = None,
    ) -> None:
        with self._lock:
            self.velocity = float(velocity)
            self.angular_velocity = float(angular_velocity)
            current = np.array([x, y, theta], dtype=np.float64)
            if self.active:
                if self._reference_odom_pending:
                    # anchored before any odometry arrived: baseline the
                    # delta at THIS first message (delta = 0), otherwise
                    # the raw odom-frame pose would be applied as an
                    # offset and the published pose would jump
                    self._reference_odom = current.copy()
                    self._reference_odom_pending = False
                # raw additive delta, no frame rotation (reference :1004-1013)
                self._odom_pose = self._reference_pose + (
                    current - self._reference_odom
                )
            self._last_odom_pose = current
            self._last_stamp = stamp

    # --- anchor refresh (after each MCL correction) — reference :781-807 ---
    def anchor(
        self,
        corrected_pose: np.ndarray,
        avg_mcl_ms: float = 0.0,
        delay_compensation_factor: float = 1.5,
        from_seed: bool = False,
    ) -> np.ndarray:
        """Re-anchor at an MCL correction (optionally delay-compensated).

        Returns the compensated pose actually anchored.
        """
        with self._lock:
            pose = np.asarray(corrected_pose, dtype=np.float64).copy()
            if avg_mcl_ms > 0.0:
                delay_s = avg_mcl_ms / 1000.0
                ds = self.velocity * delay_s * delay_compensation_factor
                dth = self.angular_velocity * delay_s * delay_compensation_factor
                pose[0] += ds * np.cos(corrected_pose[2])
                pose[1] += ds * np.sin(corrected_pose[2])
                pose[2] += dth
            self._reference_pose = pose
            if self._last_odom_pose is not None:
                self._reference_odom = self._last_odom_pose.copy()
                self._reference_odom_pending = False
            else:
                self._reference_odom_pending = True
            self._odom_pose = pose.copy()
            if from_seed:
                self.pose_initialized_from_seed = True
            self.active = True
            return pose.copy()

    def deactivate(self) -> None:
        with self._lock:
            self.active = False
            self._odom_pose = None

    def snapshot(self) -> TrackerSnapshot:
        with self._lock:
            return TrackerSnapshot(
                pose=None if self._odom_pose is None else self._odom_pose.copy(),
                velocity=self.velocity,
                angular_velocity=self.angular_velocity,
                last_odom_pose=(
                    None
                    if self._last_odom_pose is None
                    else self._last_odom_pose.copy()
                ),
                last_stamp=self._last_stamp,
            )

    # --- pose priority chain — reference get_current_pose :892-916 ---
    def current_pose(
        self,
        inferred_pose: np.ndarray | None,
        particle_mean: np.ndarray | Callable[[], np.ndarray] | None = None,
    ) -> np.ndarray:
        """Pose priority chain (reference's 4 gated fallbacks + the origin
        default): tracked -> MCL -> particle mean -> last odom -> origin.
        ``particle_mean`` may be a function, called only when the chain
        reaches it (the node's particles live on the card, and reading
        them back waits for every correction in flight)."""
        snap = self.snapshot()
        if (
            self.active
            and snap.pose is not None
            and is_pose_valid(snap.pose, self.max_pose_range)
        ):
            return snap.pose
        if inferred_pose is not None and is_pose_valid(
            inferred_pose, self.max_pose_range
        ):
            return np.asarray(inferred_pose, dtype=np.float64)
        if callable(particle_mean):
            particle_mean = particle_mean()
        if particle_mean is not None and is_pose_valid(
            particle_mean, self.max_pose_range
        ):
            return np.asarray(particle_mean, dtype=np.float64)
        if snap.last_odom_pose is not None and is_pose_valid(
            snap.last_odom_pose, self.max_pose_range
        ):
            return snap.last_odom_pose
        return np.zeros(3)
