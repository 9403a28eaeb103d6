"""Geometry helpers: angle wrapping (tensors or numpy); quaternion <-> yaw,
the lidar -> base_link offset and trajectory RMSE (numpy), as in the JAX
package's ``utils/geometry.py``; and :func:`div`, the port's one way to
divide a tensor by a Python number."""

from __future__ import annotations

import numpy as np
import torch


# 0-d divisors by (value, dtype, device): made once, so a division on the
# card costs no host-to-device copy after the first
_DIVISORS: dict[tuple[float, torch.dtype, torch.device], torch.Tensor] = {}


def div(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` as an IEEE division on every device. CUDA torch divides a
    tensor by a Python number (or a 0-d CPU tensor) as a multiply by its
    reciprocal, which differs from the quotient in the last bit on a
    fifth of float32 inputs; the CPU and the kernels divide. So the
    divisor is a 0-d tensor of ``x``'s result type on ``x``'s device."""
    dtype = torch.result_type(x, c)
    key = (float(c), dtype, x.device)
    d = _DIVISORS.get(key)
    if d is None:
        d = _DIVISORS[key] = torch.tensor(c, dtype=dtype, device=x.device)
    return x / d


def normalize_angle(angle):
    """Wrap angle(s) to [-pi, pi] with the branch-free atan2(sin, cos)."""
    if isinstance(angle, torch.Tensor):
        return torch.atan2(torch.sin(angle), torch.cos(angle))
    return np.arctan2(np.sin(angle), np.cos(angle))


def quaternion_to_yaw(qx: float, qy: float, qz: float, qw: float) -> float:
    """Z-axis rotation extracted from a quaternion (reference src/utils.cpp:26-32)."""
    siny_cosp = 2.0 * (qw * qz + qx * qy)
    cosy_cosp = 1.0 - 2.0 * (qy * qy + qz * qz)
    return float(np.arctan2(siny_cosp, cosy_cosp))


def yaw_to_quaternion(yaw: float) -> tuple[float, float, float, float]:
    """Pure-Z rotation quaternion (x, y, z, w) (reference src/utils.cpp:35-40)."""
    half = 0.5 * yaw
    return (0.0, 0.0, float(np.sin(half)), float(np.cos(half)))


def apply_vehicle_offset(pose, forward_offset: float) -> np.ndarray:
    """lidar -> base_link: move a (3,) pose or (N, 3) poses back by
    ``forward_offset`` along the heading (reference src/utils.cpp:60-70)."""
    pose = np.asarray(pose)
    theta = pose[..., 2]
    out = pose.copy()
    out[..., 0] = pose[..., 0] - forward_offset * np.cos(theta)
    out[..., 1] = pose[..., 1] - forward_offset * np.sin(theta)
    return out


def trajectory_rmse(times, poses, truth_t, truth_pose):
    """Pose RMSE (xy meters, theta rad) against ground truth interpolated
    onto ``times``; the heading error is wrapped through atan2."""
    times = np.asarray(times, np.float64)
    poses = np.asarray(poses, np.float64).reshape(-1, 3)
    tp = np.stack(
        [np.interp(times, truth_t, truth_pose[:, i]) for i in range(3)],
        axis=1,
    )
    err = poses[:, :2] - tp[:, :2]
    rmse_xy = float(np.sqrt((err**2).sum(axis=1).mean()))
    dth = np.arctan2(
        np.sin(poses[:, 2] - tp[:, 2]), np.cos(poses[:, 2] - tp[:, 2])
    )
    return rmse_xy, float(np.sqrt((dth**2).mean()))
