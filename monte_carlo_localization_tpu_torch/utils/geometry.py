"""Geometry helpers: angle wrapping (tensors or numpy) and trajectory RMSE
(numpy), as in the JAX package's ``utils/geometry.py``."""

from __future__ import annotations

import numpy as np
import torch


def normalize_angle(angle):
    """Wrap angle(s) to [-pi, pi] with the branch-free atan2(sin, cos)."""
    if isinstance(angle, torch.Tensor):
        return torch.atan2(torch.sin(angle), torch.cos(angle))
    return np.arctan2(np.sin(angle), np.cos(angle))


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
