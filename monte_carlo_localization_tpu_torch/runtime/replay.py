"""Chained trace replay: the throughput path of the JAX package's
``MCLNode.replay_chained`` (``runtime/node.py:744-846``) on the port's
:class:`~monte_carlo_localization_tpu_torch.filter.ParticleFilter`.

A trace is the ``.npz`` layout of ``runtime/trace.py``: timestamped
odometry twists, scans with their beam angles, and optional ground truth.
Actions integrate every odometry twist between consecutive scans, exactly
as the JAX node derives them.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from monte_carlo_localization_tpu_torch.utils.geometry import trajectory_rmse


@dataclass(frozen=True)
class ReplayResult:
    times: np.ndarray  # (K,) scan times
    poses: np.ndarray  # (K, 3) float64 inferred poses
    rmse_xy: float | None
    rmse_theta: float | None
    updates_per_sec: float  # steady chained rate, after the first chunk
    corrections: int


def load_trace(path: str | Path) -> dict[str, np.ndarray]:
    """The arrays of a trace ``.npz`` (``truth_*`` only when recorded)."""
    with np.load(path, allow_pickle=False) as z:
        keys = ["odom_t", "odom_twist", "scan_t", "scan_ranges", "beam_angles"]
        keys += [k for k in ("truth_t", "truth_pose") if k in z.files]
        return {k: z[k] for k in keys}


def trace_actions(odom_t, odom_twist, scan_t) -> np.ndarray:
    """(K, 3) float32 [d_forward, 0, d_theta] per scan: the odometry twists
    integrated between consecutive scans (node.py:780-800)."""
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


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def replay_chained(pf, trace_path: str | Path, chunk: int = 64,
                   seed: int | None = None) -> ReplayResult:
    """Replay a trace through ``pf.step_many``, ``chunk`` corrections per
    call, starting from a cloud at the first ground-truth pose.

    The beam angles are the trace's, downsampled by ``angle_step``, and
    are set on ``pf`` unless it already has that many. The rate counts
    the full chunks after the first (which pays the kernel build and the
    first launches); the tail chunk runs outside the timed window.
    """
    tr = load_trace(trace_path)
    if len(tr["scan_t"]) == 0:
        raise ValueError("trace has no scans")
    if "truth_pose" not in tr:
        raise ValueError("replay_chained initializes at truth_pose[0]; trace has none")
    stride = pf.config.angle_step
    beams = np.asarray(tr["beam_angles"], np.float32)[::stride]
    if pf.beam_angles is None or pf.beam_angles.shape[0] != len(beams):
        pf.set_beam_angles(beams)
    scans = np.ascontiguousarray(tr["scan_ranges"][:, ::stride], dtype=np.float32)
    st = np.asarray(tr["scan_t"], np.float64)
    actions = trace_actions(tr["odom_t"], tr["odom_twist"], st)

    state = pf.init_pose(tr["truth_pose"][0], seed=seed)
    k = len(st)
    full_end = k - (k % chunk)
    pose_chunks = []
    wall0 = time.perf_counter()
    warm_wall = steady_end = None
    for c0 in range(0, full_end, chunk):
        state, p = pf.step_many(state, actions[c0:c0 + chunk], scans[c0:c0 + chunk])
        pose_chunks.append(p)
        if warm_wall is None:
            _sync(pf.device)
            warm_wall = time.perf_counter()
    if pose_chunks:
        _sync(pf.device)
        steady_end = time.perf_counter()
    if full_end < k:
        state, p = pf.step_many(state, actions[full_end:], scans[full_end:])
        pose_chunks.append(p)
    poses = torch.cat(pose_chunks).cpu().numpy().astype(np.float64)
    wall = time.perf_counter() - wall0
    done = full_end - min(chunk, full_end)
    rate = (
        done / max(steady_end - warm_wall, 1e-9) if done > 0
        else k / max(wall, 1e-9)
    )
    rmse_xy = rmse_th = None
    if "truth_t" in tr:
        rmse_xy, rmse_th = trajectory_rmse(st, poses, tr["truth_t"], tr["truth_pose"])
    return ReplayResult(
        times=st, poses=poses, rmse_xy=rmse_xy, rmse_theta=rmse_th,
        updates_per_sec=rate, corrections=k,
    )
