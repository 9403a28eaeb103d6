"""Chained trace replay of a given filter: a thin wrapper over
:meth:`MCLNode.replay_chained
<monte_carlo_localization_tpu_torch.runtime.node.MCLNode.replay_chained>`
for callers that hold a :class:`~monte_carlo_localization_tpu_torch.filter.ParticleFilter`
and a trace file."""

from __future__ import annotations

from pathlib import Path

import numpy as np

from monte_carlo_localization_tpu_torch.runtime.node import MCLNode, ReplayResult
from monte_carlo_localization_tpu_torch.runtime.trace import Trace, trace_actions

__all__ = ["ReplayResult", "replay_chained", "trace_actions"]


def replay_chained(pf, trace_path: str | Path, chunk: int = 64,
                   seed: int | None = None) -> ReplayResult:
    """Replay a trace through ``pf.step_many``, ``chunk`` corrections per
    call, starting from ``pf.init_pose`` at the first ground-truth pose
    with ``seed``. The beam angles are the trace's, downsampled by
    ``angle_step``, and are set on ``pf`` unless it already has that
    many."""
    trace = Trace.load(trace_path)
    if len(trace.scan_t) == 0:
        raise ValueError("trace has no scans")
    if trace.truth_pose is None:
        raise ValueError("replay_chained initializes at truth_pose[0]; trace has none")
    node = MCLNode(pf.grid_map, pf.config, particle_filter=pf)
    beams = np.asarray(trace.beam_angles, np.float32)[:: pf.config.angle_step]
    node.lidar_initialized = pf.beam_angles is not None and pf.beam_angles.shape[0] == len(beams)
    node.state = pf.init_pose(trace.truth_pose[0], seed=seed)
    return node.replay_chained(trace, chunk)
