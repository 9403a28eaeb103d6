"""Measured CPU baseline: a reference-faithful host MCL harness.

See :mod:`monte_carlo_localization_tpu_torch.baseline.cpu_reference`.
"""

from monte_carlo_localization_tpu_torch.baseline.cpu_reference import (
    CPUReferenceFilter,
    replay_cpu_reference,
    trajectory_rmse,
)

__all__ = ["CPUReferenceFilter", "replay_cpu_reference", "trajectory_rmse"]
