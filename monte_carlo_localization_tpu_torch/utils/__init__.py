from monte_carlo_localization_tpu_torch.utils.geometry import (
    normalize_angle,
    trajectory_rmse,
)

__all__ = ["normalize_angle", "trajectory_rmse"]
