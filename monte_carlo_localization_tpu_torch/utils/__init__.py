from monte_carlo_localization_tpu_torch.utils.device import (
    DEFAULT_DEVICE,
    resolve_device,
)
from monte_carlo_localization_tpu_torch.utils.geometry import (
    normalize_angle,
    trajectory_rmse,
)

__all__ = ["DEFAULT_DEVICE", "resolve_device", "normalize_angle", "trajectory_rmse"]
