from monte_carlo_localization_tpu_torch.utils.device import (
    DEFAULT_DEVICE,
    resolve_device,
    upload,
)
from monte_carlo_localization_tpu_torch.utils.graphs import disable_graphs
from monte_carlo_localization_tpu_torch.utils.geometry import (
    apply_vehicle_offset,
    div,
    normalize_angle,
    quaternion_to_yaw,
    trajectory_rmse,
    yaw_to_quaternion,
)
from monte_carlo_localization_tpu_torch.utils.timing import Stopwatch, TimingStats, device_trace
from monte_carlo_localization_tpu_torch.utils.validation import is_pose_valid

__all__ = [
    "DEFAULT_DEVICE",
    "resolve_device",
    "upload",
    "disable_graphs",
    "apply_vehicle_offset",
    "div",
    "normalize_angle",
    "quaternion_to_yaw",
    "trajectory_rmse",
    "yaw_to_quaternion",
    "Stopwatch",
    "TimingStats",
    "device_trace",
    "is_pose_valid",
]
