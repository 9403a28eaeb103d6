from monte_carlo_localization_tpu_torch.models.motion import (
    motion_model,
    reconstruct_velocity,
)
from monte_carlo_localization_tpu_torch.models.sensor import (
    SensorModel,
    build_sensor_table,
)

__all__ = [
    "SensorModel",
    "build_sensor_table",
    "motion_model",
    "reconstruct_velocity",
]
