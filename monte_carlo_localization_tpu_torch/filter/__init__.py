from monte_carlo_localization_tpu_torch.filter.core import (
    MCLState,
    ParticleFilter,
    build_lut_likelihood,
    expected_pose,
    mcl_step,
)
from monte_carlo_localization_tpu_torch.filter.init import (
    initialize_global,
    initialize_pose,
)

__all__ = [
    "MCLState",
    "ParticleFilter",
    "build_lut_likelihood",
    "expected_pose",
    "mcl_step",
    "initialize_global",
    "initialize_pose",
]
