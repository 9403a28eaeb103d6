from monte_carlo_localization_tpu_torch.filter.core import (
    MCLState,
    ParticleFilter,
    build_lut_likelihood,
    expected_pose,
    mcl_step,
)
from monte_carlo_localization_tpu_torch.filter.mega import MegaStepper, mega_supported
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
    "MegaStepper",
    "mega_supported",
    "initialize_global",
    "initialize_pose",
]
