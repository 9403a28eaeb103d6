from monte_carlo_localization_tpu_torch.ops.lut_query import (
    LUTQuery,
    dedup_plan,
    lut_dedup_reference,
    lut_log_weights_reference,
)
from monte_carlo_localization_tpu_torch.ops.mega_step import MegaStep, mega_step_reference
from monte_carlo_localization_tpu_torch.ops.raycast import cast_rays, cast_rays_dda, cast_rays_sphere
from monte_carlo_localization_tpu_torch.ops.resample import (
    multinomial_resample_indices,
    resample_indices,
    resample_rows,
    systematic_invert_cdf_window,
    systematic_resample_indices,
    systematic_resample_rows,
)

__all__ = [
    "LUTQuery",
    "cast_rays",
    "cast_rays_dda",
    "cast_rays_sphere",
    "dedup_plan",
    "lut_dedup_reference",
    "lut_log_weights_reference",
    "MegaStep",
    "mega_step_reference",
    "multinomial_resample_indices",
    "resample_indices",
    "resample_rows",
    "systematic_invert_cdf_window",
    "systematic_resample_indices",
    "systematic_resample_rows",
]
