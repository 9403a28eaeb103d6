from monte_carlo_localization_tpu_torch.ops.lut_query import (
    LUTQuery,
    lut_log_weights_reference,
)
from monte_carlo_localization_tpu_torch.ops.resample import (
    multinomial_resample_indices,
    resample_indices,
    systematic_invert_cdf_window,
    systematic_resample_indices,
)

__all__ = [
    "LUTQuery",
    "lut_log_weights_reference",
    "multinomial_resample_indices",
    "resample_indices",
    "systematic_invert_cdf_window",
    "systematic_resample_indices",
]
