"""Fleets of independent filters stepped as one batch (the JAX package's
``parallel/fleet.py``, without a device mesh)."""

from monte_carlo_localization_tpu_torch.parallel.fleet import (
    FleetFilter,
    FleetState,
    is_batched_map,
    stack_maps,
)

__all__ = ["FleetFilter", "FleetState", "is_batched_map", "stack_maps"]
