"""Fleets of independent filters stepped as one batch, one filter
sharded over processes, and fleets over several processes (the JAX
package's ``parallel/``), over ``torch.distributed``."""

from monte_carlo_localization_tpu_torch.parallel.fleet import (
    FleetFilter,
    FleetState,
    is_batched_map,
    stack_maps,
)
from monte_carlo_localization_tpu_torch.parallel.multihost import (
    MultiHostFleet,
    init_multihost,
    multihost_mesh,
)
from monte_carlo_localization_tpu_torch.parallel.sharded import (
    ShardedParticleFilter,
    ShardedState,
)

__all__ = [
    "FleetFilter",
    "FleetState",
    "is_batched_map",
    "stack_maps",
    "ShardedParticleFilter",
    "ShardedState",
    "MultiHostFleet",
    "init_multihost",
    "multihost_mesh",
]
