from monte_carlo_localization_tpu_torch.runtime.converge import ConvergeResult, converge_global
from monte_carlo_localization_tpu_torch.runtime.replay import (
    ReplayResult,
    load_trace,
    replay_chained,
    trace_actions,
)

__all__ = [
    "ConvergeResult",
    "ReplayResult",
    "converge_global",
    "load_trace",
    "replay_chained",
    "trace_actions",
]
