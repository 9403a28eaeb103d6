from monte_carlo_localization_tpu_torch.runtime.replay import (
    ReplayResult,
    load_trace,
    replay_chained,
    trace_actions,
)

__all__ = ["ReplayResult", "load_trace", "replay_chained", "trace_actions"]
