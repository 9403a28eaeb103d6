"""The program's own spans and counters, for the per-layer readers that
read them: the median over a name's ring in the port's process-wide
tracer (``monte_carlo_localization_tpu_torch/utils/timing.py`` ``TRACER``,
the last few thousand samples, which the window's outnumber). None where
the program has no tracer or the name no sample."""

from __future__ import annotations


def median_us(name: str, self_time: bool = False) -> float | None:
    """The median duration (or self time) of ``name`` in µs."""
    try:
        from monte_carlo_localization_tpu_torch.utils.timing import TRACER
    except ImportError:
        return None
    s = TRACER.summary().get(name)
    if s is None:
        return None
    return s["self_p50_us" if self_time else "p50_us"]
