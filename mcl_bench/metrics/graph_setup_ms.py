"""Warm-up plus capture milliseconds of every CUDA graph the cell's filter
captured (``Programs.stats()``)."""


def read(run):
    stats = run.graph_stats
    return sum(s["warmup_ms"] + s["capture_ms"] for s in stats) if stats else None
