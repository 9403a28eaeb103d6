"""Median host µs of ``ParticleFilter.step`` from entry to return (the
program's span ``filter.step``: the graph call, whose parts are the
``graphs.*`` spans under it), in the live cells."""

from mcl_bench.spans import median_us


def read(run):
    return median_us("filter.step") if run.mode == "live" else None
