"""Median host µs of ``ParticleFilter.step_many`` from entry to return (the
program's span ``filter.step_many``, a call of a chunk of 64 corrections
but for an episode's tail), in the replay cells."""

from mcl_bench.spans import median_us


def read(run):
    return median_us("filter.step_many") if run.mode == "replay" else None
