"""Median device µs of the resample and its row gather in a correction,
read from inside the step graphs (the program's counter
``device.resample``: timing events at the correction's boundaries, the
first correction of each chunk's graph, sampled every few calls), in the
replay cells."""

from mcl_bench.spans import median_us


def read(run):
    return median_us("device.resample") if run.mode == "replay" else None
