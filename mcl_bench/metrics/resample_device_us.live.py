"""Median device µs of the resample and its row gather in a correction,
read from inside the step graph (the program's counter
``device.resample``: timing events at the correction's boundaries,
sampled every few calls), in the live cells."""

from mcl_bench.spans import median_us


def read(run):
    return median_us("device.resample") if run.mode == "live" else None
