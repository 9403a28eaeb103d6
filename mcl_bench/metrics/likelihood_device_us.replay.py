"""Median device µs of the likelihood phase of a correction
(``lut_loglik_kernel``'s launch; a chunk's scans go to pixels once,
before its first correction), read from inside the step graphs (the
program's counter ``device.likelihood``: timing events at the
correction's boundaries, the first correction of each chunk's graph,
sampled every few calls), in the replay cells."""

from mcl_bench.spans import median_us


def read(run):
    return median_us("device.likelihood") if run.mode == "replay" else None
