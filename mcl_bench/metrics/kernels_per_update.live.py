"""Device kernels a correction in the traced segment (profiler device
rows, Memcpy and Memset left out), in the live cells."""


def read(run):
    prof = run.profile
    if run.mode != "live" or not prof or not prof["corrections"]:
        return None
    return prof["kernels"] / prof["corrections"]
