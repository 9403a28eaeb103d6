"""Device kernels a correction in the traced segment (profiler device
rows, Memcpy and Memset left out), in the replay cells."""


def read(run):
    prof = run.profile
    if run.mode != "replay" or not prof or not prof["corrections"]:
        return None
    return prof["kernels"] / prof["corrections"]
