"""Device microseconds a correction in the traced segment (the profiler's
device rows summed), in the live cells."""


def read(run):
    prof = run.profile
    if run.mode != "live" or not prof or not prof["corrections"]:
        return None
    return prof["busy_us_sum"] / prof["corrections"]
