"""1 - the device's busy seconds (the union of its operations in the
profiled episode) / the unprofiled wall of the same episode (the same
start seed, so the same corrections and draws; the median of three)."""


def read(run):
    prof = run.profile
    if run.mode != "replay" or not prof or not prof.get("wall_plain_s"):
        return None
    return 1.0 - prof["busy_s"] / prof["wall_plain_s"]
