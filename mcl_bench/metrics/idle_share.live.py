"""1 - device busy a correction (profiler device rows of the traced
segment) / the mean wall of the window's ``update`` spans."""

import numpy as np


def read(run):
    upd, prof = run.window.get("update_s"), run.profile
    if upd is None or not prof or not prof["corrections"]:
        return None
    busy_s = prof["busy_us_sum"] / 1e6 / prof["corrections"]
    return 1.0 - busy_s / float(np.mean(upd))
