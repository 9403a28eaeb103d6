"""95th percentile, over every tick of the window, of the time from the
tick's due time on the open-loop schedule to its pose on the host."""

import numpy as np


def read(run):
    lat = run.window.get("latency_s")
    return None if lat is None else float(np.percentile(lat, 95) * 1e3)
