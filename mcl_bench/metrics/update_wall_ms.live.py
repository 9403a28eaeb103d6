"""Median host time of one ``MCLNode.update`` call in the window (the
benchmark's span around each call)."""

import numpy as np


def read(run):
    upd = run.window.get("update_s")
    return None if upd is None else float(np.median(upd) * 1e3)
