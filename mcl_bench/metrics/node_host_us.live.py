"""Median self time, µs, of a live tick's ``MCLNode.update`` (the program's
span ``node.update`` less its children ``filter.step``,
``node.pose_wait`` and ``node.post``): the node's own host work."""

from mcl_bench.spans import median_us


def read(run):
    return median_us("node.update", self_time=True) if run.mode == "live" else None
