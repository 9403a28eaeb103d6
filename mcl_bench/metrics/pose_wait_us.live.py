"""Median µs a live tick's ``MCLNode.update`` waits for its pose to come
back from the card (the program's span ``node.pose_wait``)."""

from mcl_bench.spans import median_us


def read(run):
    return median_us("node.pose_wait") if run.mode == "live" else None
