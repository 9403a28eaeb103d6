"""Corrections completed in the window over the window's seconds (episode
starts, syncs and readbacks included); host clock."""


def read(run):
    return run.window.get("updates_per_s")
