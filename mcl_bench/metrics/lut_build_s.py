"""Seconds the map's range LUT took to build on the card (``GridMap.lut_build_s``,
synchronized wall)."""


def read(run):
    return run.lut_build_s
