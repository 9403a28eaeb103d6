"""Pose validity checks (reference src/utils.cpp:80-84), a copy of the JAX
package's ``utils/validation.py``."""

from __future__ import annotations

import math
from typing import Sequence


def is_pose_valid(pose: Sequence[float], max_range: float = 10000.0) -> bool:
    """Finite x/y/theta and |x|,|y| < max_range (reference src/utils.cpp:80-84)."""
    x, y, theta = float(pose[0]), float(pose[1]), float(pose[2])
    return (
        math.isfinite(x)
        and math.isfinite(y)
        and math.isfinite(theta)
        and abs(x) < max_range
        and abs(y) < max_range
    )
