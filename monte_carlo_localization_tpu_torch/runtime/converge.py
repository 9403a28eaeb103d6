"""Global localization until convergence: the port's counterpart of the
loop of ``bench.py`` ``bench_convergence`` (config #4, the kidnapped-robot
experiment). A uniformly seeded cloud takes chained corrections against
one scan at a fixed pose, ``chunk`` per ``step_many`` call, with one
readback per chunk, until the weighted pose lands within ``tol_m``.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class ConvergeResult:
    updates: int | None  # corrections until within tol_m; None if never
    seconds: float  # wall time of the corrections run, readbacks included
    err_m: float  # xy error of the last pose read back
    poses: np.ndarray  # (U, 3) every correction's pose, U corrections run
    # with the unique-window kernel: the share of blocks with more windows
    # than slots in each chunk's last correction; else empty
    overflow_share: tuple[float, ...]
    state: object  # the filter's MCLState after the last correction


def converge_global(pf, scan_m, truth, *, seed: int, chunk: int = 5,
                    max_updates: int = 80, tol_m: float = 0.5) -> ConvergeResult:
    """Seed ``pf.init_global(seed)`` and repeat ``pf.step_many`` on
    ``chunk`` zero actions and copies of ``scan_m`` (R,) until the xy
    error of the chunk's last pose to ``truth`` (x, y, theta) is below
    ``tol_m`` or ``max_updates`` corrections have run."""
    scans = np.tile(np.asarray(scan_m, np.float32), (chunk, 1))
    actions = np.zeros((chunk, 3), np.float32)
    q = pf.likelihood
    state = pf.init_global(seed=seed)
    blocks = math.ceil(state.num_particles / q.block)
    poses, shares = [], []
    updates, err = None, math.inf
    t0 = time.perf_counter()
    for u in range(chunk, max_updates + 1, chunk):
        state, p = pf.step_many(state, actions, scans)
        p = p.cpu().numpy()  # the chunk's one readback
        poses.append(p)
        if q.dedup_slots > 0:
            shares.append(int(q.last_overflow) / blocks)
        err = float(math.hypot(p[-1, 0] - truth[0], p[-1, 1] - truth[1]))
        if err < tol_m:
            updates = u
            break
    seconds = time.perf_counter() - t0
    return ConvergeResult(updates=updates, seconds=seconds, err_m=err,
                          poses=np.concatenate(poses).astype(np.float64),
                          overflow_share=tuple(shares), state=state)
