"""Exact 2D Euclidean distance transform (host, numpy), as in the JAX
package's ``mapping/edt.py``: the native C++ build first, then scipy, then
the pure-numpy Felzenszwalb & Huttenlocher lower-envelope passes."""

from __future__ import annotations

import numpy as np

_INF = 1e20


def _edt_1d(f: np.ndarray) -> np.ndarray:
    """Exact 1-D squared distance transform of sampled function f."""
    n = f.shape[0]
    d = np.empty(n, dtype=np.float64)
    v = np.zeros(n, dtype=np.int64)  # parabola locations of the envelope
    z = np.empty(n + 1, dtype=np.float64)  # boundaries between parabolas
    k = 0
    z[0] = -_INF
    z[1] = _INF
    for q in range(1, n):
        s = ((f[q] + q * q) - (f[v[k]] + v[k] * v[k])) / (2 * q - 2 * v[k])
        while s <= z[k]:
            k -= 1
            s = ((f[q] + q * q) - (f[v[k]] + v[k] * v[k])) / (2 * q - 2 * v[k])
        k += 1
        v[k] = q
        z[k] = s
        z[k + 1] = _INF
    k = 0
    for q in range(n):
        while z[k + 1] < q:
            k += 1
        d[q] = (q - v[k]) ** 2 + f[v[k]]
    return d


def _edt_numpy(obstacle: np.ndarray) -> np.ndarray:
    """Exact EDT (in cells) of a bool obstacle mask, pure numpy."""
    h, w = obstacle.shape
    f = np.where(obstacle, 0.0, _INF)
    for x in range(w):
        f[:, x] = _edt_1d(f[:, x])
    for y in range(h):
        f[y, :] = _edt_1d(f[y, :])
    return np.sqrt(f).astype(np.float32)


def euclidean_distance_transform(
    obstacle: np.ndarray, backend: str = "auto"
) -> np.ndarray:
    """Distance (in cells) from every cell to the nearest True cell.

    backend: "auto" (native C++ -> scipy -> numpy), "native", "scipy",
    "numpy".
    """
    obstacle = np.ascontiguousarray(obstacle.astype(bool))
    if not obstacle.any():
        return np.full(obstacle.shape, np.float32(_INF), dtype=np.float32)

    if backend in ("auto", "native"):
        from monte_carlo_localization_tpu_torch.native import native_edt

        out = native_edt(obstacle)
        if out is not None:
            return out
        if backend == "native":
            raise RuntimeError("native EDT unavailable (no C++ toolchain)")
    if backend in ("auto", "scipy"):
        try:
            from scipy import ndimage
        except ImportError:
            if backend == "scipy":
                raise
        else:
            # scipy measures the distance to the nearest zero: invert
            return ndimage.distance_transform_edt(~obstacle).astype(np.float32)
    return _edt_numpy(obstacle)


def clearance_field(
    occupied: np.ndarray, max_range_px: int, backend: str = "auto"
) -> np.ndarray:
    """EDT with a virtual occupied 1-cell border, clipped to
    ``max_range_px + 1`` (rays stop at the map border)."""
    padded = np.pad(occupied.astype(bool), 1, constant_values=True)
    edt = euclidean_distance_transform(padded, backend=backend)[1:-1, 1:-1]
    return np.minimum(edt, np.float32(max_range_px + 1)).astype(np.float32)
