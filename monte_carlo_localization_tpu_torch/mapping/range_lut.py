"""Angle-quantized precomputed range LUT (host build), as in the JAX
package's ``mapping/range_lut.py``.

For every (cell, theta bin) the LUT holds the range in pixels to the
first obstacle, built by a shear-scan dynamic program (native C++/OpenMP;
without a C++ toolchain the plain sweep of ``range_lut_device``). Rows
may be padded to ``row_stride`` entries with angle-wraparound content
(entry b = bin b % T), the byte layout the fused likelihood reads: every
beam of a particle lies inside its row, so the query needs no modulo per
beam. The layout is the JAX package's, so one
LUT buffer serves both packages.
"""

from __future__ import annotations

import hashlib
import os
from pathlib import Path

import numpy as np
import torch

DEFAULT_THETA_BINS = 1440  # 0.25 deg
_DEFAULT_CACHE = Path(__file__).resolve().parents[1] / "_build" / "lut_cache"


def lut_dtype(max_range_px: int) -> np.dtype:
    """u8 up to 254 px, u16 beyond."""
    if max_range_px <= 254:
        return np.dtype(np.uint8)
    if max_range_px <= 65534:
        return np.dtype(np.uint16)
    raise ValueError(
        f"max_range_px={max_range_px} > 65534 — lower max_range or use a "
        "coarser map"
    )


def build_range_lut(
    occupied: np.ndarray,
    t_bins: int = DEFAULT_THETA_BINS,
    max_range_px: int = 240,
    backend: str = "auto",
    row_stride: int = 0,
) -> np.ndarray:
    """(H, W, row_stride or T) range-in-px LUT, u8 or u16 (max_range_px >
    254). backend: auto | native | plain (the sweep's plain version on
    the CPU, also the fallback of ``auto`` without a C++ toolchain). With
    ``row_stride > t_bins`` the last axis is padded with angle-wraparound
    content."""
    dtype = lut_dtype(max_range_px)
    h, w = occupied.shape
    nbytes = h * w * (row_stride or t_bins) * dtype.itemsize
    max_bytes = int(os.environ.get("MCL_LUT_MAX_BYTES", 16 << 30))
    if nbytes > max_bytes:
        raise ValueError(
            f"range LUT would be {nbytes / 2**30:.1f} GiB "
            f"(H={h}, W={w}, stride={row_stride or t_bins}) > "
            f"{max_bytes / 2**30:.1f} GiB limit; reduce t_bins or set "
            "MCL_LUT_MAX_BYTES"
        )
    if backend not in ("auto", "native", "plain"):
        raise ValueError(f"unknown LUT backend {backend!r} (auto | native | plain)")
    lut = None
    if backend in ("auto", "native"):
        from monte_carlo_localization_tpu_torch.native import (
            native_build_range_lut,
        )

        lut = native_build_range_lut(occupied, t_bins, max_range_px, dtype=dtype)
        if lut is None and backend == "native":
            raise RuntimeError("native LUT builder unavailable (no C++ toolchain)")
    if lut is None:
        from monte_carlo_localization_tpu_torch.mapping.range_lut_device import (
            build_range_lut_device,
        )

        return build_range_lut_device(
            torch.from_numpy(np.array(occupied, dtype=bool)), t_bins, max_range_px, row_stride
        ).numpy()
    if row_stride and row_stride != t_bins:
        if row_stride < t_bins:
            raise ValueError(f"row_stride {row_stride} < t_bins {t_bins}")
        reps = -(-row_stride // t_bins)
        lut = np.ascontiguousarray(
            np.tile(lut.reshape(-1, t_bins), (1, reps))[:, :row_stride]
        ).reshape(*occupied.shape, row_stride)
    return lut


def _cache_key(
    occupied: np.ndarray, t_bins: int, max_range_px: int, row_stride: int = 0
) -> str:
    hsh = hashlib.sha256()
    hsh.update(np.ascontiguousarray(occupied.astype(np.uint8)).tobytes())
    tag = "|u16" if lut_dtype(max_range_px).itemsize == 2 else ""
    hsh.update(
        f"{t_bins}|{max_range_px}|{row_stride or t_bins}|v3{tag}".encode()
    )
    return hsh.hexdigest()[:24]


def cached_range_lut(
    occupied: np.ndarray,
    t_bins: int = DEFAULT_THETA_BINS,
    max_range_px: int = 240,
    cache_dir: str | os.PathLike | None = None,
    backend: str = "auto",
    row_stride: int = 0,
) -> np.ndarray:
    """:func:`build_range_lut` with a per-map on-disk cache (npy,
    mmap-loaded). The cache lives in this package's ``_build/lut_cache``
    unless ``cache_dir`` or ``MCL_LUT_CACHE`` names another directory."""
    cache_dir = Path(cache_dir or os.environ.get("MCL_LUT_CACHE", _DEFAULT_CACHE))
    cache_dir.mkdir(parents=True, exist_ok=True)
    path = cache_dir / (
        f"rlut_{_cache_key(occupied, t_bins, max_range_px, row_stride)}.npy"
    )
    if path.exists():
        return np.load(path, mmap_mode="r")
    lut = build_range_lut(
        occupied, t_bins, max_range_px, backend=backend, row_stride=row_stride
    )
    # per-process tmp name + atomic replace: concurrent builders of one
    # entry each publish their own file
    tmp = path.with_name(
        f"{path.stem}.{os.getpid()}-{os.urandom(4).hex()}.tmp.npy"
    )
    try:
        np.save(tmp, lut)
        os.replace(tmp, path)
    finally:
        tmp.unlink(missing_ok=True)
    return lut
