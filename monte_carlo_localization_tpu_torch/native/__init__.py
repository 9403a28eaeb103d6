"""Host C++/OpenMP builders (EDT, range LUTs) and the reference-exact DDA
ray caster, compiled at first use and loaded with ctypes.

The source is this package's own ``mcl_native.cpp``, a copy of the JAX
package's ``monte_carlo_localization_tpu/native/mcl_native.cpp``, so the
builders agree bit for bit (the parity tests hold the dense and compact
LUTs equal) while the port reads no file of the JAX package. The ``.so``
goes into this package's ``_build/`` directory, keyed by the source
hash. Without a C++ toolchain
the EDT, the dense LUT builder and the ray caster return None and callers
use numpy or torch; the compact builder has no numpy route and its
callers raise.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent / "mcl_native.cpp"
_BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
_NATIVE_VERSION = 4
_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None
_LIB_FAILED = False

_I8P = ctypes.POINTER(ctypes.c_int8)
_U8P = ctypes.POINTER(ctypes.c_uint8)
_U16P = ctypes.POINTER(ctypes.c_uint16)
_I32P = ctypes.POINTER(ctypes.c_int32)
_F32P = ctypes.POINTER(ctypes.c_float)


def _compile(so_path: Path) -> None:
    # per-process tmp name: concurrent first-use builds must not share
    # one, or the first os.replace deletes the other's output mid-write
    tmp = so_path.with_suffix(f".{os.getpid()}-{os.urandom(4).hex()}.so.tmp")
    cmd = [
        "g++", "-O3", "-march=native", "-shared", "-fPIC", "-fopenmp",
        "-std=c++17", str(_SRC), "-o", str(tmp),
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=180)
        os.replace(tmp, so_path)
    finally:
        tmp.unlink(missing_ok=True)


def _bind(lib: ctypes.CDLL) -> None:
    lib.mcl_native_version.restype = ctypes.c_int
    lib.mcl_native_version.argtypes = []
    lib.mcl_edt.restype = None
    lib.mcl_cast_rays.restype = None
    lib.mcl_cast_rays.argtypes = [
        _I8P, ctypes.c_int, ctypes.c_int, ctypes.c_double, ctypes.c_double,
        ctypes.c_double, ctypes.c_int, ctypes.c_double, _F32P, ctypes.c_long,
        _F32P, ctypes.c_int,
    ]
    lib.mcl_edt.argtypes = [_U8P, ctypes.c_int, ctypes.c_int, _F32P]
    for name, outp in (
        ("mcl_build_range_lut", _U8P),
        ("mcl_build_range_lut_u16", _U16P),
    ):
        fn = getattr(lib, name)
        fn.restype = None
        fn.argtypes = [
            _U8P, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, outp,
        ]
    for name, outp in (
        ("mcl_build_compact_range_lut", _U8P),
        ("mcl_build_compact_range_lut_u16", _U16P),
    ):
        fn = getattr(lib, name)
        fn.restype = None
        fn.argtypes = [
            _U8P, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            _I32P, ctypes.c_int, outp,
        ]


def _load() -> ctypes.CDLL | None:
    global _LIB, _LIB_FAILED
    with _LOCK:
        if _LIB is not None or _LIB_FAILED:
            return _LIB
        try:
            tag = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
            _BUILD_DIR.mkdir(parents=True, exist_ok=True)
            so_path = _BUILD_DIR / f"mcl_native_{tag}.so"
            if not so_path.exists():
                _compile(so_path)
            lib = ctypes.CDLL(str(so_path))
        except (OSError, subprocess.SubprocessError):
            _LIB_FAILED = True
            return None
        _bind(lib)
        if lib.mcl_native_version() != _NATIVE_VERSION:
            raise RuntimeError(
                f"{_SRC} reports version {lib.mcl_native_version()}, "
                f"this loader binds version {_NATIVE_VERSION}"
            )
        _LIB = lib
        return _LIB


def available() -> bool:
    return _load() is not None


def native_edt(obstacle: np.ndarray) -> np.ndarray | None:
    """Exact EDT (cells) of a bool mask, or None without the library."""
    lib = _load()
    if lib is None:
        return None
    obstacle = np.ascontiguousarray(obstacle, dtype=np.uint8)
    h, w = obstacle.shape
    out = np.empty((h, w), dtype=np.float32)
    lib.mcl_edt(obstacle.ctypes.data_as(_U8P), h, w, out.ctypes.data_as(_F32P))
    return out


def native_build_range_lut(
    occupied: np.ndarray, t_bins: int, max_range_px: int, dtype=np.uint8
) -> np.ndarray | None:
    """(H, W, T) u8/u16 range LUT by the C++ shear-scan DP, or None."""
    lib = _load()
    if lib is None:
        return None
    occupied = np.ascontiguousarray(occupied, dtype=np.uint8)
    h, w = occupied.shape
    out = np.empty((h, w, t_bins), dtype=dtype)
    u16 = np.dtype(dtype) == np.uint16
    fn = lib.mcl_build_range_lut_u16 if u16 else lib.mcl_build_range_lut
    fn(
        occupied.ctypes.data_as(_U8P), h, w, int(t_bins), int(max_range_px),
        out.ctypes.data_as(_U16P if u16 else _U8P),
    )
    return out


def native_build_compact_range_lut(
    occupied: np.ndarray,
    t_bins: int,
    max_range_px: int,
    row_map: np.ndarray,
    row_stride: int,
    dtype=np.uint8,
) -> np.ndarray | None:
    """Row-compacted padded range LUT, (num_rows, row_stride) u8/u16 with
    row 0 the shared far row, or None without the library. ``row_map`` is
    the (H*W,) int32 cell -> row map of
    :func:`~monte_carlo_localization_tpu_torch.mapping.range_lut_device.compact_row_map`."""
    lib = _load()
    if lib is None:
        return None
    occupied = np.ascontiguousarray(occupied, dtype=np.uint8)
    row_map = np.ascontiguousarray(row_map, dtype=np.int32)
    h, w = occupied.shape
    if row_map.shape != (h * w,):
        raise ValueError(f"row_map shape {row_map.shape} != ({h * w},)")
    num_rows = int(row_map.max()) + 1
    out = np.full((num_rows, row_stride), max_range_px, dtype=dtype)
    u16 = np.dtype(dtype) == np.uint16
    fn = (
        lib.mcl_build_compact_range_lut_u16 if u16
        else lib.mcl_build_compact_range_lut
    )
    fn(
        occupied.ctypes.data_as(_U8P), h, w, int(t_bins), int(max_range_px),
        row_map.ctypes.data_as(_I32P), int(row_stride),
        out.ctypes.data_as(_U16P if u16 else _U8P),
    )
    return out


def native_cast_rays(
    occupancy: np.ndarray,
    origin_x: float,
    origin_y: float,
    resolution: float,
    max_range_px: int,
    max_range_meters: float,
    queries: np.ndarray,
    num_threads: int = 0,
) -> np.ndarray | None:
    """(Q,) float32 reference-exact DDA ranges (meters) of (Q, 3) float32
    queries (x, y, angle) on an int8 occupancy grid, or None without the
    library."""
    lib = _load()
    if lib is None:
        return None
    occupancy = np.ascontiguousarray(occupancy, dtype=np.int8)
    queries = np.ascontiguousarray(queries, dtype=np.float32)
    if occupancy.ndim != 2 or queries.ndim != 2 or queries.shape[1] != 3:
        raise ValueError(
            f"occupancy {occupancy.shape} must be (H, W), queries {queries.shape} (Q, 3)"
        )
    h, w = occupancy.shape
    out = np.empty((queries.shape[0],), dtype=np.float32)
    lib.mcl_cast_rays(
        occupancy.ctypes.data_as(_I8P), h, w, float(origin_x), float(origin_y),
        float(resolution), int(max_range_px), float(max_range_meters),
        queries.ctypes.data_as(_F32P), queries.shape[0],
        out.ctypes.data_as(_F32P), int(num_threads),
    )
    return out
