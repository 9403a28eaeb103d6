"""Build and load the port's CUDA kernels: nvcc into a shared library with
a plain C interface, loaded with ctypes.

``csrc/lut_likelihood.cu`` is compiled for Hopper (``sm_90a``) at first
use into this package's ``_build/`` directory, keyed by a hash of the
source and the flags, so a checkout builds it once (a few seconds; a
build against PyTorch's headers would take minutes). No
``--use_fast_math``: the kernel's parity with its plain PyTorch version
relies on IEEE division, ``expf`` and ``logf``. Nothing here runs at
import time; a machine without nvcc fails only when a kernel is launched.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
LUT_LIKELIHOOD_SRC = _PKG / "csrc" / "lut_likelihood.cu"
_BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


@dataclass(frozen=True)
class BuiltLibrary:
    """A loaded kernel library and how it was obtained."""

    lib: ctypes.CDLL
    path: Path
    seconds: float  # nvcc wall time; 0.0 when the .so was already built
    log: str  # nvcc/ptxas output (registers, shared memory, spills)


_LOCK = threading.Lock()
_LOADED: BuiltLibrary | None = None


def nvcc_path() -> str:
    """nvcc from CUDA_HOME / CUDA_PATH, the PATH, or /usr/local/cuda."""
    for env in ("CUDA_HOME", "CUDA_PATH"):
        root = os.environ.get(env)
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME); the CUDA kernels of "
        "monte_carlo_localization_tpu_torch build with nvcc at first use"
    )


def _compile(src: Path, so_path: Path) -> str:
    tmp = so_path.with_suffix(f".{os.getpid()}-{os.urandom(4).hex()}.so.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}) on {src.name}:\n"
                f"{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, so_path)
    finally:
        tmp.unlink(missing_ok=True)
    return proc.stdout + proc.stderr


def _bind(lib: ctypes.CDLL) -> None:
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    for name in ("mcl_lut_loglik_u8", "mcl_lut_loglik_u16"):
        fn = getattr(lib, name)
        fn.restype = i32
        # lut, row_stride, row_map, particles, n, obs_px, offsets, r, base,
        # t_bins, height, width, consts, out, stream
        fn.argtypes = [p, i64, p, p, i64, p, p, i32, i32, i32, i32, i32, p, p, p]
    lib.mcl_cuda_error_string.restype = ctypes.c_char_p
    lib.mcl_cuda_error_string.argtypes = [i32]


def load_library() -> BuiltLibrary:
    """The kernel library, built from the checkout's source if needed.
    Raises when nvcc is missing or the build fails."""
    global _LOADED
    with _LOCK:
        if _LOADED is not None:
            return _LOADED
        src = LUT_LIKELIHOOD_SRC
        tag = hashlib.sha256(
            src.read_bytes() + " ".join(NVCC_FLAGS).encode()
        ).hexdigest()[:16]
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        so_path = _BUILD_DIR / f"lut_likelihood_{tag}.so"
        seconds, log = 0.0, ""
        if not so_path.exists():
            t0 = time.perf_counter()
            log = _compile(src, so_path)
            seconds = time.perf_counter() - t0
        lib = ctypes.CDLL(str(so_path))
        _bind(lib)
        _LOADED = BuiltLibrary(lib, so_path, seconds, log)
        return _LOADED
