"""Build and load the port's CUDA kernels: nvcc into shared libraries with
a plain C interface, loaded with ctypes.

Every ``csrc/*.cu`` is compiled for Hopper (``sm_90a``) at first use into
its own ``.so`` in this package's ``_build/`` directory, one nvcc process
per source, all started together. The libraries are keyed by one hash of
every source, every ``csrc/*.cuh`` header and the flags, so a checkout
builds them once (seconds; a build against PyTorch's headers would take
minutes). No ``--use_fast_math``: the kernels' parity with their plain
PyTorch versions relies on IEEE division, ``expf`` and ``logf``. Nothing
here runs at import time; a machine without nvcc fails only when a kernel
is launched.
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
CSRC = _PKG / "csrc"
_BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


@dataclass(frozen=True)
class BuiltLibrary:
    """The loaded kernel libraries, by source stem, and how they were
    obtained."""

    libs: dict[str, ctypes.CDLL]
    paths: dict[str, Path]
    seconds: float  # wall time of the parallel nvcc runs; 0.0 when built
    log: str  # nvcc/ptxas output per source (registers, shared memory, spills)

    def error_string(self, code: int) -> str:
        return self.libs["lut_likelihood"].mcl_cuda_error_string(code).decode()


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


def _compile_all(jobs: list[tuple[Path, Path]]) -> str:
    """Compile each (source, .so) pair with its own nvcc, all at once.
    Returns the compilers' output, one section per source."""
    nvcc = nvcc_path()
    running = []
    try:
        for src, so_path in jobs:
            tmp = so_path.with_suffix(f".{os.getpid()}-{os.urandom(4).hex()}.so.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            running.append((src, so_path, tmp, proc))
        logs = []
        for src, so_path, tmp, proc in running:
            out, _ = proc.communicate(timeout=600)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}) on {src.name}:\n{out}")
            os.replace(tmp, so_path)
            logs.append(f"== {src.name}\n{out}")
        return "".join(logs)
    finally:
        for _, _, tmp, proc in running:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            tmp.unlink(missing_ok=True)


def _bind(libs: dict[str, ctypes.CDLL]) -> None:
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lut = libs["lut_likelihood"]
    for name in ("mcl_lut_loglik_u8", "mcl_lut_loglik_u16"):
        fn = getattr(lut, name)
        fn.restype = i32
        # lut, row_stride, row_map, row_map_bases, particles, members, npm,
        # member_base, map_of, per_member, origin_x, origin_y, dims,
        # lut_bases, eps, obs_px, offsets, r, base, t_bins, subbin, consts,
        # out, stream
        fn.argtypes = [p, i64, p, p, p, i32, i64, i32, p, i32, p, p, p, p, i32,
                       p, p, i32, i32, i32, i32, p, p, p]
    lut.mcl_cuda_error_string.restype = ctypes.c_char_p
    lut.mcl_cuda_error_string.argtypes = [i32]

    dedup = libs["lut_dedup"]
    for name in ("mcl_lut_dedup_u8", "mcl_lut_dedup_u16"):
        fn = getattr(dedup, name)
        fn.restype = i32
        # lut, row_stride, row_map, particles, n, perm, rank, slot_y0,
        # slots, block, wents, eps, obs_px, offsets, r, base, t_bins,
        # height, width, subbin, consts, out, overflow, stream
        fn.argtypes = [p, i64, p, p, i64, p, p, p, i32, i32, i32, i32, p, p,
                       i32, i32, i32, i32, i32, i32, p, p, p, p]
    dedup.mcl_lut_dedup_max_slots.restype = i32
    dedup.mcl_lut_dedup_max_slots.argtypes = [i32, i32, i32]

    mega = libs["mega_step"]
    for name in ("mcl_mega_step_u8", "mcl_mega_step_u16"):
        fn = getattr(mega, name)
        fn.restype = i32
        # lut, row_stride, particles, log_weights, noise, n, obs, offsets,
        # r, base, t_bins, height, width, consts, scalars, out_particles,
        # out_log_weights, out_sums, workspace, grid, phases, stream
        fn.argtypes = [p, i64, p, p, p, i64, p, p, i32, i32, i32, i32, i32,
                       p, p, p, p, p, p, i32, i32, p]
    for name in ("mcl_mega_grid_size_u8", "mcl_mega_grid_size_u16"):
        fn = getattr(mega, name)
        fn.restype = i32
        fn.argtypes = [i32, ctypes.POINTER(ctypes.c_int)]
    mega.mcl_mega_workspace_bytes.restype = i64
    mega.mcl_mega_workspace_bytes.argtypes = [i64, i32]

    probes = libs["probes"]
    u32, f32 = ctypes.c_uint32, ctypes.c_float
    signatures = {
        # hbm, rows, lanes, y0, slots, out, stream
        "mcl_probe_gather_rows": [p, i32, i32, p, i32, p, p],
        # k0, k1, count, out, bits, stream
        "mcl_probe_philox_normals": [u32, u32, i64, p, p, p],
        # k0, k1, calls, words, stream
        "mcl_probe_curand_philox": [u32, u32, i32, p, p],
        # steps, per_step, a, b, c, add, stage, ticket, out, stream
        "mcl_probe_staged_writes": [i32, i32, f32, f32, f32, f32, p, p, p, p],
        # part, w, g, parts, n, lanes, u0, out_a, out_b, stream
        "mcl_probe_scan_resample": [i32, p, p, p, i32, i32, f32, p, p, p],
    }
    for name, argtypes in signatures.items():
        fn = getattr(probes, name)
        fn.restype = i32
        fn.argtypes = argtypes


def load_library() -> BuiltLibrary:
    """The kernel libraries, built from the checkout's sources if needed.
    Raises when nvcc is missing or a build fails."""
    global _LOADED
    with _LOCK:
        if _LOADED is not None:
            return _LOADED
        sources = sorted(CSRC.glob("*.cu"))
        hashed = sources + sorted(CSRC.glob("*.cuh"))
        digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for f in hashed:
            digest.update(f.name.encode() + b"\0" + f.read_bytes())
        tag = digest.hexdigest()[:16]
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        paths = {src.stem: _BUILD_DIR / f"{src.stem}_{tag}.so" for src in sources}
        jobs = [(src, paths[src.stem]) for src in sources if not paths[src.stem].exists()]
        seconds, log = 0.0, ""
        if jobs:
            t0 = time.perf_counter()
            log = _compile_all(jobs)
            seconds = time.perf_counter() - t0
        libs = {stem: ctypes.CDLL(str(path)) for stem, path in paths.items()}
        _bind(libs)
        _LOADED = BuiltLibrary(libs, paths, seconds, log)
        return _LOADED
