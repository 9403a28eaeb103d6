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

Every kernel wrapper calls its library through :func:`launch`, which
passes the device's current stream, turns a CUDA error code into a
``RuntimeError`` and counts the launch in ``utils/timing.py``
:data:`COUNTS`, where a graph's capture records it for the replays.
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

import torch

from monte_carlo_localization_tpu_torch.utils.timing import COUNTS, Count

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
        # table, table_entries, out, stream
        fn.argtypes = [p, i64, p, p, p, i32, i64, i32, p, i32, p, p, p, p, i32,
                       p, p, i32, i32, i32, i32, p, p, i32, p, p]
    lut.mcl_log_norm.restype = i32
    lut.mcl_log_norm.argtypes = [p, i32, p, p, p]  # d_in, count, consts, out, stream
    lut.mcl_subbin_norm.restype = i32
    lut.mcl_subbin_norm.argtypes = [i32, p, p, p]  # count, consts, out, stream
    for name in ("mcl_max_table_entries", "mcl_max_subbin_entries", "mcl_subbin_steps"):
        getattr(lut, name).restype = i32
        getattr(lut, name).argtypes = []
    lut.mcl_cuda_error_string.restype = ctypes.c_char_p
    lut.mcl_cuda_error_string.argtypes = [i32]

    dedup = libs["lut_dedup"]
    dedup.mcl_window_keys.restype = i32
    # particles, n, row_map, row_stride, eps, base, t_bins, height, width,
    # subbin, consts, keys, starts, fracs, overflow, stream
    dedup.mcl_window_keys.argtypes = [p, i64, p, i64, i32, i32, i32, i32, i32, i32,
                                      p, p, p, p, p, p]
    for name in ("mcl_lut_dedup_u8", "mcl_lut_dedup_u16"):
        fn = getattr(dedup, name)
        fn.restype = i32
        # lut, starts, fracs, keys, perm, n, block, slots, slot_ents, eps,
        # obs_px, offsets, r, subbin, consts, table, table_entries, out,
        # overflow, stream
        fn.argtypes = [p, p, p, p, p, i64, i32, i32, i32, i32, p, p, i32, i32, p, p,
                       i32, p, p, p]
    dedup.mcl_lut_dedup_max_slots.restype = i32
    # r, slot_ents, itemsize, table_entries, subbin
    dedup.mcl_lut_dedup_max_slots.argtypes = [i32, i32, i32, i32, i32]

    mega = libs["mega_step"]
    for name in ("mcl_mega_step_u8", "mcl_mega_step_u16"):
        fn = getattr(mega, name)
        fn.restype = i32
        # lut, row_stride, particles, log_weights, noise, n, obs, offsets,
        # r, base, t_bins, height, width, consts, table, table_entries,
        # scalars, out_particles, out_log_weights, out_sums, workspace, grid,
        # chunk, small, phases, stream
        fn.argtypes = [p, i64, p, p, p, i64, p, p, i32, i32, i32, i32, i32,
                       p, p, i32, p, p, p, p, p, i32, i64, i32, i32, p]
    for name in ("mcl_mega_plan_u8", "mcl_mega_plan_u16"):
        fn = getattr(mega, name)
        fn.restype = i32
        # n, r, table_entries, grid, chunk, small
        fn.argtypes = [i64, i32, i32, ctypes.POINTER(ctypes.c_int),
                       ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int)]
    mega.mcl_mega_workspace_bytes.restype = i64
    mega.mcl_mega_workspace_bytes.argtypes = [i64, i32]

    probes = libs["probes"]
    u32, f32 = ctypes.c_uint32, ctypes.c_float
    signatures = {
        # hbm, rows, lanes, y0, slots, out, stream
        "mcl_probe_gather_rows": [p, i32, i32, p, i32, p, p],
        # k0, k1, count, out, bits, stream
        "mcl_probe_philox_normals": [u32, u32, i64, p, p, p],
        # the same two as first ported (the redesign's yardstick)
        "mcl_probe_gather_rows_staged": [p, i32, i32, p, i32, p, p],
        "mcl_probe_philox_normals_pairs": [u32, u32, i64, p, p, p],
        # kernel (0, 1: gather 4-lane or wider rows' chunks; 2: normals),
        # items, shape (grid, threads)
        "mcl_probe_stream_shape": [i32, i64, p],
        # which (0: r, 1: cos), out (2^24 floats), stream
        "mcl_probe_box_muller_terms": [i32, p, p],
        # k0, k1, calls, words, stream
        "mcl_probe_curand_philox": [u32, u32, i32, p, p],
        # steps, per_step, a, b, c, add, out, stream
        "mcl_probe_staged_writes": [i32, i32, f32, f32, f32, f32, p, p],
        # steps, per_step, shape (threads, smem)
        "mcl_probe_staged_shape": [i32, i32, p],
        # part, w, g, parts, n, lanes, u0, out_a, out_b, stream
        "mcl_probe_scan_resample": [i32, p, p, p, i32, i32, f32, p, p, p],
        # part, n, shape (grid, threads, per, smem)
        "mcl_probe_scan_shape": [i32, i32, p],
    }
    for name, argtypes in signatures.items():
        fn = getattr(probes, name)
        fn.restype = i32
        fn.argtypes = argtypes

    resample = libs["resample"]
    resample.mcl_resample_max_row.restype = i32
    resample.mcl_resample_max_row.argtypes = [ctypes.POINTER(ctypes.c_int)]
    resample.mcl_systematic_resample.restype = i32
    # weights, rows, n, u0, u0_stride, m, out, stream
    resample.mcl_systematic_resample.argtypes = [p, i32, i32, p, i32, i32, p, p]

    motion = libs["motion"]
    motion.mcl_motion.restype = i32
    # particles, rows, n_src, m, idx, idx_row, idx_col, action, act_row,
    # act_col, noise, noise_row, noise_col, noise_axis, disp_x, disp_y,
    # disp_th, exact_dt, out, stream
    motion.mcl_motion.argtypes = [p, i64, i64, i64, p, i64, i64, p, i64, i64, p, i64, i64, i64,
                                  ctypes.c_float, ctypes.c_float, ctypes.c_float, i32, p, p]

    sweep = libs["range_lut_sweep"]
    for name in ("mcl_range_lut_sweep_u8", "mcl_range_lut_sweep_u16"):
        fn = getattr(sweep, name)
        fn.restype = i32
        # cells, scratch, rel, step_len, tiles, n_tiles, items, p_len,
        # q_len, b_count, words_log2, lines, forward, skip_row0, sat, maxr,
        # vec_ok, row_stride, row_base, blocks, threads, out, stream
        fn.argtypes = [p, p, p, p, p, i32, i32, i32, i32, i32, i32, i32, i32, i32, i32,
                       ctypes.c_float, i32, i64, i64, i32, i32, p, p]
    sweep.mcl_range_lut_sweep_occupancy.restype = i32
    # itemsize, threads, q_len, words, global_d, blocks (out)
    sweep.mcl_range_lut_sweep_occupancy.argtypes = [i32, i32, i32, i32, i32,
                                                    ctypes.POINTER(ctypes.c_int)]


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


def launch(stem: str, entry: str, device, *args, name: str, count: Count | None = None,
           stream: bool = True) -> None:
    """Call the C entry ``entry`` of the ``stem`` library with ``args`` on
    ``device`` and, with ``stream``, that device's current stream as the
    last argument: a kernel launch, which adds one to the count named
    ``name`` and to the wrapper's own ``count``. Without ``stream`` it is a
    query of the library (a launch plan, a cap), counted nowhere. Raises
    ``RuntimeError`` on a nonzero CUDA error code or a library not built."""
    built = load_library()
    lib = built.libs.get(stem)
    if lib is None:
        raise RuntimeError(f"the {stem} kernel library was not built "
                           f"(built: {sorted(built.libs)})")
    fn = getattr(lib, entry)
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream) if stream else fn(*args)
    if err != 0:
        raise RuntimeError(f"{name} {'launch' if stream else 'query'} failed: CUDA error {err} "
                           f"({built.error_string(err)})")
    if stream:
        COUNTS.add(COUNTS.name(name))
        if count is not None:
            COUNTS.add(count)
