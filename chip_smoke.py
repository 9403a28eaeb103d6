#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the port's CUDA kernel from ``csrc/``, holds it against its
plain PyTorch version on the card, replays the config #1 golden trace
through ``ParticleFilter`` and drives the 4000-particle x 1080-beam
Spielberg headline shape. Each phase prints one JSON line with its own
seconds; any failure raises and exits non-zero. The last two lines are
the kernel report and ``{"ok": true, "device": {...}}``. It imports
nothing of JAX and needs no network.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
KERNEL_TOL = 1e-3  # float32, same expressions; FMA contraction and sum order differ
CONFIG1_RMSE_MAX = 0.075  # m, ~1.5x the 0.0486 m the JAX engine records (BENCHES.md)
N_PARTICLES = 4000


def emit(phase: str, t0: float, **fields) -> None:
    print(json.dumps({"phase": phase, "seconds": time.perf_counter() - t0, **fields}), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def headline_beams(num_beams: int) -> np.ndarray:
    inc = 1.5 * np.pi / max(num_beams - 1, 1)
    return (-0.75 * np.pi + np.arange(num_beams) * inc).astype(np.float32)


def cuda_ms(fn, iters: int = 50) -> float:
    """Mean device milliseconds per call, from CUDA events around
    ``iters`` back-to-back calls after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def synthetic_case(rng, beams, max_range_px, compact, n, device):
    """A random wraparound-padded LUT on a 64 x 80 map, particles of
    which some lie off the map, and a scan."""
    import torch

    from monte_carlo_localization_tpu_torch.ops.lut_query import (
        LUTQuery,
        required_row_stride,
        suggest_theta_bins,
    )

    h, w, res, ox, oy = 64, 80, 0.05, -1.0, 0.5
    dtype = np.uint8 if max_range_px <= 254 else np.uint16
    t = suggest_theta_bins(beams)
    stride = required_row_stride(t, beams, np.dtype(dtype).itemsize)
    q = LUTQuery(
        t, beams, height=h, width=w, resolution=res, origin_x=ox, origin_y=oy,
        max_range_px=max_range_px, row_stride=stride, z_hit=0.8, z_short=0.01,
        z_max=0.07, z_rand=0.12, sigma_hit=8.0, inv_squash=1 / 2.2,
        lut_dtype=dtype, device=device,
    )
    n_rows = h * w // 3 + 1 if compact else h * w
    base = rng.integers(0, max_range_px + 1, (n_rows, t)).astype(dtype)
    lut = np.tile(base, (1, -(-stride // t)))[:, :stride].reshape(-1)
    row_map = rng.integers(0, n_rows, h * w).astype(np.int32) if compact else None
    x = rng.uniform(ox - 0.3, ox + w * res + 0.3, n)
    y = rng.uniform(oy - 0.3, oy + h * res + 0.3, n)
    theta = rng.uniform(-2 * math.pi, 2 * math.pi, n)
    parts = np.stack([x, y, theta], 1).astype(np.float32)
    obs = rng.uniform(0, max_range_px * 1.1, len(beams)).astype(np.float32)

    def to(a):
        return None if a is None else torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return q, to(lut), to(parts), to(obs), to(row_map)


def phase_kernel_vs_plain(device) -> dict:
    import torch

    from monte_carlo_localization_tpu_torch.ops.lut_query import lut_log_weights_reference

    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    cases, times = [], {}
    for num_beams in (60, 1080):
        beams = headline_beams(num_beams)
        for max_range_px in (200, 400):
            for compact in (False, True):
                q, lut, parts, obs, row_map = synthetic_case(
                    rng, beams, max_range_px, compact, N_PARTICLES, device
                )
                got = q.launch(lut, parts, obs, row_map)
                torch.cuda.synchronize()
                want = lut_log_weights_reference(q, lut, parts, obs, row_map)
                torch.cuda.synchronize()
                oob = int((want == -1e4).sum())
                err = float((got - want).abs().max())
                check(bool(((got == -1e4) == (want == -1e4)).all()), "off-map particles differ")
                check(0 < oob < N_PARTICLES, "case needs particles on and off the map")
                check(err <= KERNEL_TOL, f"kernel vs plain {err} > {KERNEL_TOL} "
                      f"({num_beams} beams, {max_range_px} px, compact={compact})")
                cases.append(dict(beams=num_beams, lut="u8" if max_range_px <= 254 else "u16",
                                  row_map=compact, off_map=oob, max_abs_err=err))
                if max_range_px == 200 and not compact:
                    times[f"{N_PARTICLES}x{num_beams}"] = dict(
                        kernel_ms=cuda_ms(lambda: q.launch(lut, parts, obs, row_map)),
                        plain_ms=cuda_ms(lambda: lut_log_weights_reference(q, lut, parts, obs, row_map)),
                    )
    emit("kernel_vs_plain", t0, tol=KERNEL_TOL, cases=cases, synthetic_lut_times=times)
    return times


def phase_config1(device) -> dict:
    import torch

    from monte_carlo_localization_tpu_torch import MCLConfig, ParticleFilter, load_map
    from monte_carlo_localization_tpu_torch.runtime import load_trace, replay_chained

    t0 = time.perf_counter()
    trace = REPO / "traces" / "config1_map_1753950572.npz"
    gm = load_map(REPO / "maps" / "map_1753950572.yaml", device=device)
    cfg = MCLConfig(max_particles=N_PARTICLES, angle_step=18)
    pf = ParticleFilter(gm, cfg)
    pf.set_beam_angles(load_trace(trace)["beam_angles"][:: cfg.angle_step])
    t_setup = time.perf_counter() - t0
    pf.likelihood.launch_count = 0
    res = replay_chained(pf, trace, chunk=64)
    launches = pf.likelihood.launch_count
    check(np.isfinite(res.poses).all(), "config #1 replay gave non-finite poses")
    check(launches == res.corrections == 500,
          f"{launches} kernel launches for {res.corrections} corrections (want 500)")
    check(res.rmse_xy <= CONFIG1_RMSE_MAX, f"config #1 RMSE {res.rmse_xy} m > {CONFIG1_RMSE_MAX}")
    emit("config1_replay", t0, setup_s=t_setup, particles=N_PARTICLES,
         beams=int(pf.beam_angles.shape[0]), lut=("compact " if pf.grid_map.lut_row_map is not None else "dense ") + str(pf.grid_map.range_lut.dtype),
         lut_bytes=pf.grid_map.range_lut.numel() * pf.grid_map.range_lut.element_size(),
         corrections=res.corrections, launches=launches, rmse_xy_m=res.rmse_xy,
         rmse_theta_rad=res.rmse_theta, chained_updates_per_s=res.updates_per_sec)
    del pf, gm
    torch.cuda.empty_cache()
    return dict(launches=launches, rmse_xy=res.rmse_xy)


def lut_scan(pf, pose) -> np.ndarray:
    """The scan (meters) the LUT predicts at ``pose``: a synthetic scan
    consistent with the map, read with the query's own address math."""
    import torch

    q, gm = pf.likelihood, pf.grid_map
    p = torch.as_tensor(pose, dtype=torch.float32)
    gx = int(((p[0] - q.origin_x) / q.resolution).to(torch.int32))
    gy = int(((p[1] - q.origin_y) / q.resolution).to(torch.int32))
    cell = gy * q.width + gx
    row = int(gm.lut_row_map[cell]) if gm.lut_row_map is not None else cell
    b0 = (int(torch.round(p[2] * q.bin_scale)) + q.base) % q.t_bins
    idx = row * q.row_stride + b0 + q.beam_offsets.to(torch.int64)
    return (gm.range_lut[idx].float() * gm.resolution).cpu().numpy()


def phase_headline(device) -> dict:
    import torch

    from monte_carlo_localization_tpu_torch import MCLConfig, ParticleFilter, load_map
    from monte_carlo_localization_tpu_torch.ops.lut_query import lut_log_weights_reference

    t0 = time.perf_counter()
    gm = load_map(REPO / "maps" / "Spielberg_map.yaml", device=device)
    t_map = time.perf_counter() - t0
    pf = ParticleFilter(gm, MCLConfig(max_particles=N_PARTICLES))
    beams = headline_beams(1080)
    t1 = time.perf_counter()
    pf.set_beam_angles(beams)  # builds the compact LUT on the host, uploads it
    torch.cuda.synchronize()
    t_lut = time.perf_counter() - t1
    lut, row_map = pf.grid_map.range_lut, pf.grid_map.lut_row_map
    check(row_map is not None, "Spielberg should take the row-compacted LUT")
    lut_bytes = lut.numel() * lut.element_size()
    # the upload alone: the same number of bytes from pageable host memory
    host = torch.ones(lut.numel(), dtype=lut.dtype)
    t2 = time.perf_counter()
    dev_copy = host.to(device)
    torch.cuda.synchronize()
    t_upload = time.perf_counter() - t2
    del host, dev_copy
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)

    free = gm.free_cells[: gm.num_free].float().cpu().numpy()
    row_c, col_c = free.mean(axis=0)
    i = int(np.argmin((free[:, 0] - row_c) ** 2 + (free[:, 1] - col_c) ** 2))
    pose = np.array([free[i, 1] * gm.resolution + gm.origin_x,
                     free[i, 0] * gm.resolution + gm.origin_y, 0.3], np.float32)
    scan = lut_scan(pf, pose).astype(np.float32)
    chain = 50
    actions = np.tile(np.float32([0.05, 0.0, 0.01]), (chain, 1))
    scans = np.tile(scan, (chain, 1))
    state = pf.init_pose(pose, seed=1)
    state, _ = pf.step_many(state, actions[:5], scans[:5])  # warm-up
    torch.cuda.synchronize()

    pf.likelihood.launch_count = 0
    t3 = time.perf_counter()
    state, poses = pf.step_many(state, actions, scans)
    torch.cuda.synchronize()
    t_chain = time.perf_counter() - t3
    step_poses = []
    t4 = time.perf_counter()
    for _ in range(30):
        state, pose_i = pf.step(state, actions[0], scan)
        step_poses.append(pose_i)
    torch.cuda.synchronize()
    t_steps = time.perf_counter() - t4
    launches = pf.likelihood.launch_count
    check(launches == chain + 30, f"{launches} kernel launches for {chain + 30} corrections")
    all_poses = torch.cat([poses, torch.stack(step_poses)]).cpu().numpy()
    check(np.isfinite(all_poses).all(), "headline gave non-finite poses")
    drift = float(np.linalg.norm(all_poses[-1, :2] - pose[:2]))

    # the kernel against the plain version on the real LUT, this step's cloud
    obs_px = pf.sensor.to_pixel_index(torch.as_tensor(scan, device=device)).float()
    parts = state.particles.contiguous()
    got = pf.likelihood.launch(lut, parts, obs_px, row_map)
    want = lut_log_weights_reference(pf.likelihood, lut, parts, obs_px, row_map)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    check(err <= KERNEL_TOL, f"kernel vs plain on the Spielberg LUT: {err} > {KERNEL_TOL}")
    kernel_ms = cuda_ms(lambda: pf.likelihood.launch(lut, parts, obs_px, row_map))
    plain_ms = cuda_ms(lambda: lut_log_weights_reference(pf.likelihood, lut, parts, obs_px, row_map))
    emit("headline_spielberg", t0, particles=N_PARTICLES, beams=1080, lut="compact u8",
         lut_rows=lut.numel() // pf.grid_map.row_stride, row_stride=pf.grid_map.row_stride,
         lut_bytes=lut_bytes, map_load_s=t_map, lut_build_and_upload_s=t_lut,
         lut_upload_only_s=t_upload, launches=launches,
         chained_updates_per_s=chain / t_chain, per_step_updates_per_s=30 / t_steps,
         drift_from_start_m=drift, max_abs_err=err, kernel_ms=kernel_ms, plain_ms=plain_ms,
         peak_device_bytes=torch.cuda.max_memory_allocated(device))
    return dict(launches=launches, max_abs_err=err, kernel_ms=kernel_ms, plain_ms=plain_ms)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    if not (REPO / "monte_carlo_localization_tpu_torch" / "csrc" / "lut_likelihood.cu").exists():
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    t0 = time.perf_counter()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    emit("device", t0, name=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda)

    from monte_carlo_localization_tpu_torch import native
    from monte_carlo_localization_tpu_torch.ops._cuda_build import load_library

    t0 = time.perf_counter()
    built = load_library()
    check(native.available(), "the native C++ LUT builder did not build (g++ with OpenMP)")
    ptxas = [ln.strip() for ln in built.log.splitlines() if "registers" in ln or "smem" in ln]
    emit("build", t0, nvcc_s=built.seconds, so=str(built.path.relative_to(REPO)), ptxas=ptxas)

    kernel_times = phase_kernel_vs_plain(device)
    config1 = phase_config1(device)
    head = phase_headline(device)
    print(json.dumps({"kernels": [{
        "name": "lut_likelihood",
        "route": "cuda",
        "source": "monte_carlo_localization_tpu_torch/csrc/lut_likelihood.cu",
        "replaces": "monte_carlo_localization_tpu/ops/pallas_lut.py:450",
        "launches": head["launches"],
        "max_abs_err": head["max_abs_err"],
        "ms": head["kernel_ms"],
        "plain_ms": head["plain_ms"],
        "config1_launches": config1["launches"],
        "synthetic_times": kernel_times,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
