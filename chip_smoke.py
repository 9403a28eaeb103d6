#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``csrc/`` (one nvcc per source,
in parallel), holds each against its plain PyTorch version on the card,
replays the config #1 golden trace through ``ParticleFilter`` on the
classic step and on the mega step (``pallas_mega``), drives the mega step
at 4000 x 1080 on the same map, and drives the 4000-particle x 1080-beam
Spielberg headline shape. Each phase prints one JSON line with its own
seconds; any failure raises and exits non-zero. The last two lines are
the kernel report and ``{"ok": true, "device": {...}}``. It imports
nothing of JAX and needs no network.

Kernel times are device times from ``torch.profiler`` (``device_ms``);
``wrapper_ms`` times back-to-back Python calls of a wrapper with CUDA
events, which is host-bound where the kernel is shorter than the
wrapper's host work. Bounds use the H100 SXM's published peaks.
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
MEGA_ROW_TOL = 1e-5  # proposal rows compared within this
MEGA_ROWS_MIN = 0.99  # share of rows that must agree (knife-edge ancestors)
MEGA_SUMS_RTOL = 1e-4
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
F32_OPS_PER_S = 67e12
F64_OPS_PER_S = 34e12
# float32 operations per beam term, counted from csrc/beam_model.cuh
# beam_logp + two erf_as (each add, multiply, compare, select, division
# and transcendental as one); the beam sum adds one double add per term
OPS_PER_BEAM = 80
OPS_PER_PARTICLE_K1 = 12  # address: 2 sub, 2 div, casts, compares, rint, fix-ups
OPS_PER_PARTICLE_K6 = 60  # + motion (sin/cos, chord, noise, wrap) and moments


def emit(phase: str, t0: float, **fields) -> None:
    print(json.dumps({"phase": phase, "seconds": time.perf_counter() - t0, **fields}), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def headline_beams(num_beams: int) -> np.ndarray:
    inc = 1.5 * np.pi / max(num_beams - 1, 1)
    return (-0.75 * np.pi + np.arange(num_beams) * inc).astype(np.float32)


def cuda_ms(fn, iters: int = 50) -> float:
    """Wrapper milliseconds per call (host-bound at small shapes): CUDA
    events around ``iters`` back-to-back Python calls after one warm-up
    call."""
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


def _self_device_us(avg) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(avg, name, None)
        if v is not None:
            return float(v)
    return 0.0


def profile_run(fn, iters: int):
    """Run ``fn`` ``iters`` times under torch.profiler (CPU + CUDA). Returns
    ({name: (device us, count)} over the device-side events, host wall
    seconds). CPU operator rows also carry their kernels' device time, so
    only rows of device type CUDA are kept."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = {}
    for avg in prof.key_averages():
        us = _self_device_us(avg)
        if avg.device_type == torch.autograd.DeviceType.CUDA and us > 0:
            rows[avg.key] = (us, avg.count)
    return rows, wall


def graph_ms(fn, iters: int = 50) -> float:
    """Device milliseconds per call from a CUDA graph of ``iters`` calls,
    replayed between CUDA events (no host work inside the timed span)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, kernel: str, iters: int = 20) -> dict:
    """A kernel's own device milliseconds per launch: the profiler's
    device time summed over events whose name holds ``kernel``, divided
    by their count; where the profiler shows none, a CUDA graph of
    ``iters`` calls timed with events."""
    rows, _ = profile_run(fn, iters)
    hits = [(us, n) for key, (us, n) in rows.items() if kernel in key]
    if hits:
        return dict(ms=sum(us for us, _ in hits) / 1e3 / sum(n for _, n in hits), source="profiler")
    return dict(ms=graph_ms(fn, iters), source="cuda_graph")


def chain_profile(run, steps: int) -> dict:
    """Device kernels per correction and the device's idle share over a
    profiled run of ``steps`` corrections (``run()`` does them all). The
    idle share is taken against the profiled wall time and against the
    unprofiled wall time of the same run."""
    import torch

    rows, wall = profile_run(run, 1)
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    wall_plain = time.perf_counter() - t0
    busy_us = sum(us for us, _ in rows.values())
    copies = sum(n for key, (_, n) in rows.items() if key.startswith(("Memcpy", "Memset")))
    launches = sum(n for _, n in rows.values()) - copies
    top = sorted(rows.items(), key=lambda kv: -kv[1][0])[:6]
    return dict(
        device_kernels_per_correction=launches / steps,
        copies_and_sets_per_correction=copies / steps,
        device_busy_ms_per_correction=busy_us / 1e3 / steps,
        profiled_wall_ms_per_correction=wall * 1e3 / steps,
        wall_ms_per_correction=wall_plain * 1e3 / steps,
        idle_share_profiled=1.0 - busy_us / 1e6 / wall,
        idle_share=1.0 - busy_us / 1e6 / wall_plain,
        top_us_per_correction={k[:60]: us / steps for k, (us, _) in top},
    )


def bound(bytes_moved: float, f32_ops: float, f64_ops: float) -> dict:
    """Least time on an H100 SXM: the larger of bytes over HBM bandwidth
    and operations over the peak rates of their types."""
    mem = bytes_moved / HBM_BYTES_PER_S * 1e3
    ops = (f32_ops / F32_OPS_PER_S + f64_ops / F64_OPS_PER_S) * 1e3
    return dict(bound_ms=max(mem, ops), bound_by="bytes" if mem >= ops else "operations",
                bytes=bytes_moved, f32_ops=f32_ops, f64_ops=f64_ops)


def lut_bound(n: int, n_on: int, r: int, itemsize: int, row_map: bool) -> dict:
    """K1/K2: particles in, log weights out, obs + offsets, one LUT entry
    per beam of each on-map particle (and its row_map entry)."""
    b = 12 * n + 4 * n + 8 * r + n_on * (r * itemsize + (4 if row_map else 0))
    return bound(b, n * OPS_PER_PARTICLE_K1 + n_on * r * OPS_PER_BEAM, n_on * r)


def mega_bound(n: int, n_on: int, r: int, itemsize: int) -> dict:
    """K6: particles, log weights and noise in; proposal, log weights and
    sums out; obs, offsets, scalars; one LUT entry per beam of each on-map
    proposal."""
    b = (12 + 4 + 12) * n + (12 + 4) * n + 8 * r + 64 + n_on * r * itemsize
    f64 = n_on * r + 7 * n  # beam sums, the CDF and the moment sums
    return bound(b, n * (OPS_PER_PARTICLE_K6 + 2 * math.ceil(math.log2(n))) + n_on * r * OPS_PER_BEAM, f64)


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
                        **dict(zip(("device_ms", "time_source"), device_ms(
                            lambda: q.launch(lut, parts, obs, row_map), "lut_loglik_kernel").values())),
                        wrapper_ms=cuda_ms(lambda: q.launch(lut, parts, obs, row_map)),
                        plain_ms=cuda_ms(lambda: lut_log_weights_reference(q, lut, parts, obs, row_map)),
                        **lut_bound(N_PARTICLES, N_PARTICLES - oob, num_beams, 1, False),
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
    return dict(launches=launches, rmse_xy=res.rmse_xy, rate=res.updates_per_sec)


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
    n_on = int((want != -1e4).sum())
    dev = device_ms(lambda: pf.likelihood.launch(lut, parts, obs_px, row_map), "lut_loglik_kernel")
    kernel_ms = dev["ms"]
    wrapper_ms = cuda_ms(lambda: pf.likelihood.launch(lut, parts, obs_px, row_map))
    plain_ms = cuda_ms(lambda: lut_log_weights_reference(pf.likelihood, lut, parts, obs_px, row_map))
    bnd = lut_bound(N_PARTICLES, n_on, 1080, 1, True)
    emit("headline_spielberg", t0, particles=N_PARTICLES, beams=1080, lut="compact u8",
         lut_rows=lut.numel() // pf.grid_map.row_stride, row_stride=pf.grid_map.row_stride,
         lut_bytes=lut_bytes, map_load_s=t_map, lut_build_and_upload_s=t_lut,
         lut_upload_only_s=t_upload, launches=launches,
         chained_updates_per_s=chain / t_chain, per_step_updates_per_s=30 / t_steps,
         drift_from_start_m=drift, max_abs_err=err, kernel_device_ms=kernel_ms,
         kernel_time_source=dev["source"], wrapper_ms=wrapper_ms, plain_ms=plain_ms, **bnd,
         peak_device_bytes=torch.cuda.max_memory_allocated(device))
    return dict(launches=launches, max_abs_err=err, ms=kernel_ms, wrapper_ms=wrapper_ms,
                plain_ms=plain_ms, bound_ms=bnd["bound_ms"], bound_by=bnd["bound_by"])


MOTIONS = {"straight": [0.05, 0.0, 1.0, 0.37], "arc": [0.04, 0.03, 0.0, 0.81]}


def mega_case(rng, beams, max_range_px, n, device):
    """A MegaStep on a random dense LUT of a 64 x 80 map, particles of
    which some lie off the map, log weights ~ N(0, 3), noise and a scan."""
    import torch

    from monte_carlo_localization_tpu_torch.ops.mega_step import MegaStep
    from monte_carlo_localization_tpu_torch.ops.lut_query import (
        required_row_stride,
        suggest_theta_bins,
    )

    h, w, res, ox, oy = 64, 80, 0.05, -1.0, 0.5
    dtype = np.uint8 if max_range_px <= 254 else np.uint16
    t = suggest_theta_bins(beams)
    stride = required_row_stride(t, beams, np.dtype(dtype).itemsize)
    step = MegaStep(
        t, beams, height=h, width=w, resolution=res, origin_x=ox, origin_y=oy,
        max_range_px=max_range_px, row_stride=stride, z_hit=0.8, z_short=0.01,
        z_max=0.07, z_rand=0.12, sigma_hit=8.0, inv_squash=1 / 2.2,
        lut_dtype=dtype, device=device,
    )
    base = rng.integers(0, max_range_px + 1, (h * w, t)).astype(dtype)
    lut = np.tile(base, (1, -(-stride // t)))[:, :stride].reshape(-1)
    parts = np.stack([rng.uniform(ox - 0.3, ox + w * res + 0.3, n),
                      rng.uniform(oy - 0.3, oy + h * res + 0.3, n),
                      rng.uniform(-math.pi, math.pi, n)], 1).astype(np.float32)
    logw = rng.normal(0.0, 3.0, n).astype(np.float32)
    noise = rng.normal(size=(n, 3)).astype(np.float32)
    obs = np.minimum(rng.uniform(0, max_range_px * 1.1, len(beams)), max_range_px).astype(np.float32)

    def to(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return step, to(lut), to(parts), to(logw), to(noise), to(obs)


def mega_compare(step, lut, parts, logw, noise, obs, scalars, what: str) -> dict:
    """One kernel launch against the plain version on the same inputs;
    raises on a gate. Returns the errors and the outputs' sizes."""
    import torch

    from monte_carlo_localization_tpu_torch.ops.mega_step import mega_step_reference

    out_p, out_w = torch.empty_like(parts), torch.empty_like(logw)
    sums = torch.empty(8, dtype=torch.float32, device=parts.device)
    step.launch(lut, parts, logw, noise, obs, scalars, out_p, out_w, sums)
    torch.cuda.synchronize()
    want_p, want_w, want_s = mega_step_reference(step, lut, parts, logw, noise, obs, scalars)
    torch.cuda.synchronize()
    n = parts.shape[0]
    rows = (out_p - want_p).abs().le(MEGA_ROW_TOL).all(dim=1)
    n_rows = int(rows.sum())
    lw_err = float((out_w - want_w)[rows].abs().max())
    sums_rel = float(((sums[:5] - want_s[:5]).abs() / want_s[:5].abs().clamp(min=1e-30)).max())
    mx_err = abs(float(sums[5] - want_s[5]))
    off = int(((want_w + want_s[5]) < -9999.0).sum())
    check(n_rows >= MEGA_ROWS_MIN * n, f"{what}: {n_rows} of {n} proposal rows agree")
    check(lw_err <= KERNEL_TOL, f"{what}: log weights differ by {lw_err} > {KERNEL_TOL}")
    check(sums_rel <= MEGA_SUMS_RTOL, f"{what}: moment sums differ by relative {sums_rel}")
    check(mx_err <= KERNEL_TOL, f"{what}: max log weight differs by {mx_err}")
    check(bool(torch.isfinite(sums[:6]).all()), f"{what}: non-finite sums")
    return dict(rows_equal=n_rows, rows=n, max_abs_err=lw_err, sums_rel_err=sums_rel,
                max_err=mx_err, off_map=off)


def mega_times(step, lut, parts, logw, noise, obs, scalars, n_on: int) -> dict:
    """Device time of the kernel (and of each debug_phases part), wrapper
    time, plain time and the bound, on these inputs."""
    import torch

    from monte_carlo_localization_tpu_torch.ops.mega_step import mega_step_reference

    out_p, out_w = torch.empty_like(parts), torch.empty_like(logw)
    sums = torch.empty(8, dtype=torch.float32, device=parts.device)

    def launch(phases="all"):
        return lambda: step.launch(lut, parts, logw, noise, obs, scalars, out_p, out_w, sums,
                                   debug_phases=phases)

    dev = device_ms(launch(), "mega_step_kernel")
    phases = {ph: device_ms(launch(ph), "mega_step_kernel")["ms"] for ph in ("pro_only", "no_epi")}
    n, r = parts.shape[0], obs.shape[0]
    return dict(
        device_ms=dev["ms"], time_source=dev["source"], phase_device_ms=phases,
        wrapper_ms=cuda_ms(launch()),
        plain_ms=cuda_ms(lambda: mega_step_reference(step, lut, parts, logw, noise, obs, scalars)),
        grid_blocks=step.grid_blocks(),
        **mega_bound(n, n_on, r, lut.element_size()),
    )


def phase_mega_vs_plain(device) -> dict:
    import torch

    t0 = time.perf_counter()
    rng = np.random.default_rng(2)
    cases, times = [], {}
    for num_beams in (60, 1080):
        beams = headline_beams(num_beams)
        for max_range_px in (200, 400):
            for motion, sc in MOTIONS.items():
                step, lut, parts, logw, noise, obs = mega_case(rng, beams, max_range_px, N_PARTICLES, device)
                scalars = torch.tensor(sc + [0.0] * 4, dtype=torch.float32, device=device)
                what = f"mega {num_beams} beams, {max_range_px} px, {motion}"
                res = mega_compare(step, lut, parts, logw, noise, obs, scalars, what)
                check(0 < res["off_map"] < N_PARTICLES, f"{what}: case needs rows on and off the map")
                cases.append(dict(beams=num_beams, lut="u8" if max_range_px <= 254 else "u16",
                                  motion=motion, **res))
                if max_range_px == 200 and motion == "arc":
                    times[f"{N_PARTICLES}x{num_beams}"] = mega_times(
                        step, lut, parts, logw, noise, obs, scalars, N_PARTICLES - res["off_map"])
    emit("mega_vs_plain", t0, row_tol=MEGA_ROW_TOL, rows_min=MEGA_ROWS_MIN, lw_tol=KERNEL_TOL,
         sums_rtol=MEGA_SUMS_RTOL, cases=cases, synthetic_lut_times=times)
    return dict(max_abs_err=max(c["max_abs_err"] for c in cases), times=times)


def trace_inputs(pf, trace):
    from monte_carlo_localization_tpu_torch.runtime import load_trace, trace_actions

    tr = load_trace(trace)
    stride = pf.config.angle_step
    scans = np.ascontiguousarray(tr["scan_ranges"][:, ::stride], dtype=np.float32)
    actions = trace_actions(tr["odom_t"], tr["odom_twist"], tr["scan_t"])
    return tr, actions, scans


def phase_config1_mega(device, classic_rate: float) -> dict:
    import torch

    from monte_carlo_localization_tpu_torch import MCLConfig, ParticleFilter, load_map
    from monte_carlo_localization_tpu_torch.runtime import replay_chained

    t0 = time.perf_counter()
    trace = REPO / "traces" / "config1_map_1753950572.npz"
    gm = load_map(REPO / "maps" / "map_1753950572.yaml", device=device)
    cfg = MCLConfig(max_particles=N_PARTICLES, angle_step=18, pallas_mega=True)
    pf = ParticleFilter(gm, cfg)
    tr, actions, scans = trace_inputs(pf, trace)
    pf.set_beam_angles(tr["beam_angles"][:: cfg.angle_step])
    check(pf.mega is not None and pf.grid_map.lut_row_map is None, "config #1 should take the mega step")
    t_setup = time.perf_counter() - t0
    mega, query = pf.mega.mega, pf.likelihood
    mega.launch_count = query.launch_count = 0
    res = replay_chained(pf, trace, chunk=64)
    mega_launches, lut_launches = mega.launch_count, query.launch_count
    check(np.isfinite(res.poses).all(), "config #1 mega replay gave non-finite poses")
    check(mega_launches == res.corrections == 500,
          f"{mega_launches} mega launches for {res.corrections} corrections (want 500)")
    check(lut_launches == 0, f"the mega replay launched the LUT kernel {lut_launches} times")
    check(res.rmse_xy <= CONFIG1_RMSE_MAX, f"config #1 mega RMSE {res.rmse_xy} m > {CONFIG1_RMSE_MAX}")

    # the kernel against its plain version at this path's shape, on the real LUT
    state = pf.init_pose(tr["truth_pose"][0], seed=2)
    state, _ = pf.step_many(state, actions[:8], scans[:8])
    obs = torch.clamp(pf.sensor.to_pixel_index(torch.as_tensor(scans[8], device=device)).float(),
                      max=float(gm.max_range_px))
    noise = torch.randn((N_PARTICLES, 3), generator=state.generator, device=device)
    scalars = torch.tensor([0.05, 0.01, 0.0, 0.5, 0, 0, 0, 0], dtype=torch.float32, device=device)
    args = (pf.grid_map.range_lut, state.particles, state.log_weights, noise, obs, scalars)
    cmp = mega_compare(mega, *args, "mega on the config #1 LUT")
    times = mega_times(mega, *args, N_PARTICLES - cmp["off_map"])

    # kernels per correction and idle share, mega and classic, 20 chained steps
    pf_c = ParticleFilter(pf.grid_map, MCLConfig(max_particles=N_PARTICLES, angle_step=18))
    pf_c.set_beam_angles(tr["beam_angles"][:: cfg.angle_step])
    s0 = pf.init_pose(tr["truth_pose"][0], seed=3)
    prof = {name: chain_profile(lambda f=f: f.step_many(s0, actions[:20], scans[:20]), 20)
            for name, f in (("mega", pf), ("classic", pf_c))}
    emit("config1_mega", t0, setup_s=t_setup, particles=N_PARTICLES, beams=int(pf.beam_angles.shape[0]),
         corrections=res.corrections, mega_launches=mega_launches, lut_launches=lut_launches,
         rmse_xy_m=res.rmse_xy, rmse_theta_rad=res.rmse_theta,
         chained_updates_per_s=res.updates_per_sec, classic_chained_updates_per_s=classic_rate,
         kernel_vs_plain=cmp, kernel_times=times, profile_20_steps=prof)
    del pf, pf_c, gm
    torch.cuda.empty_cache()
    return dict(launches=mega_launches, max_abs_err=cmp["max_abs_err"], **times)


def phase_mega_full_window(device) -> dict:
    import torch

    from monte_carlo_localization_tpu_torch import MCLConfig, ParticleFilter, load_map

    t0 = time.perf_counter()
    gm = load_map(REPO / "maps" / "map_1753950572.yaml", device=device)
    beams = headline_beams(1080)
    pf = ParticleFilter(gm, MCLConfig(max_particles=N_PARTICLES, pallas_mega=True))
    pf.set_beam_angles(beams)
    check(pf.grid_map.lut_row_map is None, "map_1753950572 at 1080 beams should take the dense LUT")
    pf_c = ParticleFilter(pf.grid_map, MCLConfig(max_particles=N_PARTICLES))
    pf_c.set_beam_angles(beams)
    free = gm.free_cells[: gm.num_free].float().cpu().numpy()
    row_c, col_c = free.mean(axis=0)
    i = int(np.argmin((free[:, 0] - row_c) ** 2 + (free[:, 1] - col_c) ** 2))
    pose = np.array([free[i, 1] * gm.resolution + gm.origin_x,
                     free[i, 0] * gm.resolution + gm.origin_y, 0.3], np.float32)
    scan = lut_scan(pf, pose).astype(np.float32)
    chain = 50
    actions = np.tile(np.float32([0.05, 0.0, 0.01]), (chain, 1))
    scans = np.tile(scan, (chain, 1))
    s0 = pf.init_pose(pose, seed=1)
    for f in (pf, pf_c):
        f.step_many(s0, actions[:5], scans[:5])  # warm-up
    torch.cuda.synchronize()

    rates = {"mega": [], "classic": []}
    poses = None
    pf.mega.mega.launch_count = 0
    for name in ("mega", "classic", "classic", "mega"):
        f = pf if name == "mega" else pf_c
        t1 = time.perf_counter()
        _, p = f.step_many(s0, actions, scans)
        torch.cuda.synchronize()
        rates[name].append(chain / (time.perf_counter() - t1))
        if name == "mega":
            poses = p.cpu().numpy()
    launches = pf.mega.mega.launch_count
    check(np.isfinite(poses).all(), "mega at 4000 x 1080 gave non-finite poses")
    check(launches == 2 * chain, f"{launches} mega launches for {2 * chain} corrections")
    prof = {name: chain_profile(lambda f=f: f.step_many(s0, actions[:20], scans[:20]), 20)
            for name, f in (("mega", pf), ("classic", pf_c))}
    emit("mega_full_window", t0, map="map_1753950572", particles=N_PARTICLES, beams=1080,
         lut="dense " + str(pf.grid_map.range_lut.dtype),
         lut_bytes=pf.grid_map.range_lut.numel() * pf.grid_map.range_lut.element_size(),
         corrections=chain, mega_launches_per_chain=launches / 2,
         chained_updates_per_s=rates, drift_from_start_m=float(np.linalg.norm(poses[-1, :2] - pose[:2])),
         profile_20_steps=prof)
    del pf, pf_c, gm
    torch.cuda.empty_cache()
    return dict(rates=rates)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    csrc = REPO / "monte_carlo_localization_tpu_torch" / "csrc"
    if not all((csrc / f).exists() for f in ("lut_likelihood.cu", "mega_step.cu", "beam_model.cuh")):
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
    check(set(built.libs) == {"lut_likelihood", "mega_step"}, f"built {sorted(built.libs)}")
    keep = ("== ", "Compiling entry", "registers", "smem", "spill")
    ptxas = [ln.strip() for ln in built.log.splitlines() if any(k in ln for k in keep)]
    grids = {}
    for num_beams in (60, 1080):
        for max_range_px in (200, 400):
            step = mega_case(np.random.default_rng(0), headline_beams(num_beams), max_range_px, 8, device)[0]
            grids[f"{num_beams} beams {'u8' if max_range_px <= 254 else 'u16'}"] = step.grid_blocks()
    emit("build", t0, nvcc_s=built.seconds,
         so={k: str(v.relative_to(REPO)) for k, v in built.paths.items()}, ptxas=ptxas,
         mega_grid_blocks=grids, sms=torch.cuda.get_device_properties(0).multi_processor_count)

    kernel_times = phase_kernel_vs_plain(device)
    mega_plain = phase_mega_vs_plain(device)
    config1 = phase_config1(device)
    mega1 = phase_config1_mega(device, config1["rate"])
    phase_mega_full_window(device)
    head = phase_headline(device)
    print(json.dumps({"kernels": [
        {
            "name": "lut_likelihood",
            "route": "cuda",
            "source": "monte_carlo_localization_tpu_torch/csrc/lut_likelihood.cu",
            "replaces": "monte_carlo_localization_tpu/ops/pallas_lut.py:450",
            "launches": head["launches"],
            "max_abs_err": head["max_abs_err"],
            "ms": head["ms"],
            "wrapper_ms": head["wrapper_ms"],
            "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"],
            "library_ms": None,
            "config1_launches": config1["launches"],
            "synthetic_times": kernel_times,
        },
        {
            "name": "mega_step",
            "route": "cuda",
            "source": "monte_carlo_localization_tpu_torch/csrc/mega_step.cu",
            "replaces": "monte_carlo_localization_tpu/ops/pallas_mega.py:197",
            "launches": mega1["launches"],
            "max_abs_err": max(mega1["max_abs_err"], mega_plain["max_abs_err"]),
            "ms": mega1["device_ms"],
            "wrapper_ms": mega1["wrapper_ms"],
            "plain_ms": mega1["plain_ms"],
            "bound_ms": mega1["bound_ms"],
            "bound_by": mega1["bound_by"],
            "library_ms": None,
            "phase_device_ms": mega1["phase_device_ms"],
            "synthetic_times": mega_plain["times"],
        },
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
