#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``csrc/`` (one nvcc per source,
in parallel), holds each against its plain PyTorch version on the card
(the LUT likelihood with and without the sub-bin lerp, the unique-window
kernel at 100k particles, the mega step), replays the config #1 golden
trace through ``ParticleFilter`` on the classic step and on the mega step
(``pallas_mega``), drives the mega step at 4000 x 1080 on the same map,
replays the config #4 golden trace on basement_fixed (compact LUT, built
here) with and without ``pallas_subbin``, runs config #4 global
localization at 100k particles with and without the unique-window kernel
(``pallas_dedup_slots``, once with ``pallas_dedup_matmul``), drives
the 4000-particle x 1080-beam Spielberg headline shape, holds the fleet
form of the LUT kernel against its plain version, runs config #5 (a
``FleetFilter`` of 64 cars x 4000 particles over 4 maps, bench.py
``bench_fleet``'s counterpart) and runs the probes of
``tools/mega_probe.py`` through their Hopper kernels. Each phase prints
one JSON line with its own seconds; any failure raises and exits
non-zero. The last two lines are the kernel report and ``{"ok": true,
"device": {...}}``. It imports nothing of JAX and needs no network.

Kernel times are device times from ``torch.profiler`` (``device_ms`` of
``monte_carlo_localization_tpu_torch/utils/timing.py``); the probe
kernels and their library calls are timed alike, as CUDA graphs of the
bare call (``graph_ms``), since the profiler drops events of kernels that
short. ``wrapper_ms`` times back-to-back Python calls of a wrapper with
CUDA events, which is host-bound where the kernel is shorter than the
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
sys.path.insert(0, str(REPO))
try:
    from monte_carlo_localization_tpu_torch.utils.timing import device_ms, event_ms, profile_run
except ModuleNotFoundError as exc:
    sys.exit(f"chip_smoke: run from a checkout of the repository ({exc})")
KERNEL_TOL = 1e-3  # float32, same expressions; FMA contraction and sum order differ
CONFIG1_RMSE_MAX = 0.075  # m, ~1.5x the 0.0486 m the JAX engine records (BENCHES.md)
# The config #4 trace ends in a long corridor where the filter slides
# along the axis by chance: one replay's xy RMSE moves with the seed
# (0.069-0.185 m over 5 seeds on the H100, 4000 particles). So the gate
# holds the median of five replay seeds at 1.5x the 0.0740 m the JAX
# engine records for one run (BENCHES.md); the exact-DDA CPU reference
# harness scores 0.1164 m on this trace.
CONFIG4_RMSE_MAX = 0.111  # m
CONFIG4_JAX_RMSE = 0.0740  # m, TPU v5e, one seed (BENCHES.md)
CONFIG4_SEEDS = (0, 1, 2, 3, 4)
N_PARTICLES = 4000
CONFIG4_PARTICLES = 100_000  # BASELINE.json config #4
DEDUP_SLOTS = 16
CONVERGE_TRIALS = 5  # bench.py bench_convergence
# share of dedup blocks with more than S windows once a trial is within
# 0.5 m: not 0, since the motion noise (0.05 m, 0.25 rad a step) leaves
# sparse tails whose windows crowd a block or two of 625 (the CPU
# rehearsal at 100k particles gave 0 and 1 of 625)
CONVERGED_OVERFLOW_MAX = 0.01
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
OPS_PER_LERP = 3  # the sub-bin lerp: subtract, multiply, add
OPS_PER_PARTICLE_K1 = 12  # address: 2 sub, 2 div, casts, compares, rint, fix-ups
OPS_PER_PARTICLE_K6 = 60  # + motion (sin/cos, chord, noise, wrap) and moments
# config #5 (BASELINE.json, bench.py CONFIGS[5] / CONFIG_MAPS[5])
CONFIG5_MAPS = ("map_1753950572.yaml", "icra_2_clean.yaml", "first_map.yaml", "new_map1.yaml")
CONFIG5_FLEET = 64
CONFIG5_CHAIN = 10  # bench_fleet: chain 10, 3 rounds of 3 reps, 3 rounds of 20 steps
CONFIG5_ROUNDS, CONFIG5_REPS, CONFIG5_ITERS = 3, 3, 20
FLEET_KERNELS_MAX = 1.5  # fleet device kernels per correction / config #1 classic's


def emit(phase: str, t0: float, **fields) -> None:
    print(json.dumps({"phase": phase, "seconds": time.perf_counter() - t0, **fields}), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def headline_beams(num_beams: int) -> np.ndarray:
    inc = 1.5 * np.pi / max(num_beams - 1, 1)
    return (-0.75 * np.pi + np.arange(num_beams) * inc).astype(np.float32)


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


def lut_bound(n: int, n_on: int, r: int, itemsize: int, row_map: bool,
              windows: int | None = None, subbin: bool = False) -> dict:
    """K1-K5: particles in, log weights out, obs + offsets, the LUT
    entries of each distinct on-map window (``windows``, default one per
    on-map particle; the entry and its +1 neighbour with the sub-bin lerp)
    and each on-map particle's row_map entry; the beam model per beam of
    each on-map particle."""
    windows = n_on if windows is None else windows
    entries = windows * r * (2 if subbin else 1)
    b = 12 * n + 4 * n + 8 * r + entries * itemsize + n_on * (4 if row_map else 0)
    ops_beam = OPS_PER_BEAM + (OPS_PER_LERP if subbin else 0)
    return bound(b, n * OPS_PER_PARTICLE_K1 + n_on * r * ops_beam, n_on * r)


def distinct_windows(q, particles, row_map) -> int:
    """Distinct on-map (row, start bin) windows of a cloud: the LUT reads
    its data needs."""
    import torch

    from monte_carlo_localization_tpu_torch.ops.lut_query import window_start

    row, b0, _, oob = window_start(q, particles, row_map)
    start = row * q.row_stride + b0.to(torch.int64)
    return int(torch.unique(start[~oob]).numel())


def mega_bound(n: int, n_on: int, r: int, itemsize: int) -> dict:
    """K6: particles, log weights and noise in; proposal, log weights and
    sums out; obs, offsets, scalars; one LUT entry per beam of each on-map
    proposal."""
    b = (12 + 4 + 12) * n + (12 + 4) * n + 8 * r + 64 + n_on * r * itemsize
    f64 = n_on * r + 7 * n  # beam sums, the CDF and the moment sums
    return bound(b, n * (OPS_PER_PARTICLE_K6 + 2 * math.ceil(math.log2(n))) + n_on * r * OPS_PER_BEAM, f64)


def synthetic_case(rng, beams, max_range_px, compact, n, device, **opts):
    """A random wraparound-padded LUT on a 64 x 80 map, particles of
    which some lie off the map (two at headings of -2pi and 2pi), and a
    scan. ``opts`` go to the LUTQuery."""
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
        lut_dtype=dtype, device=device, **opts,
    )
    n_rows = h * w // 3 + 1 if compact else h * w
    base = rng.integers(0, max_range_px + 1, (n_rows, t)).astype(dtype)
    lut = np.tile(base, (1, -(-stride // t)))[:, :stride].reshape(-1)
    row_map = rng.integers(0, n_rows, h * w).astype(np.int32) if compact else None
    x = rng.uniform(ox - 0.3, ox + w * res + 0.3, n)
    y = rng.uniform(oy - 0.3, oy + h * res + 0.3, n)
    theta = rng.uniform(-2 * math.pi, 2 * math.pi, n)
    theta[:2] = -2 * math.pi, 2 * math.pi
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
    cases, times = {"K1": [], "K3": []}, {"K1": {}, "K3": {}}
    for kernel, subbin in (("K1", False), ("K3", True)):
        for num_beams in (60, 1080):
            beams = headline_beams(num_beams)
            for max_range_px in (200, 400):
                for compact in (False, True):
                    q, lut, parts, obs, row_map = synthetic_case(
                        rng, beams, max_range_px, compact, N_PARTICLES, device, subbin=subbin
                    )
                    got = q.launch(lut, parts, obs, row_map)
                    torch.cuda.synchronize()
                    want = lut_log_weights_reference(q, lut, parts, obs, row_map)
                    torch.cuda.synchronize()
                    oob = int((want == -1e4).sum())
                    err = float((got - want).abs().max())
                    what = f"{kernel}, {num_beams} beams, {max_range_px} px, compact={compact}"
                    check(bool(((got == -1e4) == (want == -1e4)).all()), f"{what}: off-map particles differ")
                    check(0 < oob < N_PARTICLES, f"{what}: case needs particles on and off the map")
                    check(err <= KERNEL_TOL, f"{what}: kernel vs plain {err} > {KERNEL_TOL}")
                    cases[kernel].append(dict(beams=num_beams, lut="u8" if max_range_px <= 254 else "u16",
                                              row_map=compact, off_map=oob, max_abs_err=err))
                    if max_range_px == 200 and not compact:
                        times[kernel][f"{N_PARTICLES}x{num_beams}"] = dict(
                            **dict(zip(("device_ms", "time_source"), device_ms(
                                lambda: q.launch(lut, parts, obs, row_map), "lut_loglik_kernel").values())),
                            wrapper_ms=event_ms(lambda: q.launch(lut, parts, obs, row_map)),
                            plain_ms=event_ms(lambda: lut_log_weights_reference(q, lut, parts, obs, row_map)),
                            **lut_bound(N_PARTICLES, N_PARTICLES - oob, num_beams, 1, False,
                                        subbin=subbin),
                        )
    emit("kernel_vs_plain", t0, tol=KERNEL_TOL, cases=cases, synthetic_lut_times=times)
    return dict(times=times, max_abs_err={k: max(c["max_abs_err"] for c in v) for k, v in cases.items()})


def dedup_cloud(rng, kind: str, n: int, h: int, w: int, res: float, ox: float, oy: float):
    """converged: copies of five poses; uniform: every particle its own
    pose over the map; mixed: 70% converged, the rest uniform, 3% of all
    off the map."""
    poses = np.stack([rng.uniform(ox + 0.2 * w * res, ox + 0.8 * w * res, 5),
                      rng.uniform(oy + 0.2 * h * res, oy + 0.8 * h * res, 5),
                      rng.uniform(-math.pi, math.pi, 5)], 1)
    conv = poses[rng.integers(0, 5, n)]
    uni = np.stack([rng.uniform(ox, ox + w * res, n), rng.uniform(oy, oy + h * res, n),
                    rng.uniform(-2 * math.pi, 2 * math.pi, n)], 1)
    if kind == "converged":
        parts = conv
    elif kind == "uniform":
        parts = uni
    else:
        pick = rng.uniform(size=n)
        parts = np.where((pick < 0.7)[:, None], conv, uni)
        parts[pick > 0.97, 0] = ox - 1.0
    return parts.astype(np.float32)


def dedup_compare(q, lut, parts, obs, row_map, what: str) -> dict:
    """The unique-window kernel against the LUT kernel (bit for bit) and
    against its plain version, on one cloud; raises on a gate."""
    import torch

    from monte_carlo_localization_tpu_torch.ops.lut_query import lut_dedup_reference

    got = q.launch_dedup(lut, parts, obs, row_map)
    k1 = q.launch(lut, parts, obs, row_map)
    torch.cuda.synchronize()
    plain, overflow = lut_dedup_reference(q, lut, parts, obs, row_map, slots=q.launched_slots)
    torch.cuda.synchronize()
    err = float((got - plain).abs().max())
    check(torch.equal(got, k1), f"{what}: lut_dedup differs from lut_likelihood")
    check(bool(((got == -1e4) == (plain == -1e4)).all()), f"{what}: off-map particles differ")
    check(err <= KERNEL_TOL, f"{what}: dedup kernel vs plain {err} > {KERNEL_TOL}")
    check(int(q.last_overflow) == int(overflow),
          f"{what}: kernel counts {int(q.last_overflow)} overflowed blocks, plain {int(overflow)}")
    return dict(max_abs_err=err, overflowed_blocks=int(overflow),
                blocks=-(-parts.shape[0] // q.block), slots=q.launched_slots,
                off_map=int((plain == -1e4).sum()))


def dedup_times(q, lut, parts, obs, row_map, n_on: int) -> dict:
    """Device times of the unique-window kernel, of the LUT kernel on the
    same cloud and of the host-side plan (sort, ranks, slot table) per
    call; wrapper and plain times; the bound."""
    from monte_carlo_localization_tpu_torch.ops.lut_query import dedup_plan, lut_dedup_reference

    dev = device_ms(lambda: q.launch_dedup(lut, parts, obs, row_map), "lut_dedup_kernel")
    k1 = device_ms(lambda: q.launch(lut, parts, obs, row_map), "lut_loglik_kernel")
    plan_rows, _ = profile_run(lambda: dedup_plan(q, parts, row_map, q.launched_slots), 10)
    return dict(
        device_ms=dev["ms"], time_source=dev["source"], k1_device_ms=k1["ms"],
        plan_device_ms=sum(us for us, _ in plan_rows.values()) / 1e3 / 10,
        plan_device_kernels=sum(n for _, n in plan_rows.values()) / 10,
        wrapper_ms=event_ms(lambda: q.launch_dedup(lut, parts, obs, row_map)),
        k1_wrapper_ms=event_ms(lambda: q.launch(lut, parts, obs, row_map)),
        plain_ms=event_ms(lambda: lut_dedup_reference(q, lut, parts, obs, row_map), iters=10),
        **lut_bound(parts.shape[0], n_on, q.num_beams, q.lut_dtype.itemsize, row_map is not None,
                    windows=distinct_windows(q, parts, row_map), subbin=q.subbin),
    )


def phase_dedup_vs_plain(device) -> dict:
    """K4/K5 at 100k particles on a random 200 x 200 LUT: converged,
    uniform and mixed clouds, with the sub-bin lerp, u16 and a row map,
    and 1080 beams (u16 windows past the 48 KB shared-memory default)."""
    import torch

    from monte_carlo_localization_tpu_torch.ops.lut_query import (
        LUTQuery,
        required_row_stride,
        suggest_theta_bins,
    )

    t0 = time.perf_counter()
    rng = np.random.default_rng(4)
    h, w, res, ox, oy = 200, 200, 0.05, -1.0, 0.5
    n = CONFIG4_PARTICLES
    cases, times = [], {}
    for num_beams, max_range_px, compact, subbin, kinds in (
        (60, 200, False, False, ("converged", "uniform", "mixed")),
        (60, 200, False, True, ("converged", "mixed")),
        (60, 400, True, False, ("mixed",)),
        (1080, 400, False, True, ("mixed",)),
    ):
        beams = headline_beams(num_beams)
        dtype = np.uint8 if max_range_px <= 254 else np.uint16
        t = suggest_theta_bins(beams)
        stride = required_row_stride(t, beams, np.dtype(dtype).itemsize)
        q = LUTQuery(
            t, beams, height=h, width=w, resolution=res, origin_x=ox, origin_y=oy,
            max_range_px=max_range_px, row_stride=stride, z_hit=0.8, z_short=0.01,
            z_max=0.07, z_rand=0.12, sigma_hit=8.0, inv_squash=1 / 2.2, lut_dtype=dtype,
            subbin=subbin, dedup_slots=DEDUP_SLOTS, block=160, device=device,
        )
        n_rows = h * w // 3 + 1 if compact else h * w
        base = rng.integers(0, max_range_px + 1, (n_rows, t)).astype(dtype)
        lut = torch.from_numpy(np.tile(base, (1, -(-stride // t)))[:, :stride].reshape(-1)).to(device)
        del base
        row_map = (torch.from_numpy(rng.integers(0, n_rows, h * w).astype(np.int32)).to(device)
                   if compact else None)
        obs = torch.from_numpy(rng.uniform(0, max_range_px * 1.1, num_beams).astype(np.float32)).to(device)
        for kind in kinds:
            parts = torch.from_numpy(dedup_cloud(rng, kind, n, h, w, res, ox, oy)).to(device)
            what = f"dedup {kind}, {num_beams} beams, {dtype.__name__}, compact={compact}, subbin={subbin}"
            res_c = dedup_compare(q, lut, parts, obs, row_map, what)
            if kind == "converged":
                check(res_c["overflowed_blocks"] == 0, f"{what}: {res_c['overflowed_blocks']} blocks overflowed")
            if kind == "uniform":
                check(res_c["overflowed_blocks"] == res_c["blocks"], f"{what}: not every block overflowed")
            if kind == "mixed":
                check(0 < res_c["off_map"] < n, f"{what}: case needs particles on and off the map")
            cases.append(dict(beams=num_beams, lut=dtype.__name__, row_map=compact, subbin=subbin,
                              cloud=kind, window_bytes=q.info["window_bytes"], **res_c))
            if num_beams == 60 and not compact and kind in ("converged", "uniform") and not subbin:
                times[f"{n}x60 {kind}"] = dedup_times(q, lut, parts, obs, row_map, n - res_c["off_map"])
        del lut, row_map, parts
        torch.cuda.empty_cache()
    emit("dedup_vs_plain", t0, tol=KERNEL_TOL, slots=DEDUP_SLOTS, block=160, cases=cases,
         synthetic_lut_times=times)
    return dict(max_abs_err=max(c["max_abs_err"] for c in cases), times=times)


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
    wrapper_ms = event_ms(lambda: pf.likelihood.launch(lut, parts, obs_px, row_map))
    plain_ms = event_ms(lambda: lut_log_weights_reference(pf.likelihood, lut, parts, obs_px, row_map))
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
        wrapper_ms=event_ms(launch()),
        plain_ms=event_ms(lambda: mega_step_reference(step, lut, parts, logw, noise, obs, scalars)),
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
    return dict(launches=mega_launches, max_abs_err=cmp["max_abs_err"],
                classic_kernels_per_correction=prof["classic"]["device_kernels_per_correction"],
                **times)


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


def phase_config4_replay(device):
    """The config #4 golden trace on basement_fixed through the compact
    LUT, 4000 particles x 60 beams, with the defaults (K2) and with
    ``pallas_subbin`` (K3), each from the replay seeds CONFIG4_SEEDS.
    Returns (kernel report, the map with its LUT, the trace's 60
    beams)."""
    import torch

    from monte_carlo_localization_tpu_torch import MCLConfig, ParticleFilter, load_map
    from monte_carlo_localization_tpu_torch.ops.lut_query import lut_log_weights_reference
    from monte_carlo_localization_tpu_torch.runtime import replay_chained

    t0 = time.perf_counter()
    trace = REPO / "traces" / "config4_basement_fixed.npz"
    gm = load_map(REPO / "maps" / "basement_fixed.map.yaml", device=device)
    cfg = MCLConfig(max_particles=N_PARTICLES, angle_step=18)
    pf = ParticleFilter(gm, cfg)
    tr, actions, scans = trace_inputs(pf, trace)
    beams = tr["beam_angles"][:: cfg.angle_step]
    t1 = time.perf_counter()
    pf.set_beam_angles(beams)  # builds the compact LUT on the host, uploads it
    torch.cuda.synchronize()
    t_lut = time.perf_counter() - t1
    gm = pf.grid_map
    check(gm.lut_row_map is not None, "basement_fixed should take the row-compacted LUT")
    pf_sub = ParticleFilter(gm, cfg.replace(pallas_subbin=True))
    pf_sub.set_beam_angles(beams)
    check(pf_sub.grid_map.range_lut is gm.range_lut, "the subbin filter should share the LUT")
    runs = {}
    for name, f in (("default", pf), ("subbin", pf_sub)):
        f.likelihood.launch_count = 0
        reps = [replay_chained(f, trace, chunk=64, seed=seed) for seed in CONFIG4_SEEDS]
        launches = f.likelihood.launch_count
        for res in reps:
            check(np.isfinite(res.poses).all(), f"config #4 {name} replay gave non-finite poses")
        corrections = sum(res.corrections for res in reps)
        check(launches == corrections == 500 * len(CONFIG4_SEEDS),
              f"config #4 {name}: {launches} kernel launches for {corrections} corrections")
        median = float(np.median([res.rmse_xy for res in reps]))
        check(median <= CONFIG4_RMSE_MAX,
              f"config #4 {name} replay median RMSE {median} m > {CONFIG4_RMSE_MAX}")
        truth = np.stack([np.interp(reps[0].times, tr["truth_t"], tr["truth_pose"][:, i])
                          for i in range(2)], 1)
        errs = np.concatenate([np.hypot(*(res.poses[:, :2] - truth).T) for res in reps])
        runs[name] = dict(launches=launches, median_rmse_xy_m=median,
                          jax_engine_rmse_xy_m=CONFIG4_JAX_RMSE,
                          per_scan_err_m_quantiles={q: float(np.quantile(errs, q))
                                                    for q in (0.5, 0.9, 0.99)},
                          rmse_xy_m=[res.rmse_xy for res in reps],
                          rmse_theta_rad=[res.rmse_theta for res in reps],
                          chained_updates_per_s=[res.updates_per_sec for res in reps])

    # K3 against its plain version on the real LUT, at this path's shape
    q, lut, row_map = pf_sub.likelihood, gm.range_lut, gm.lut_row_map
    state = pf_sub.init_pose(tr["truth_pose"][0], seed=2)
    state, _ = pf_sub.step_many(state, actions[:8], scans[:8])
    obs = pf_sub.sensor.to_pixel_index(torch.as_tensor(scans[8], device=device)).float()
    parts = state.particles.contiguous()
    got = q.launch(lut, parts, obs, row_map)
    want = lut_log_weights_reference(q, lut, parts, obs, row_map)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    check(err <= KERNEL_TOL, f"K3 vs plain on the basement LUT: {err} > {KERNEL_TOL}")
    n_on = int((want != -1e4).sum())
    dev = device_ms(lambda: q.launch(lut, parts, obs, row_map), "lut_loglik_kernel")
    k3 = dict(launches=runs["subbin"]["launches"], max_abs_err=err, ms=dev["ms"],
              time_source=dev["source"],
              wrapper_ms=event_ms(lambda: q.launch(lut, parts, obs, row_map)),
              plain_ms=event_ms(lambda: lut_log_weights_reference(q, lut, parts, obs, row_map)),
              **lut_bound(N_PARTICLES, n_on, q.num_beams, 1, True,
                          windows=distinct_windows(q, parts, row_map), subbin=True))
    s0 = pf.init_pose(tr["truth_pose"][0], seed=3)
    prof = {name: chain_profile(lambda f=f: f.step_many(s0, actions[:20], scans[:20]), 20)
            for name, f in (("default", pf), ("subbin", pf_sub))}
    emit("config4_replay", t0, map="basement_fixed", particles=N_PARTICLES, beams=len(beams),
         lut="compact " + str(lut.dtype), lut_rows=lut.numel() // gm.row_stride,
         row_stride=gm.row_stride, lut_bytes=lut.numel() * lut.element_size(),
         lut_build_and_upload_s=t_lut, corrections_per_replay=500, seeds=list(CONFIG4_SEEDS),
         runs=runs, k3_on_basement=k3,
         profile_20_steps=prof)
    del pf, pf_sub, state, parts
    torch.cuda.empty_cache()
    return dict(k1_launches=runs["default"]["launches"], k3=k3), gm, beams


def converge_truths(gm) -> list[np.ndarray]:
    """The trial poses of bench.py bench_convergence: free cell centres
    drawn by default_rng(0), headings uniform."""
    rng = np.random.default_rng(0)
    free = gm.free_cells[: gm.num_free].cpu().numpy()
    truths = []
    for _ in range(CONVERGE_TRIALS):
        row, col = free[rng.integers(len(free))]
        truths.append(np.array([(col + 0.5) * gm.resolution + gm.origin_x,
                                (row + 0.5) * gm.resolution + gm.origin_y,
                                rng.uniform(-np.pi, np.pi)], np.float32))
    return truths


def phase_config4_converge(device, gm, beams) -> dict:
    """Config #4: 100k particles seeded over basement_fixed, chained
    corrections in chunks of 5 until within 0.5 m (at most 80), 5 trials,
    each with the unique-window kernel (K4) and without it (K2), the
    first also with ``pallas_dedup_matmul`` (K5). The trial seeds are
    shared, so the runs must agree bit for bit."""
    import torch

    from monte_carlo_localization_tpu_torch import MCLConfig, ParticleFilter
    from monte_carlo_localization_tpu_torch.ops.raycast import cast_rays_sphere
    from monte_carlo_localization_tpu_torch.runtime import converge_global

    t0 = time.perf_counter()
    n = CONFIG4_PARTICLES
    filters = {}
    for name, opts in (("plain_K2", {}), ("dedup_K4", dict(pallas_dedup_slots=DEDUP_SLOTS)),
                       ("dedup_matmul_K5", dict(pallas_dedup_slots=DEDUP_SLOTS, pallas_dedup_matmul=True))):
        f = ParticleFilter(gm, MCLConfig(max_particles=n, **opts))
        f.set_beam_angles(beams)
        filters[name] = f
    check(filters["dedup_K4"].likelihood.dedup_slots == DEDUP_SLOTS, "dedup filter without slots")
    check(filters["dedup_matmul_K5"].likelihood.dedup_matmul, "K5 filter without dedup_matmul")
    beams_t = torch.as_tensor(beams, dtype=torch.float32, device=device)

    def scan_at(pose):
        q = torch.stack([torch.full_like(beams_t, float(pose[0])),
                         torch.full_like(beams_t, float(pose[1])), float(pose[2]) + beams_t], 1)
        return cast_rays_sphere(gm, q, num_iters=64).cpu().numpy()

    truths = converge_truths(gm)
    scans = [scan_at(p) for p in truths]
    for f in filters.values():  # pay first launches outside every trial's timer
        converge_global(f, scans[0], truths[0], seed=99, max_updates=5)
    torch.cuda.synchronize()
    for f in filters.values():
        f.likelihood.launch_count = f.likelihood.dedup_launch_count = 0
    trials = []
    runs = {name: [] for name in filters}
    for i, (truth, scan) in enumerate(zip(truths, scans)):
        order = ("dedup_K4", "plain_K2") + (("dedup_matmul_K5",) if i == 0 else ())
        got = {name: converge_global(filters[name], scan, truth, seed=100 + i) for name in order}
        ref = got["plain_K2"].poses
        for name, r in got.items():
            check(np.array_equal(r.poses, ref),
                  f"trial {i}: {name} poses differ from the run without dedup")
            runs[name].append(r)
        d = got["dedup_K4"]
        if d.updates is not None:
            check(d.overflow_share[-1] <= CONVERGED_OVERFLOW_MAX,
                  f"trial {i}: {d.overflow_share[-1]} of blocks overflowed after convergence")
        trials.append(dict(truth=truth.tolist(), updates=d.updates, err_m=d.err_m,
                           seconds={k: r.seconds for k, r in got.items()},
                           updates_per_s={k: r.poses.shape[0] / r.seconds for k, r in got.items()},
                           overflow_share_per_chunk=list(d.overflow_share)))
    launches = {name: (f.likelihood.dedup_launch_count if f.likelihood.dedup_slots else
                       f.likelihood.launch_count) for name, f in filters.items()}
    for name, f in filters.items():
        check(launches[name] > 0, f"{name}: its kernel was never launched")
        if f.likelihood.dedup_slots:
            check(f.likelihood.launch_count == 0, f"{name} launched the LUT kernel")
    ok = [t for t in trials if t["updates"] is not None]
    check(len(ok) >= 1, "no config #4 trial converged")

    def summary(name):
        done = [r for r in runs[name] if r.updates is not None]
        return dict(
            median_updates=float(np.median([r.updates for r in done])) if done else None,
            median_seconds=float(np.median([r.seconds for r in done])) if done else None,
            chained_updates_per_s=[r.poses.shape[0] / r.seconds for r in runs[name]],
        )

    # the kernels on a cloud of this path: the last converged dedup trial's
    kernels = {}
    last = max(i for i, r in enumerate(runs["dedup_K4"]) if r.updates is not None)
    obs = filters["dedup_K4"].sensor.to_pixel_index(torch.as_tensor(scans[last], device=device)).float()
    for name in ("dedup_K4", "dedup_matmul_K5"):
        q = filters[name].likelihood
        r = runs["dedup_K4"][last]
        parts = r.state.particles.contiguous()
        cmp = dedup_compare(q, gm.range_lut, parts, obs, gm.lut_row_map, f"config #4 {name}")
        n_on = n - cmp["off_map"]
        kernels[name] = dict(launches=launches[name], **cmp,
                             **dedup_times(q, gm.range_lut, parts, obs, gm.lut_row_map, n_on))
    # kernels per correction and idle share at 100k, 10 chained steps from a
    # uniform seed against the first trial's scan
    s0 = filters["plain_K2"].init_global(seed=7)
    zeros, tiled = np.zeros((10, 3), np.float32), np.tile(scans[0], (10, 1))
    prof = {name: chain_profile(lambda f=filters[name]: f.step_many(s0, zeros, tiled), 10)
            for name in ("plain_K2", "dedup_K4")}
    emit("config4_converge", t0, map="basement_fixed", particles=n, beams=len(beams),
         slots=DEDUP_SLOTS, block=filters["dedup_K4"].likelihood.block, trials=trials,
         success_rate=len(ok) / len(trials), launches=launches,
         summary={name: summary(name) for name in runs}, kernels_on_converged_cloud=kernels,
         profile_10_steps=prof)
    del filters, runs
    torch.cuda.empty_cache()
    return kernels

# fleet cases: (map shapes, members, particles per member, map_of,
# member_base, compact, max_range_px, subbin). npm 4001 and 1003 are not
# multiples of 8, so a block of 8 warps would straddle two members; every
# case has particles off their member's map.
FLEET_CASES = {
    "3_members_2_maps": ([(64, 80), (40, 120)], 3, 4000, [0, 1, 0], 0, False, 200, False),
    "shared_map_of": ([(64, 80), (40, 120)], 8, 1003, [1, 1, 0, 1, 0, 0, 1, 1], 0, False, 200,
                      False),
    "compact_row_map_bases": ([(64, 80), (40, 120)], 3, 4000, [1, 0, 1], 0, True, 200, False),
    "u16": ([(64, 80), (40, 120)], 3, 4001, [0, 1, 1], 0, False, 400, False),
    "subbin": ([(64, 80), (40, 120)], 3, 4000, [0, 1, 0], 0, True, 200, True),
    "member_base_2": ([(64, 80), (40, 120)], 2, 1003, [0, 0, 1, 0, 1], 2, False, 200, False),
}


def fleet_case(rng, maps, f, npm, map_of, member_base, compact, max_range_px, subbin, device):
    """A fleet LUTQuery over random tight LUT blocks of maps with their own
    origins, particles of which some lie off their member's map, one scan
    per member. Returns (query, lut, particles, obs, row_map, fleet
    arguments)."""
    import torch

    from monte_carlo_localization_tpu_torch.ops.lut_query import (
        LUTQuery,
        required_row_stride,
        suggest_theta_bins,
    )

    beams = headline_beams(60)
    dtype = np.uint8 if max_range_px <= 254 else np.uint16
    itemsize = np.dtype(dtype).itemsize
    t = suggest_theta_bins(beams)
    stride = required_row_stride(t, beams, itemsize)
    eps = 512 // itemsize
    q = LUTQuery(
        t, beams, height=max(h for h, _ in maps), width=max(w for _, w in maps),
        resolution=0.05, origin_x=0.0, origin_y=0.0, max_range_px=max_range_px,
        row_stride=stride, z_hit=0.8, z_short=0.01, z_max=0.07, z_rand=0.12, sigma_hit=8.0,
        inv_squash=1 / 2.2, lut_dtype=dtype, subbin=subbin, num_members=f,
        per_member_maps=True, device=device,
    )
    ox = rng.uniform(-2, 2, len(maps)).astype(np.float32)
    oy = rng.uniform(-2, 2, len(maps)).astype(np.float32)
    blocks, bases, rmaps, rbases, at, rat = [], [], [], [], 0, 0
    for h, w in maps:
        rows = h * w // 3 + 1 if compact else h * w
        blocks.append(rng.integers(0, max_range_px + 1, rows * stride).astype(dtype))
        bases.append(at)
        at += rows * (stride // eps)
        if compact:
            rmaps.append(rng.integers(0, rows, h * w).astype(np.int32))
            rbases.append(rat)
            rat += h * w
    mi = np.asarray(map_of)[np.arange(f) + member_base]
    parts = np.zeros((f, npm, 3), np.float32)
    for k in range(f):
        h, w = maps[mi[k]]
        parts[k, :, 0] = rng.uniform(ox[mi[k]] - 0.3, ox[mi[k]] + w * 0.05 + 0.3, npm)
        parts[k, :, 1] = rng.uniform(oy[mi[k]] - 0.3, oy[mi[k]] + h * 0.05 + 0.3, npm)
        parts[k, :, 2] = rng.uniform(-2 * math.pi, 2 * math.pi, npm)
    obs = rng.uniform(0, max_range_px * 1.1, (f, 60)).astype(np.float32)

    def to(a):
        return None if a is None else torch.from_numpy(np.ascontiguousarray(a)).to(device)

    fleet = dict(member_base=member_base, origins=(to(ox), to(oy)),
                 map_of=to(np.asarray(map_of, np.int32)), dims=to(np.array(maps, np.int32)),
                 lut_bases=to(np.array(bases, np.int32)),
                 row_map_bases=to(np.array(rbases, np.int32)) if compact else None)
    row_map = to(np.concatenate(rmaps)) if compact else None
    return q, to(np.concatenate(blocks)), to(parts.reshape(-1, 3)), to(obs), row_map, fleet


def fleet_compare(q, lut, parts, obs, row_map, fleet, what: str, synthetic: bool = True) -> dict:
    """One fleet-kernel launch against its plain version; raises on a gate
    (a synthetic case must hold particles on and off the maps)."""
    import torch

    from monte_carlo_localization_tpu_torch.ops.lut_query import lut_log_weights_reference

    tables = q.fleet_tables(parts, obs, row_map, **fleet)
    got = q.launch(lut, parts, obs, row_map, tables)
    torch.cuda.synchronize()
    want = lut_log_weights_reference(q, lut, parts, obs, row_map, tables)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    off = int((want == -1e4).sum())
    check(bool(((got == -1e4) == (want == -1e4)).all()), f"{what}: off-map particles differ")
    check(not synthetic or 0 < off < parts.shape[0],
          f"{what}: case needs particles on and off the maps")
    check(err <= KERNEL_TOL, f"{what}: fleet kernel vs plain {err} > {KERNEL_TOL}")
    return dict(max_abs_err=err, off_map=off, particles=parts.shape[0])


def phase_fleet_vs_plain(device) -> dict:
    """The fleet form of lut_likelihood.cu against its plain version on
    synthetic cases, and a one-member fleet with its own map tables
    against the single-map query's launch (torch.equal)."""
    import torch

    from monte_carlo_localization_tpu_torch.ops.lut_query import LUTQuery

    t0 = time.perf_counter()
    cases = {}
    for name, case in FLEET_CASES.items():
        args = fleet_case(np.random.default_rng(len(name)), *case, device)
        cases[name] = fleet_compare(*args, f"fleet {name}")
    one = {}
    for subbin in (False, True):
        for compact in (False, True):
            q, lut, parts, obs, row_map = synthetic_case(
                np.random.default_rng(5), headline_beams(60), 200, compact, N_PARTICLES + 1,
                device, subbin=subbin)
            fq = LUTQuery(q.t_bins, headline_beams(60), height=q.height, width=q.width,
                          resolution=q.resolution, origin_x=q.origin_x, origin_y=q.origin_y,
                          max_range_px=200, row_stride=q.row_stride, z_hit=0.8, z_short=0.01,
                          z_max=0.07, z_rand=0.12, sigma_hit=8.0, inv_squash=1 / 2.2,
                          subbin=subbin, per_member_maps=True, device=device)
            fleet = dict(
                origins=(torch.tensor([q.origin_x], device=device),
                         torch.tensor([q.origin_y], device=device)),
                lut_bases=torch.zeros(1, dtype=torch.int32, device=device),
                row_map_bases=torch.zeros(1, dtype=torch.int32, device=device) if compact else None)
            got = fq(lut, parts, obs[None], row_map=row_map, **fleet)
            want = q.launch(lut, parts, obs, row_map)
            torch.cuda.synchronize()
            what = f"one-member fleet, subbin={subbin}, compact={compact}"
            check(torch.equal(got, want), f"{what}: differs from the single-map kernel")
            one[f"subbin={subbin} compact={compact}"] = "torch.equal"
    emit("fleet_vs_plain", t0, tol=KERNEL_TOL, cases=cases, one_member_vs_single=one)
    return dict(max_abs_err=max(c["max_abs_err"] for c in cases.values()))


# copies of bench.py's helpers (chip_smoke imports neither bench.py nor
# jax; headline_beams is bench.py's _beams)
def _center_pose(gm) -> np.ndarray:
    """A pose at the centroid of free space (bench.py ``_center_pose``)."""
    free = gm.free_cells[: int(gm.num_free)].cpu().numpy()
    row, col = free.mean(axis=0)
    return np.array([col * gm.resolution + float(gm.origin_x),
                     row * gm.resolution + float(gm.origin_y), 0.3], np.float32)


def _nearest_free_pose(gm, pose) -> np.ndarray:
    """Snap a pose to the nearest free cell (bench.py ``_nearest_free_pose``)."""
    free = gm.free_cells[: int(gm.num_free)].cpu().numpy()
    col = (pose[0] - float(gm.origin_x)) / gm.resolution
    row = (pose[1] - float(gm.origin_y)) / gm.resolution
    i = np.argmin((free[:, 0] - row) ** 2 + (free[:, 1] - col) ** 2)
    return np.array([free[i, 1] * gm.resolution + float(gm.origin_x),
                     free[i, 0] * gm.resolution + float(gm.origin_y), pose[2]], np.float32)


def _drift_threshold(n_corrections: int, sigma_xy: float = 0.05) -> float:
    """bench.py's divergence gate for zero-action benches: 3 sigma of the
    motion noise's random walk over S corrections, floored at 1 m."""
    return max(1.0, 3.0 * float(np.sqrt(max(n_corrections, 1))) * sigma_xy)


def phase_config5(device, classic_kernels: float) -> dict:
    """BASELINE.json config #5 as bench.py ``bench_fleet`` runs it: 64 cars
    x 4000 particles x 60 beams over 4 maps (map_assignment = arange(64) %
    4), tight dense member LUTs, each car at its map's best-cleared pose
    with a sphere-cast scan; chains of 10 corrections (1 warm + 3 rounds x
    3), then 3 rounds of 20 single steps."""
    import torch

    from monte_carlo_localization_tpu_torch import MCLConfig, load_map
    from monte_carlo_localization_tpu_torch.ops.lut_query import fleet_window_start
    from monte_carlo_localization_tpu_torch.ops.lut_query import lut_log_weights_reference
    from monte_carlo_localization_tpu_torch.ops.raycast import cast_rays_sphere
    from monte_carlo_localization_tpu_torch.parallel import FleetFilter, stack_maps

    t0 = time.perf_counter()
    f, n, r = CONFIG5_FLEET, N_PARTICLES, 60
    maps = [load_map(REPO / "maps" / name, device=device) for name in CONFIG5_MAPS]
    asg = np.arange(f, dtype=np.int32) % len(maps)
    beams = headline_beams(r)
    ff = FleetFilter(stack_maps(maps), f, MCLConfig(max_particles=n, lut_theta_bins=720),
                     map_assignment=asg)
    t1 = time.perf_counter()
    ff.set_beam_angles(beams)  # builds the tight member LUTs on the host, uploads them
    torch.cuda.synchronize()
    t_lut = time.perf_counter() - t1
    gm, q = ff.map, ff.likelihood
    check(gm.lut_row_map is None and gm.lut_member_base is not None,
          "config #5 should take tight dense member LUTs")
    lut_bytes = gm.range_lut.numel() * gm.range_lut.element_size()
    cells = [int(h) * int(w) for h, w in gm.member_dims.tolist()]
    check(lut_bytes == sum(cells) * gm.row_stride * gm.range_lut.element_size(),
          f"member LUT of {lut_bytes} B is not the sum of the true map areas")

    map_poses = [_nearest_free_pose(m, _center_pose(m)) for m in maps]
    beams_t = torch.as_tensor(beams, device=device)
    map_scans = []
    for m, p in zip(maps, map_poses):
        qry = torch.stack([torch.full_like(beams_t, float(p[0])), torch.full_like(beams_t, float(p[1])),
                           float(p[2]) + beams_t], 1)
        map_scans.append(cast_rays_sphere(m, qry, num_iters=64).cpu().numpy())
    poses0 = np.stack([map_poses[a] for a in asg])
    scans = np.stack([map_scans[a] for a in asg])
    action = np.zeros((f, 3), np.float32)
    actions_k = np.tile(action, (CONFIG5_CHAIN, 1, 1))
    scans_k = np.tile(scans, (CONFIG5_CHAIN, 1, 1))
    state = ff.init_pose(poses0, seed=1)
    q.fleet_launch_count = q.launch_count = 0

    state, poses = ff.step_many(state, actions_k, scans_k)  # warm chain
    torch.cuda.synchronize()
    chained = []
    for _ in range(CONFIG5_ROUNDS):
        t2 = time.perf_counter()
        for _ in range(CONFIG5_REPS):
            state, poses = ff.step_many(state, actions_k, scans_k)
        torch.cuda.synchronize()
        chained.append(CONFIG5_REPS * CONFIG5_CHAIN / (time.perf_counter() - t2))
    n_corr = CONFIG5_CHAIN * (1 + CONFIG5_ROUNDS * CONFIG5_REPS)
    err_chain = np.linalg.norm(poses[-1].cpu().numpy()[:, :2] - poses0[:, :2], axis=1)
    thr_chain = _drift_threshold(n_corr)
    check(bool(np.isfinite(err_chain).all()) and err_chain.max() < thr_chain,
          f"config #5 chained: max member error {err_chain.max()} m >= {thr_chain}")
    per_step = []
    for _ in range(CONFIG5_ROUNDS):
        t2 = time.perf_counter()
        for _ in range(CONFIG5_ITERS):
            state, pose_s = ff.step(state, action, scans)
        torch.cuda.synchronize()
        per_step.append(CONFIG5_ITERS / (time.perf_counter() - t2))
    n_corr += CONFIG5_ROUNDS * CONFIG5_ITERS
    err = np.linalg.norm(pose_s.cpu().numpy()[:, :2] - poses0[:, :2], axis=1)
    thr = _drift_threshold(n_corr)
    check(bool(np.isfinite(err).all()) and err.max() < thr,
          f"config #5 per step: max member error {err.max()} m >= {thr}")
    launches = q.fleet_launch_count
    check(launches == n_corr and q.launch_count == 0,
          f"{launches} fleet-kernel launches (and {q.launch_count} single) for {n_corr} corrections")

    # the fleet kernel against its plain version at this path's shape
    obs = ff.sensor.to_pixel_index(torch.as_tensor(scans, device=device)).float()
    parts = state.particles.reshape(-1, 3).contiguous()
    fleet = dict(origins=(gm.origin_x, gm.origin_y), map_of=ff._member_map, dims=gm.member_dims,
                 lut_bases=gm.lut_member_base, row_map_bases=gm.lut_row_map_base)
    cmp = fleet_compare(q, gm.range_lut, parts, obs, None, fleet, "config #5 fleet kernel",
                        synthetic=False)
    tables = q.fleet_tables(parts, obs, None, **fleet)
    start, _, oob, _ = fleet_window_start(q, parts, tables)
    windows = int(torch.unique(start[~oob]).numel())
    dev = device_ms(lambda: q.launch(gm.range_lut, parts, obs, None, tables),
                    "lut_loglik_kernel")
    kernel = dict(
        launches=launches, max_abs_err=cmp["max_abs_err"], ms=dev["ms"], time_source=dev["source"],
        wrapper_ms=event_ms(lambda: q.launch(gm.range_lut, parts, obs, None, tables)),
        plain_ms=event_ms(lambda: lut_log_weights_reference(q, gm.range_lut, parts, obs, None, tables),
                         iters=10),
        distinct_windows=windows,
        **lut_bound(f * n, f * n - cmp["off_map"], r, 1, False, windows=windows),
    )
    prof = chain_profile(lambda: ff.step_many(state, actions_k, scans_k), CONFIG5_CHAIN)
    kernels = prof["device_kernels_per_correction"]
    check(kernels <= FLEET_KERNELS_MAX * classic_kernels,
          f"config #5: {kernels} device kernels per correction > {FLEET_KERNELS_MAX} x "
          f"the single filter's {classic_kernels}")
    emit("config5_fleet", t0, maps=[m.name for m in maps], fleet=f, particles=n, beams=r,
         map_assignment="arange(64) % 4", lut="tight dense " + str(gm.range_lut.dtype),
         lut_bytes=lut_bytes, lut_row_stride=gm.row_stride, lut_theta_bins=gm.lut_theta_bins,
         member_cells=cells, lut_build_and_upload_s=t_lut, corrections=n_corr,
         fleet_launches=launches,
         chained_fleet_steps_per_s=chained,
         chained_member_updates_per_s=[x * f for x in chained],
         per_step_fleet_steps_per_s=per_step,
         per_step_member_updates_per_s=[x * f for x in per_step],
         max_member_err_m=dict(chained=float(err_chain.max()), per_step=float(err.max())),
         drift_threshold_m=dict(chained=thr_chain, per_step=thr),
         kernel=kernel, profile_10_steps=prof,
         classic_config1_kernels_per_correction=classic_kernels)
    del ff, state, parts, maps
    torch.cuda.empty_cache()
    return kernel


def phase_probes(device) -> dict:
    """The probes of tools/mega_probe.py through their Hopper kernels (the
    port's ``tools/mega_probe.py``): every probe once with the launch
    counts reset (a failed probe or a kernel off its plain version fails
    the run), then each kernel call timed: kernel and library ms as CUDA
    graphs, wrapper ms, plain ms, bound."""
    import torch

    from monte_carlo_localization_tpu_torch.ops.probes import Probes
    from monte_carlo_localization_tpu_torch.tools.mega_probe import PROBES, measure

    t0 = time.perf_counter()
    pr = Probes()
    calls = {name: PROBES[name](pr, device) for name in PROBES}
    torch.cuda.synchronize()
    launches = dict(pr.launch_count)
    for kernel, count in launches.items():
        check(count > 0, f"probe kernel {kernel} was never launched")
    timed = {}
    for name, probe_calls in calls.items():
        timed[name] = []
        for call in probe_calls:
            m = measure(call)
            m.update(bound(m["bytes"], m["f32_ops"], m["f64_ops"]))
            timed[name].append(m)
    emit("probes", t0, passed=list(calls), launches=launches, calls=timed)
    return dict(launches=launches, timed=timed)


def probe_entries(probes: dict) -> list[dict]:
    """The kernels-line entries of the four probe kernels."""
    timed, launches = probes["timed"], probes["launches"]
    keys = ("ms", "time_source", "wrapper_ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
            "rows_off")
    src = "monte_carlo_localization_tpu_torch/csrc/probes.cu"

    def entry(name, kernel, replaces, head, others):
        return {"name": name, "route": "cuda", "source": src, "replaces": replaces,
                "launches": launches[kernel],
                "max_abs_err": max(m["max_abs_err"] for m in [head, *others]),
                **{k: head[k] for k in keys},
                "other_calls": [{k: m[k] for k in ("label", *keys)} for m in others]}

    scans = [m for name in ("cumsum", "mega_parts", "mega_bisect") for m in timed[name]]
    return [
        entry("probe_gather_rows", "gather_rows", "tools/mega_probe.py:58",
              timed["smem"][0], []),
        entry("probe_philox_normals", "philox_normals", "tools/mega_probe.py:97",
              timed["rng"][0], []),
        entry("probe_staged_writes", "staged_writes", "tools/mega_probe.py:155, 303",
              timed["scratch"][0], timed["smem_roundtrip"]),
        entry("probe_scan_resample", "scan_resample",
              "tools/mega_probe.py:127, 238, 369, 380, 401, 423, 436, 487, 526, 567",
              timed["mega_ops"][0], scans),
    ]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    csrc = REPO / "monte_carlo_localization_tpu_torch" / "csrc"
    if not all((csrc / f).exists() for f in ("lut_likelihood.cu", "lut_dedup.cu", "mega_step.cu",
                                             "probes.cu", "beam_model.cuh")):
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        return 2
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
    check(set(built.libs) == {"lut_likelihood", "lut_dedup", "mega_step", "probes"},
          f"built {sorted(built.libs)}")
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

    lut_plain = phase_kernel_vs_plain(device)
    dedup_plain = phase_dedup_vs_plain(device)
    mega_plain = phase_mega_vs_plain(device)
    config1 = phase_config1(device)
    mega1 = phase_config1_mega(device, config1["rate"])
    phase_mega_full_window(device)
    config4, gm4, beams4 = phase_config4_replay(device)
    conv = phase_config4_converge(device, gm4, beams4)
    del gm4
    torch.cuda.empty_cache()
    head = phase_headline(device)
    fleet_plain = phase_fleet_vs_plain(device)
    config5 = phase_config5(device, mega1["classic_kernels_per_correction"])
    probes = phase_probes(device)
    keys = ("launches", "max_abs_err", "ms", "wrapper_ms", "plain_ms", "bound_ms", "bound_by")
    k3 = config4["k3"]
    dedup_entries = []
    for name, replaces in (("dedup_K4", "monte_carlo_localization_tpu/ops/pallas_lut.py:584"),
                           ("dedup_matmul_K5", "monte_carlo_localization_tpu/ops/pallas_lut.py:523")):
        c = conv[name]
        dedup_entries.append({
            "name": "lut_dedup" if name == "dedup_K4" else "lut_dedup (dedup_matmul)",
            "route": "cuda",
            "source": "monte_carlo_localization_tpu_torch/csrc/lut_dedup.cu",
            "replaces": replaces,
            "launches": c["launches"],
            "max_abs_err": max(c["max_abs_err"], dedup_plain["max_abs_err"]),
            "ms": c["device_ms"], "wrapper_ms": c["wrapper_ms"], "plain_ms": c["plain_ms"],
            "bound_ms": c["bound_ms"], "bound_by": c["bound_by"], "library_ms": None,
            "k1_ms_same_cloud": c["k1_device_ms"], "plan_ms": c["plan_device_ms"],
            "overflowed_blocks": c["overflowed_blocks"],
            "synthetic_times": dedup_plain["times"] if name == "dedup_K4" else None,
        })
    print(json.dumps({"kernels": [
        {
            "name": "lut_likelihood",
            "route": "cuda",
            "source": "monte_carlo_localization_tpu_torch/csrc/lut_likelihood.cu",
            "replaces": "monte_carlo_localization_tpu/ops/pallas_lut.py:450",
            **{k: head[k] for k in keys},
            "library_ms": None,
            "config1_launches": config1["launches"],
            "config4_launches": config4["k1_launches"],
            "synthetic_times": lut_plain["times"]["K1"],
        },
        {
            "name": "lut_likelihood (subbin)",
            "route": "cuda",
            "source": "monte_carlo_localization_tpu_torch/csrc/lut_likelihood.cu",
            "replaces": "monte_carlo_localization_tpu/ops/pallas_lut.py:499",
            **{k: k3[k] for k in keys},
            "max_abs_err": max(k3["max_abs_err"], lut_plain["max_abs_err"]["K3"]),
            "library_ms": None,
            "synthetic_times": lut_plain["times"]["K3"],
        },
        *dedup_entries,
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
        {
            "name": "lut_likelihood (fleet)",
            "route": "cuda",
            "source": "monte_carlo_localization_tpu_torch/csrc/lut_likelihood.cu",
            "replaces": "monte_carlo_localization_tpu/ops/pallas_lut.py:835-949",
            **{k: config5[k] for k in keys},
            "max_abs_err": max(config5["max_abs_err"], fleet_plain["max_abs_err"]),
            "library_ms": None,
            "config5_launches": config5["launches"],
        },
        *probe_entries(probes),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
