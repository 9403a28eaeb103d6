#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``csrc/`` (one nvcc per source,
in parallel), holds ``to_pixel_index`` on the card to the CPU bit for bit
on 10^6 half-pixel knife-edge ranges, holds the range-LUT sweep kernel
``torch.equal`` to its plain version (config #1's map, a Spielberg crop
in u8 and u16, all of Spielberg) and LUTs built on the card ``torch.equal``
to the native host builder (basement_fixed u8 and u16, config #5's
member compact LUTs), holds each kernel against its
plain PyTorch version on the card (the LUT likelihood with and without
the sub-bin lerp and on the shapes its lane layout makes edge cases,
its normaliser and sub-bin tables, the unique-window kernel and its key
kernel at 100k particles, the mega step on each side of its small-n
choice, the systematic resampler's kernel and the motion kernel each at
4000, 64 x 4000 and the resampler's longest row), replays the config #1 golden
trace through ``ParticleFilter`` on the classic step and on the mega step
(``pallas_mega``), drives the mega step at 4000 x 1080 on the same map,
replays the config #4 golden trace on basement_fixed (compact LUT) with and without ``pallas_subbin`` from 15 replay seeds, runs
config #4 global localization at 100k particles with and without the
unique-window kernel (``pallas_dedup_slots``, once with
``pallas_dedup_matmul``) and 15 more start poses without it, drives
the 4000-particle x 1080-beam Spielberg headline shape, holds the fleet
form of the LUT kernel against its plain version, runs config #5 (a
``FleetFilter`` of 64 cars x 4000 particles over 4 maps, bench.py
``bench_fleet``'s counterpart), drives the single-filter runtime through
the port's command line (``cli.main``: config #1 replayed one correction
per scan with a sink and a checkpoint, chained with and without the mega
step, resumed from a checkpoint; the u16 golden trace on basement_fixed;
ten seconds of ``live`` with async chunked corrections), replays config
#1 through an ``MCLNode`` with Augmented-MCL injection and times its
``profile_phases``, replays config #1 under the ``lut``, ``sphere`` and
``dda`` methods and drives the Spielberg headline under ``lut``, and runs
the probes of ``tools/mega_probe.py`` through their Hopper kernels. It
also drives config #5's workload through the fleet robot loop
(``FleetNode``: async at depth 4 for 8 s as bench.py ``bench_fleet_live``,
synchronous, and under a ``LiveRunner``), and the runtime's I/O on config
#1 (``cli export-bag`` and ``import-bag`` of the golden trace, a replay of
the imported trace, ``live --serve`` polled from a second thread, and
``replay --viz-out`` where PIL imports); ``lut_build`` also builds a
corridor whose rows pass the longest line the sweep kernel keeps in
shared memory (the kernel keeps such lines' distances in global memory)
against the native builder, and times a 2048-row hall with such rows
against the plain sweep. It runs the sharded filter
(``parallel/sharded.py``) on config #4's global localization at 100k
particles: over an NCCL process group of one in this process (as graphs
and eagerly, with eager/graph pairs beside a one-shard world's and the
single filter's), and over two processes sharing the card through gloo
(spawned by ``parallel/multihost.py`` ``spawn``; NCCL refuses two ranks
on one GPU; eager, as every step over gloo is), holding the bucketed
resampler ``torch.equal`` to the all-gather and an overflowed chunk's
re-run likewise; config #5 across two processes (``MultiHostFleet``, 32
cars each, their own scans, each step a graph held to its eager run, the
pose table gathered and held bit for bit to the one-process fleet on the
same draws); and
``cli baseline`` (the CPU reference harness) on config #1's trace, on
the host CPU. Its ``bench`` phase drives the port's benchmark harness
(``monte_carlo_localization_tpu_torch/bench.py``) on the workloads the
other phases do not: config #2, 1,000,000 particles chained and
converging, the giant fleet over two basement-class maps (its kernel held
against the plain version), the three kidnap arms, the live loop at
chunks 1, 8 and 32 and the synthetic headline, then
``tools/mega_ab.py`` on Spielberg's 12.3 GB dense LUT (the mega kernel
held against its plain version there), ``tools/perf_ablate.py`` and the
three examples. Every LUT is built on
the card, and each path that builds one is gated on the sweep kernel's
launches. Every filter step above runs as the replay of a CUDA graph
(``utils/graphs.py``), the default on a card; the ``graphs`` phase holds
each graphed program (the classic ``step_many`` under K1, K2, K3, K4,
K5, ``lut``, ``sphere`` and ``dda``, the one-correction step, the
injection step, the mega chain on each side of its cooperative launch,
the fleet's ``step`` and ``step_many``; the sharded filter's ``step``
and ``step_many`` over an NCCL group of one and in a one-shard world, a
fleet's on a 1 x 1 NCCL fleet x particle mesh) ``torch.equal`` to its
eager run under ``disable_graphs()`` over 12 chained corrections, on
given draws and on the generators' own, with launches and collective
calls and bytes as eager's, and prints eager against graph in the same
call (wall ms, kernels and idle share a correction, capture ms, pool
bytes) on config #1 (classic, mega, ``sphere``, ``dda``), the
headline, config #4 at 100k with and without dedup, 1M and config #5.
Each phase prints
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

import contextlib
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))
try:
    from monte_carlo_localization_tpu_torch.bench import (
        _beams,
        _convergence_truths,
        _drift_threshold,
        _fleet_inputs,
        _start_pose,
        _synth_scan,
    )
    from monte_carlo_localization_tpu_torch.utils.timing import device_ms, event_ms, profile_run
except ModuleNotFoundError as exc:
    sys.exit(f"chip_smoke: run from a checkout of the repository ({exc})")
KERNEL_TOL = 1e-3  # float32, same expressions; FMA contraction and sum order differ
CONFIG1_RMSE_MAX = 0.075  # m, ~1.5x the 0.0486 m the JAX engine records (BENCHES.md)
# The config #4 trace ends in a long corridor where the filter slides
# along the axis by chance: one replay's xy RMSE moves with the seed
# (0.069-0.185 m over 5 seeds on the H100, 4000 particles) and with the
# last bit of the kernels' rounding. So the gate holds the median of 15
# replay seeds at 1.5x the 0.0740 m the JAX engine records for one run
# (BENCHES.md); the exact-DDA CPU reference harness scores 0.1164 m on
# this trace.
CONFIG4_RMSE_MAX = 0.111  # m
CONFIG4_JAX_RMSE = 0.0740  # m, TPU v5e, one seed (BENCHES.md)
CONFIG4_SEEDS = tuple(range(15))
N_PARTICLES = 4000
CONFIG4_PARTICLES = 100_000  # BASELINE.json config #4
DEDUP_SLOTS = 16
CONVERGE_TRIALS = 5  # bench.py bench_convergence
# start poses past the bench's five, drawn on from the same stream, run
# without dedup: 20 in all, beside the JAX engine's 4 of 5 (bench) and 15
# of 20 (the kidnap protocol's phase 1 on this map, BENCHES.md)
CONVERGE_MORE = 15
JAX_CONVERGED = {"bench, 5 trials": "4 of 5", "kidnap phase 1, 20 trials": "15 of 20"}
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
# float32 operations per beam term (each add, multiply, compare, select,
# conversion, division and transcendental as one), counted from
# csrc/beam_model.cuh; the beam sum adds one double add per term.
# Tabled (integer LUT entries: the normaliser is a table read): convert and
# clip the entry, its table index, the hit term (subtract, two multiplies,
# exp, multiply), the short term (compare, subtract, multiply, fma,
# select), the max and rand terms (compare, add, select each), fmax, log,
# subtract. Sub-bin table (K3): the same, with the second entry's
# conversion, the segment read for the table index (scale, ceil,
# subtract, convert, read, three FMAs: +6) and the short term's
# reciprocal (fmax, reciprocal). Analytic (a range past the tables' cap):
# the tabled term with the short term's division, plus log_norm: two
# erf_as (a division, a reciprocal, an exp and 11 more each) and a log.
OPS_PER_BEAM_TABLED = 23
OPS_PER_BEAM_SUBBIN = 32
OPS_PER_BEAM_ANALYTIC = 80
OPS_PER_LERP = 3  # the sub-bin lerp: subtract, multiply, add
OPS_PER_PARTICLE_KEY = 14  # window key: K1's address math, the start, a shift
OPS_PER_PARTICLE_K1 = 12  # address: 2 sub, 2 div, casts, compares, rint, fix-ups
OPS_PER_PARTICLE_K6 = 60  # + motion (sin/cos, chord, noise, wrap) and moments
# the motion kernel a particle: the row's (dt, v, omega) (13), the arc
# branch (16: chord, midpoint, two sines, a cosine), the noise (6), the
# wrap's sine, cosine and atan2 (3)
OPS_PER_PARTICLE_MOTION = 38
# config #5 (BASELINE.json, bench.py CONFIGS[5] / CONFIG_MAPS[5])
CONFIG5_MAPS = ("map_1753950572.yaml", "icra_2_clean.yaml", "first_map.yaml", "new_map1.yaml")
CONFIG5_FLEET = 64
CONFIG5_CHAIN = 10  # bench_fleet: chain 10, 3 rounds of 3 reps, 3 rounds of 20 steps
CONFIG5_ROUNDS, CONFIG5_REPS, CONFIG5_ITERS = 3, 3, 20
FLEET_KERNELS_MAX = 1.5  # fleet device kernels per correction / config #1 classic's
SECTOR_BYTES = 32  # the granule of a global-memory read
# the normaliser and sub-bin tables against their plain versions: CUDA's
# expf/logf and torch's differ by an ulp of values near 1
TABLE_TOL = 2e-6
# the sub-bin table read at any range against the analytic device
# function: its 5.1e-7 budget (r * inv_squash * error <= 2.5e-4 at 1080
# beams, tests/test_torch_subbin_table.py) and an ulp
SUBBIN_READ_TOL = 1e-6


def emit(phase: str, t0: float, **fields) -> None:
    print(json.dumps({"phase": phase, "seconds": time.perf_counter() - t0, **fields}), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


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
        nccl_us_per_correction=sum(us for k, (us, _) in rows.items()
                                   if k.startswith("nccl")) / steps,
    )


def bound(bytes_moved: float, f32_ops: float, f64_ops: float) -> dict:
    """Least time on an H100 SXM: the larger of bytes over HBM bandwidth
    and operations over the peak rates of their types."""
    mem = bytes_moved / HBM_BYTES_PER_S * 1e3
    ops = (f32_ops / F32_OPS_PER_S + f64_ops / F64_OPS_PER_S) * 1e3
    return dict(bound_ms=max(mem, ops), bound_by="bytes" if mem >= ops else "operations",
                bytes=bytes_moved, f32_ops=f32_ops, f64_ops=f64_ops)


def lut_bound(n: int, n_on: int, r: int, itemsize: int, row_map: bool,
              windows: int | None = None, subbin: bool = False,
              sectors: int | None = None) -> dict:
    """K1-K5: particles in, log weights out, obs + offsets, the LUT
    entries of each distinct on-map window (``windows``, default one per
    on-map particle; the entry and its +1 neighbour with the sub-bin lerp)
    and each on-map particle's row_map entry; the beam model per beam of
    each on-map particle: the tabled term, or with the sub-bin lerp the
    sub-bin table's (no query timed here has a range past the tables'
    cap).
    With ``sectors`` (the distinct 32 B sectors the cloud's beams touch,
    :func:`lut_reads`) also ``sector_bytes`` and ``sector_bound_ms``: the
    same bound with the LUT counted in the sectors a read moves instead of
    entries."""
    windows = n_on if windows is None else windows
    entries = windows * r * (2 if subbin else 1)
    other = 12 * n + 4 * n + 8 * r + n_on * (4 if row_map else 0)
    ops_beam = OPS_PER_BEAM_SUBBIN + OPS_PER_LERP if subbin else OPS_PER_BEAM_TABLED
    f32, f64 = n * OPS_PER_PARTICLE_K1 + n_on * r * ops_beam, n_on * r
    out = bound(other + entries * itemsize, f32, f64)
    if sectors is not None:
        by_sector = bound(other + sectors * SECTOR_BYTES, f32, f64)
        out.update(sector_bytes=sectors * SECTOR_BYTES, sector_bound_ms=by_sector["bound_ms"],
                   sector_bound_by=by_sector["bound_by"])
    return out


def lut_reads(q, start, oob) -> tuple[int, int]:
    """(distinct windows, distinct 32 B sectors) the on-map particles'
    beams read, from each particle's flat window start: what this cloud's
    data needs of the LUT, in entries and in the granule a read moves."""
    import torch

    start = torch.unique(start[~oob])
    itemsize = q.lut_dtype.itemsize
    off = q.beam_offsets.to(torch.int64)
    if q.subbin:
        off = torch.unique(torch.cat([off, off + 1]))
    parts = [torch.unique(((chunk[:, None] + off[None, :]) * itemsize) // SECTOR_BYTES)
             for chunk in torch.split(start, 1 << 14)]  # bounded scratch: 16k windows x R
    sectors = int(torch.unique(torch.cat(parts)).numel()) if parts else 0
    return int(start.numel()), sectors


def cloud_reads(q, particles, row_map) -> tuple[int, int]:
    """:func:`lut_reads` of a single-map cloud."""
    import torch

    from monte_carlo_localization_tpu_torch.ops.lut_query import window_start

    row, b0, _, oob = window_start(q, particles, row_map)
    return lut_reads(q, row * q.row_stride + b0.to(torch.int64), oob)


def mega_bound(n: int, n_on: int, r: int, itemsize: int) -> dict:
    """K6: particles, log weights and noise in; proposal, log weights and
    sums out; obs, offsets, scalars; one LUT entry per beam of each on-map
    proposal."""
    b = (12 + 4 + 12) * n + (12 + 4) * n + 8 * r + 64 + n_on * r * itemsize
    f64 = n_on * r + 7 * n  # beam sums, the CDF and the moment sums
    f32 = n * (OPS_PER_PARTICLE_K6 + 2 * math.ceil(math.log2(n))) + n_on * r * OPS_PER_BEAM_TABLED
    return bound(b, f32, f64)


# ---- the range-LUT builds (csrc/range_lut_sweep.cu) ------------------------

# float32 operations per (cell, physical bin) of the shear sweep: the add,
# the occupied select, the multiply, the subtract, the two clips, the +0.5
# and the conversion (every cell is swept, whether its row is stored or not)
OPS_PER_SWEEP_ENTRY = 8
LUT_CROP = 400  # cells a side of the Spielberg crop held against the plain sweep
SWEEP_LAUNCHES: dict[str, int] = {}  # main-path sweep launches, by phase
CARD = ""  # the card's name and power limit (nvidia-smi), printed beside the times


def sweep_reset() -> None:
    """Set the sweep kernel's count to 0 before a path builds its LUT."""
    from monte_carlo_localization_tpu_torch.ops.range_lut_sweep import sweep

    sweep.launch_count = 0


def lut_built_on_card(what: str, gm) -> dict:
    """The route, seconds and sweep launches of the LUT ``gm`` carries,
    built since :func:`sweep_reset`: the path's LUT must come from the
    sweep kernel on the card."""
    from monte_carlo_localization_tpu_torch.ops.range_lut_sweep import sweep

    n = sweep.launch_count
    check(gm.lut_route == "kernel" and n > 0,
          f"{what}: LUT built by {gm.lut_route!r} with {n} sweep launches (want the kernel)")
    SWEEP_LAUNCHES[what] = SWEEP_LAUNCHES.get(what, 0) + n
    lut = gm.range_lut
    return dict(lut_route=gm.lut_route, lut_build_s=gm.lut_build_s, sweep_launches=n,
                lut_bytes=lut.numel() * lut.element_size())


def sweep_bound(cells: int, stride: int, rel_bytes: int, stored_rows: int, itemsize: int,
                compact: bool) -> dict:
    """One LUT build by the sweep: the occupancy grid (and a compact LUT's
    row map) read once, the groups' drift tables (``rel_bytes``) and per-bin
    step and bin, the LUT entries it stores written once;
    OPS_PER_SWEEP_ENTRY operations per (cell, bin)."""
    read = cells + (4 * cells if compact else 0) + rel_bytes + 8 * stride
    written = stored_rows * stride * itemsize
    out = bound(read + written, cells * stride * OPS_PER_SWEEP_ENTRY, 0.0)
    out.update(write_bytes=written, write_bound_ms=written / HBM_BYTES_PER_S * 1e3)
    return out


def lut_geometry(beams: np.ndarray, max_range_px: int):
    """(T, row stride, itemsize) of the fused likelihood's LUT for a beam set."""
    from monte_carlo_localization_tpu_torch.mapping.range_lut import lut_dtype
    from monte_carlo_localization_tpu_torch.ops.lut_query import (
        required_row_stride,
        suggest_theta_bins,
    )

    itemsize = lut_dtype(max_range_px).itemsize
    t = suggest_theta_bins(beams)
    return t, required_row_stride(t, beams, itemsize), itemsize


def sweep_vs_plain(what: str, occ, t: int, stride: int, max_range_px: int,
                   compact: bool) -> dict:
    """One build by the kernel and by the plain sweep on the same card
    inputs, held ``torch.equal``; the kernel's device ms per launch, the
    plain build's seconds and the build's bound."""
    import torch

    from monte_carlo_localization_tpu_torch.mapping import clearance_field
    from monte_carlo_localization_tpu_torch.mapping.range_lut import lut_dtype
    from monte_carlo_localization_tpu_torch.mapping.range_lut_device import (
        FAR_ROW_MARGIN,
        build_compact_range_lut_device,
        build_range_lut_device,
        compact_row_map,
        shear_groups,
    )
    from monte_carlo_localization_tpu_torch.ops.range_lut_sweep import sweep

    h, w = occ.shape
    dt = lut_dtype(max_range_px)
    if compact:
        clr = clearance_field(occ.cpu().numpy(), max_range_px + FAR_ROW_MARGIN + 2)
        rows = int(compact_row_map(clr, max_range_px)[1].size)

        def build(plain=False):
            return build_compact_range_lut_device(occ, clr, t, max_range_px, stride,
                                                  lut_dtype=dt, plain=plain)[0]
    else:
        rows = h * w

        def build(plain=False):
            return build_range_lut_device(occ, t, max_range_px, stride, plain=plain)
    groups = shear_groups(h, w, t, stride)
    launches = len(groups)
    plans = [sweep.plan(*((h, w) if g.row_major else (w, h)), g.bins, dt.itemsize, max_range_px,
                        occ.device) for g in groups]
    before = sweep.launch_count
    got = build()
    torch.cuda.synchronize()
    check(sweep.launch_count - before == launches, f"{what}: {sweep.launch_count - before} "
          f"sweep launches for {launches} bin groups")
    t0 = time.perf_counter()
    want = build(plain=True)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    equal = torch.equal(got, want)
    diff = 0 if equal else max(  # in chunks: an int32 copy of a 10 GB LUT would not fit
        int((a.to(torch.int32) - b.to(torch.int32)).abs().max())
        for a, b in zip(got.view(-1).split(1 << 28), want.view(-1).split(1 << 28)))
    check(equal, f"{what}: sweep kernel != plain sweep (max |diff| {diff})")
    del want
    dev = device_ms(build, "range_lut_sweep_kernel", iters=2)
    sweep.launch_count = before  # comparison launches do not count
    bnd = sweep_bound(h * w, stride, sum(g.rel.nbytes for g in groups), rows, dt.itemsize,
                      compact)
    warm = sum(p["tiles"] * p["warm_lines"] for p in plans)
    return dict(map=f"{h}x{w}", t_bins=t, row_stride=stride, max_range_px=max_range_px,
                lut=("compact " if compact else "dense ") + str(got.dtype), rows=rows,
                equal=equal, max_abs_err=float(diff), launches_per_build=launches,
                blocks_per_launch=[p["blocks"] for p in plans],
                tiles_per_launch=[p["tiles"] for p in plans], tile_bytes=plans[0]["tile_bytes"],
                chunk_lines=[p["lines"] for p in plans], slots=plans[0]["slots"],
                threads=plans[0]["threads"],
                warm_share=[round(p["warm_share"], 4) for p in plans],
                warm_share_build=warm / (warm + sum(p["tiles"] * p["p_len"] for p in plans)),
                ms=dev["ms"], time_source=dev["source"], build_device_ms=dev["ms"] * launches,
                plain_ms=plain_s * 1e3 / launches, plain_build_s=plain_s,
                bound_ms=bnd["bound_ms"] / launches, bound_by=bnd["bound_by"],
                build_bound_ms=bnd["bound_ms"], write_bytes=bnd["write_bytes"],
                write_bound_ms=bnd["write_bound_ms"])


def native_lut(gm) -> np.ndarray:
    """The native host builder's flat LUT for the one ``gm`` carries
    (dense or compact, one map or tight member blocks), built from the
    map's occupancy and, for a compact LUT, its row map: the oracle of a
    card build. Checks that the member blocks start at the bases the card
    build recorded."""
    from monte_carlo_localization_tpu_torch.mapping.range_lut import build_range_lut, lut_dtype
    from monte_carlo_localization_tpu_torch.native import native_build_compact_range_lut

    occ = gm.occupied.cpu().numpy()
    t, stride, mrp = gm.lut_theta_bins, gm.row_stride, gm.max_range_px
    if gm.is_batched:
        blocks = [occ[i, :h, :w] for i, (h, w) in enumerate(gm.member_dims.tolist())]
    else:
        blocks = [occ]
    row_map = None if gm.lut_row_map is None else gm.lut_row_map.cpu().numpy()
    out, cell0 = [], 0
    for o in blocks:
        if row_map is None:
            out.append(build_range_lut(o, t, mrp, backend="native", row_stride=stride))
        else:
            out.append(native_build_compact_range_lut(o, t, mrp, row_map[cell0:cell0 + o.size],
                                                      stride, dtype=lut_dtype(mrp)))
        cell0 += o.size
    if gm.is_batched:
        eps = 512 // lut_dtype(mrp).itemsize
        bases = np.cumsum([0] + [b.size // eps for b in out[:-1]])
        check(np.array_equal(gm.lut_member_base.cpu().numpy(), bases),
              "member LUT bases differ from the native blocks' starts")
    return np.concatenate([b.reshape(-1) for b in out])


def card_vs_native(what: str, card) -> dict:
    """A LUT built on the card (``card``, a map that carries it) by the
    sweep kernel against :func:`native_lut`, uploaded: ``torch.equal``,
    with each build's seconds."""
    import torch

    check(card.lut_route == "kernel", f"{what}: the card build took {card.lut_route!r}, "
          "want 'kernel'")
    t0 = time.perf_counter()
    host = native_lut(card)
    native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = torch.from_numpy(host).to(card.range_lut.device)
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    del host
    lut = card.range_lut
    check(torch.equal(lut.view(-1), want), f"{what}: the card build != the native build")
    nbytes = lut.numel() * lut.element_size()
    out = dict(lut=("compact " if card.lut_row_map is not None else "dense ") + str(lut.dtype),
               lut_bytes=nbytes, equal=True, card_build_s=card.lut_build_s,
               native_build_s=native_s, upload_s=upload_s,
               write_bound_ms=nbytes / HBM_BYTES_PER_S * 1e3)
    del want
    torch.cuda.empty_cache()
    return out


def phase_lut_build(device) -> dict:
    """The sweep kernel against its plain version (``torch.equal``) on
    config #1's map (dense u8, stride T and padded), a 400 x 400 crop of
    Spielberg (compact u8, and compact u16 at 25.6 m) and the whole of
    Spielberg at the headline geometry (compact u8, 1080 beams: the
    kernel's times) and as the ``lut`` method's dense 1440-bin LUT
    (5.76 GB, offsets past 2^31); full-size card LUTs against the native
    host builder on basement_fixed (compact u8, past 2^31 bytes) and at
    the u16 golden trace's 25.6 m (compact u16), and config #5's four
    maps at its geometry, tight member blocks compact and dense (the
    fleet's own LUT)."""
    import torch

    from monte_carlo_localization_tpu_torch import load_map
    from monte_carlo_localization_tpu_torch.parallel import stack_maps
    from monte_carlo_localization_tpu_torch.runtime import Trace

    t0 = time.perf_counter()
    plain = {}
    gm1 = load_map(REPO / CONFIG1_MAP, device=device)
    beams1 = Trace.load(REPO / CONFIG1_TRACE).beam_angles[::18]
    t1, s1, _ = lut_geometry(beams1, gm1.max_range_px)
    plain["config1_dense_T"] = sweep_vs_plain("config #1 dense, stride T", gm1.occupied, t1, t1,
                                              gm1.max_range_px, False)
    plain["config1_dense_padded"] = sweep_vs_plain("config #1 dense, padded", gm1.occupied, t1,
                                                   s1, gm1.max_range_px, False)
    spiel = load_map(REPO / "maps" / "Spielberg_map.yaml", device=device)
    beams = _beams(1080)
    free = spiel.free_cells[: spiel.num_free].float().median(dim=0).values.long().tolist()
    r0 = min(max(free[0] - LUT_CROP // 2, 0), spiel.height - LUT_CROP)
    c0 = min(max(free[1] - LUT_CROP // 2, 0), spiel.width - LUT_CROP)
    crop = spiel.occupied[r0:r0 + LUT_CROP, c0:c0 + LUT_CROP].contiguous()
    for name, range_m in (("crop_compact_u8", 12.0), ("crop_compact_u16", U16_MAX_RANGE)):
        mrp = int(range_m / spiel.resolution)
        t, stride, _ = lut_geometry(beams, mrp)
        plain[name] = sweep_vs_plain(f"Spielberg crop {name}", crop, t, stride, mrp, True)
    t, stride, _ = lut_geometry(beams, spiel.max_range_px)
    head = sweep_vs_plain("Spielberg compact u8 (headline)", spiel.occupied, t, stride,
                          spiel.max_range_px, True)
    plain["spielberg_compact_u8"] = head
    # the methods phase's headline LUT: ParticleFilter(raycast_method="lut")
    # attaches the dense DEFAULT_THETA_BINS (1440) LUT at stride T
    plain["spielberg_dense_1440"] = sweep_vs_plain(
        "Spielberg dense, T = 1440 (the lut method's headline)", spiel.occupied, 1440, 1440,
        spiel.max_range_px, False)
    del spiel, crop
    torch.cuda.empty_cache()

    native = {}
    for name, yaml_name, trace, range_m in (
        ("basement_u8", "basement_fixed.map.yaml", "config4_basement_fixed.npz", 12.0),
        ("basement_u16", "basement_fixed.map.yaml", "u16_basement.npz", U16_MAX_RANGE),
    ):
        gm = load_map(REPO / "maps" / yaml_name, max_range_meters=range_m, device=device)
        b = Trace.load(REPO / "traces" / trace).beam_angles[::18]
        t, stride, itemsize = lut_geometry(b, gm.max_range_px)
        native[name] = card_vs_native(name, gm.with_compact_range_lut(t, stride))
        native[name].update(max_range_px=gm.max_range_px, t_bins=t, row_stride=stride)
        del gm
    check(native["basement_u8"]["lut_bytes"] > 2**31, "basement's compact LUT should pass 2^31 B")
    maps = [load_map(REPO / "maps" / name, device=device) for name in CONFIG5_MAPS]
    t, stride, itemsize = lut_geometry(_beams(60), maps[0].max_range_px)
    eps = 512 // itemsize
    fleet = stack_maps(maps)
    native["config5_member_compact"] = card_vs_native(
        "config #5 member compact", fleet.with_member_compact_luts(t, stride, eps))
    native["config5_member_dense"] = card_vs_native(
        "config #5 member dense (the fleet's LUT)", fleet.with_member_luts(t, stride, eps))
    del maps, fleet
    torch.cuda.empty_cache()
    native["long_line_corridor"] = long_line_build(device)
    plain["long_line_hall"] = long_line_hall(device)
    emit("lut_build", t0, card=CARD, hbm_bytes_per_s=HBM_BYTES_PER_S, kernel_vs_plain=plain,
         card_vs_native=native)
    return dict(max_abs_err=max(v["max_abs_err"] for v in plain.values()),
                **{k: head[k] for k in ("ms", "time_source", "plain_ms", "bound_ms", "bound_by",
                                         "build_device_ms", "build_bound_ms", "write_bound_ms",
                                         "plain_build_s", "blocks_per_launch",
                                         "warm_share_build")})


LONG_LINE_MAP = dict(height=64, width=15_000)  # cells: a 750 m corridor at 0.05 m
LONG_LINE_HALL = dict(height=2048, width=15_000)  # cells: a 102 m x 750 m hall at 0.05 m


def long_line_plans(gm, t: int, stride: int, itemsize: int) -> list[dict]:
    """The sweep kernel's launch plan of each bin group of ``gm``'s LUT:
    its line length, where D lies, grid and scratch."""
    from monte_carlo_localization_tpu_torch.mapping.range_lut_device import shear_groups
    from monte_carlo_localization_tpu_torch.ops.range_lut_sweep import sweep

    out = []
    for g in shear_groups(gm.height, gm.width, t, stride):
        p_len, q_len = (gm.height, gm.width) if g.row_major else (gm.width, gm.height)
        plan = sweep.plan(p_len, q_len, g.bins, itemsize, gm.max_range_px, gm.occupied.device)
        out.append({k: plan[k] for k in ("p_len", "global_d", "words", "tiles", "lines",
                                        "blocks", "grid", "scratch_bytes")} | dict(q_len=q_len))
    return out


def long_line_build(device) -> dict:
    """The dense LUT of a corridor whose rows (15,000 cells) pass
    MAX_LINE_CELLS, the longest line whose distances the sweep kernel
    keeps in shared memory, at the 60-beam geometry's T, built on the
    card: every group through the kernel (the row groups with D in global
    memory), held ``torch.equal`` to the native host builder's."""
    import torch

    from monte_carlo_localization_tpu_torch.mapping import corridor_world
    from monte_carlo_localization_tpu_torch.mapping.range_lut import lut_dtype
    from monte_carlo_localization_tpu_torch.ops.range_lut_sweep import MAX_LINE_CELLS

    gm = corridor_world(**LONG_LINE_MAP, device=device)
    check(gm.width > MAX_LINE_CELLS >= gm.height, "the corridor should have long rows only")
    t, _, _ = lut_geometry(_beams(60), gm.max_range_px)
    plans = long_line_plans(gm, t, t, lut_dtype(gm.max_range_px).itemsize)
    check(any(p["global_d"] for p in plans) and not all(p["global_d"] for p in plans),
          f"long lines: D in global memory for {[p['global_d'] for p in plans]} of the groups")
    sweep_reset()
    card = gm.with_range_lut(t, use_cache=False)
    built = lut_built_on_card("long_line_corridor", card)
    check(built["sweep_launches"] == len(plans),
          f"long lines: {built['sweep_launches']} sweep launches for {len(plans)} groups")
    out = card_vs_native("long-line corridor, dense", card)
    out.update(map=f"{gm.height}x{gm.width}", t_bins=t, max_line_cells=MAX_LINE_CELLS,
               lut_route=card.lut_route, sweep_launches=built["sweep_launches"], plans=plans)
    del card, gm
    torch.cuda.empty_cache()
    return out


def long_line_hall(device) -> dict:
    """A hall of 2048 rows of 15,000 cells (box_world, 12 m range) at the
    60-beam geometry, its compact LUT built by the kernel and by the plain
    sweep on the card (``sweep_vs_plain``): the long rows' groups sweep
    thousands of lines with D in global memory. Adds each mode's device
    ms per launch."""
    import torch

    from monte_carlo_localization_tpu_torch.mapping import box_world, clearance_field
    from monte_carlo_localization_tpu_torch.mapping.range_lut import lut_dtype
    from monte_carlo_localization_tpu_torch.mapping.range_lut_device import (
        FAR_ROW_MARGIN,
        build_compact_range_lut_device,
    )
    from monte_carlo_localization_tpu_torch.ops.range_lut_sweep import sweep
    from monte_carlo_localization_tpu_torch.utils.timing import profile_run

    gm = box_world(**LONG_LINE_HALL, device=device)
    t, stride, itemsize = lut_geometry(_beams(60), gm.max_range_px)
    plans = long_line_plans(gm, t, stride, itemsize)
    out = sweep_vs_plain("long-line hall, compact", gm.occupied, t, stride, gm.max_range_px,
                         True)
    clr = clearance_field(gm.occupied.cpu().numpy(), gm.max_range_px + FAR_ROW_MARGIN + 2)

    def build():
        return build_compact_range_lut_device(gm.occupied, clr, t, gm.max_range_px, stride,
                                              lut_dtype=lut_dtype(gm.max_range_px))[0]

    before = sweep.launch_count
    rows, _ = profile_run(build, 2)
    sweep.launch_count = before  # comparison launches do not count
    for mode, tag in (("global", "true>"), ("shared", "false>")):
        hits = [(us, n) for key, (us, n) in rows.items()
                if "range_lut_sweep_kernel" in key and tag in key]
        out[f"{mode}_d_ms"] = (sum(us for us, _ in hits) / 1e3 / sum(n for _, n in hits)
                               if hits else "not measured")
    out.update(plans=plans)
    del gm, clr
    torch.cuda.empty_cache()
    return out


def phase_methods(device) -> dict:
    """The ``lut``, ``sphere`` and ``dda`` likelihood methods: config #1
    through ``cli replay --chained --raycast <method>`` (gated as config
    #1), then the headline shape (Spielberg 4000 x 1080) under ``lut`` on
    its dense 1440-bin LUT built on the card, 50 chained corrections."""
    import torch

    from monte_carlo_localization_tpu_torch import MCLConfig, ParticleFilter, load_map
    from monte_carlo_localization_tpu_torch.ops.raycast import cast_rays_lut

    t0 = time.perf_counter()
    runs = {}
    for method in ("lut", "sphere", "dda"):
        sweep_reset()
        t1 = time.perf_counter()
        out, node = run_cli(["replay", "--device", str(device), "--map", str(REPO / CONFIG1_MAP),
                             "--trace", str(REPO / CONFIG1_TRACE), "--particles", str(N_PARTICLES),
                             "--init", "truth", "--chained", "--raycast", method])
        pf = node.filter
        check(pf.config.raycast_method == method and pf.likelihood is None,
              f"--raycast {method} ran {pf.config.raycast_method}")
        check(np.isfinite(node.inferred_pose).all(), f"--raycast {method}: non-finite pose")
        check(out["rmse_xy_m"] <= METHODS_RMSE_MAX,
              f"--raycast {method}: RMSE {out['rmse_xy_m']} m > {METHODS_RMSE_MAX}")
        runs[method] = dict(**out, seconds=time.perf_counter() - t1)
        if method == "lut":
            runs[method].update(lut_built_on_card("methods_config1_lut", pf.grid_map))
        del node, pf

    gm = load_map(REPO / "maps" / "Spielberg_map.yaml", device=device)
    sweep_reset()
    pf = ParticleFilter(gm, MCLConfig(max_particles=N_PARTICLES, raycast_method="lut"))
    lut = lut_built_on_card("methods_headline_lut", pf.grid_map)
    check(lut["lut_bytes"] == gm.height * gm.width * 1440,
          f"the headline lut method's LUT has {lut['lut_bytes']} B")
    beams = _beams(1080)
    pf.set_beam_angles(beams)
    pose = _start_pose(gm)
    beams_t = torch.as_tensor(beams, device=device)
    q = torch.stack([torch.full_like(beams_t, float(pose[0])),
                     torch.full_like(beams_t, float(pose[1])), float(pose[2]) + beams_t], 1)
    scan = cast_rays_lut(pf.grid_map, q).cpu().numpy()
    chain = 50
    actions = np.tile(np.float32([0.05, 0.0, 0.01]), (chain, 1))
    scans = np.tile(scan, (chain, 1))
    # warm-up at the timed shape: the chain's graph is captured here
    state, _ = pf.step_many(pf.init_pose(pose, seed=1), actions, scans)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    state, poses = pf.step_many(state, actions, scans)
    torch.cuda.synchronize()
    rate = chain / (time.perf_counter() - t2)
    poses = poses.cpu().numpy()
    check(np.isfinite(poses).all(), "the headline lut method gave non-finite poses")
    drift = float(np.linalg.norm(poses[-1, :2] - pose[:2]))
    emit("methods", t0, rmse_max_m=METHODS_RMSE_MAX, config1=runs,
         headline_lut=dict(particles=N_PARTICLES, beams=1080, theta_bins=1440, **lut,
                           corrections=chain, chained_updates_per_s=rate,
                           drift_from_start_m=drift))
    del pf, gm, state
    torch.cuda.empty_cache()
    return runs


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
    theta[:2] = (-2 * math.pi, 2 * math.pi)[: min(n, 2)]
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
            beams = _beams(num_beams)
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
                    check(not subbin or q.subbin_table_entries == 2 * max_range_px + 1,
                          f"{what}: K3 should read the sub-bin table")
                    check(bool(((got == -1e4) == (want == -1e4)).all()), f"{what}: off-map particles differ")
                    check(0 < oob < N_PARTICLES, f"{what}: case needs particles on and off the map")
                    check(err <= KERNEL_TOL, f"{what}: kernel vs plain {err} > {KERNEL_TOL}")
                    cases[kernel].append(dict(beams=num_beams, lut="u8" if max_range_px <= 254 else "u16",
                                              row_map=compact, off_map=oob, max_abs_err=err))
                    if max_range_px == 200 and not compact:
                        shape = f"{N_PARTICLES}x{num_beams}"
                        times[kernel][shape] = dict(
                            **dict(zip(("device_ms", "time_source"), device_ms(
                                lambda: q.launch(lut, parts, obs, row_map), "lut_loglik_kernel").values())),
                            wrapper_ms=event_ms(lambda: q.launch(lut, parts, obs, row_map)),
                            plain_ms=event_ms(lambda: lut_log_weights_reference(q, lut, parts, obs, row_map)),
                            **lut_bound(N_PARTICLES, N_PARTICLES - oob, num_beams, 1, False,
                                        subbin=subbin, sectors=cloud_reads(q, parts, row_map)[1]),
                        )
    # the shapes the lane layout makes edge cases: 16 lanes per particle up
    # to 64 beams and 32 past them, 8 or 16 particle groups per block, up
    # to as many consecutive particles per group as it has lanes
    edges = []
    for num_beams in (1, 31, 33, 60, 64, 65, 1080):
        for n in (1, 7, 4001) + {60: (300_007,), 1080: (70_001,)}.get(num_beams, ()):
            for max_range_px, compact, subbin in ((200, False, False), (400, True, False),
                                                  (200, True, True)):
                q, lut, parts, obs, row_map = synthetic_case(
                    rng, _beams(num_beams), max_range_px, compact, n, device, subbin=subbin)
                got = q.launch(lut, parts, obs, row_map)
                want = lut_log_weights_reference(q, lut, parts, obs, row_map)
                torch.cuda.synchronize()
                err = float((got - want).abs().max())
                what = f"edge {n} x {num_beams}, {max_range_px} px, compact={compact}, subbin={subbin}"
                check(bool(((got == -1e4) == (want == -1e4)).all()), f"{what}: off-map particles differ")
                check(err <= KERNEL_TOL, f"{what}: kernel vs plain {err} > {KERNEL_TOL}")
                edges.append(dict(particles=n, beams=num_beams, lut="u8" if max_range_px <= 254 else "u16",
                                  row_map=compact, subbin=subbin, off_map=int((want == -1e4).sum()),
                                  max_abs_err=err))
    # u16 entries far above ceil(m) read the table's last row
    q, lut, parts, obs, _ = synthetic_case(rng, _beams(60), 400, False, N_PARTICLES, device)
    big = torch.from_numpy(rng.integers(401, 65536, lut.numel() // 3).astype(np.uint16)).to(device)
    lut.view(torch.int16)[::3][: big.numel()] = big.view(torch.int16)
    got, want = q.launch(lut, parts, obs), lut_log_weights_reference(q, lut, parts, obs)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    check(q.table_entries == 401 and err <= KERNEL_TOL,
          f"u16 entries above max range: kernel vs plain {err} > {KERNEL_TOL}")
    edges.append(dict(particles=N_PARTICLES, beams=60, lut="u16 with entries up to 65535",
                      max_abs_err=err))
    # a range past the tables' cap keeps the analytic normaliser, and so
    # does the sub-bin lerp at a range that is not an integer
    for num_beams in (60, 1080):
        for max_range_px, subbin in ((2000, False), (2000, True), (198.4, True)):
            q, lut, parts, obs, row_map = synthetic_case(rng, _beams(num_beams), max_range_px,
                                                         True, N_PARTICLES, device, subbin=subbin)
            got = q.launch(lut, parts, obs, row_map)
            want = lut_log_weights_reference(q, lut, parts, obs, row_map)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            check(q.kernel_table(device) == (None, 0) and err <= KERNEL_TOL,
                  f"max range {max_range_px} px, {num_beams} beams, subbin={subbin}: "
                  f"kernel vs plain {err} > {KERNEL_TOL}")
            edges.append(dict(particles=N_PARTICLES, beams=num_beams, subbin=subbin,
                              lut=f"{'u16' if max_range_px > 254 else 'u8'}, analytic ({max_range_px} px)",
                              max_abs_err=err))
    emit("kernel_vs_plain", t0, tol=KERNEL_TOL, cases=cases, edge_cases=edges,
         synthetic_lut_times=times)
    worst = {k: max(c["max_abs_err"] for c in v) for k, v in cases.items()}
    for c in edges:
        kernel = "K3" if c.get("subbin") else "K1"
        worst[kernel] = max(worst[kernel], c["max_abs_err"])
    return dict(times=times, max_abs_err=worst)


def resample_bound(f: int, n: int, m: int) -> dict:
    """The systematic resampler from the softmax on (csrc/resample.cu):
    f rows of n float32 weights and an offset read once, f x m int32
    indices written; the doubling's double adds (n - s a round, s = 1,
    2, 4, ... < n) and g's two float32 operations an element. The
    searches' compares are not counted."""
    adds = sum(n - (1 << k) for k in range(max(n - 1, 0).bit_length()))
    return bound(4 * f * n + 4 * f + 4 * f * m, 2 * f * n, f * adds)


def phase_resample(device) -> dict:
    """The systematic resampler's kernel (``ops/resample.py``
    ``SystematicKernel``) ``torch.equal`` to the PyTorch path on the same
    softmax and u0, at the main path's 4000, config #5's 64 x 4000 and
    the kernel's longest row: the kernel's device ms, the PyTorch path's
    (``prefix_sum_doubling`` and ``systematic_invert_cdf_window``, as a
    graph), wrapper ms and the bound; and the whole resampler from the
    log weights (softmax, and the offset given) both ways, as graphs."""
    import torch

    from monte_carlo_localization_tpu_torch.ops.resample import (
        SYSTEMATIC_KERNEL,
        prefix_sum_doubling,
        systematic_invert_cdf_window,
        systematic_resample_indices,
        weight_cdf,
    )
    from monte_carlo_localization_tpu_torch.utils.timing import graph_ms

    t0 = time.perf_counter()
    cap = SYSTEMATIC_KERNEL.max_row(device)
    rng = np.random.default_rng(0)
    calls = []
    for f, n in ((1, N_PARTICLES), (CONFIG5_FLEET, N_PARTICLES), (1, cap)):
        shape = (n,) if f == 1 else (f, n)
        lw = torch.from_numpy(rng.normal(scale=2.0, size=shape).astype(np.float32)).to(device)
        lw[..., : n // 7] = -1e4  # a run of off-map particles
        u0 = torch.rand(shape[:-1], device=device)
        w = torch.softmax(lw, -1)
        launches = SYSTEMATIC_KERNEL.launch_count
        got = SYSTEMATIC_KERNEL(w, u0, n)
        want = systematic_invert_cdf_window(prefix_sum_doubling(w), u0, n, 0, n)
        torch.cuda.synchronize()
        check(SYSTEMATIC_KERNEL.launch_count == launches + 1, "resample: the kernel did not launch")
        check(torch.equal(got, want), f"resample: kernel != PyTorch path at {shape}")
        timed = device_ms(lambda: SYSTEMATIC_KERNEL(w, u0, n), "systematic_resample_kernel")
        calls.append({
            "label": f"{f} x {n}", "ms": timed["ms"], "time_source": timed["source"],
            "wrapper_ms": event_ms(lambda: SYSTEMATIC_KERNEL(w, u0, n)),
            "plain_ms": graph_ms(
                lambda: systematic_invert_cdf_window(prefix_sum_doubling(w), u0, n, 0, n)),
            "whole_kernel_ms": graph_ms(lambda: systematic_resample_indices(lw, u0=u0)),
            "whole_torch_ms": graph_ms(
                lambda: systematic_invert_cdf_window(weight_cdf(lw), u0, n, 0, n)),
            **resample_bound(f, n, n),
        })
    emit("resample", t0, max_row=cap, launches=SYSTEMATIC_KERNEL.launch_count, calls=calls)
    return dict(launches=SYSTEMATIC_KERNEL.launch_count, calls=calls, max_row=cap)


def motion_bound(f: int, n: int) -> dict:
    """The motion kernel (csrc/motion.cu) on f rows of n particles:
    particles, indices and noise read once a particle and the actions once
    a row, the proposal written once; OPS_PER_PARTICLE_MOTION float32
    operations a particle."""
    return bound(12 * f * n + 4 * f * n + 12 * f * n + 12 * f + 12 * f * n,
                 OPS_PER_PARTICLE_MOTION * f * n, 0)


def phase_motion(device) -> dict:
    """The motion kernel (``ops/motion.py`` ``MotionKernel``) ``torch.equal``
    to the plain version (the rows' gather and ``motion_model_plain``) on
    the same particles, indices, actions and noise, at the main path's
    4000, config #5's 64 x 4000 (one action a member, a strided noise
    slice) and the resampler kernel's longest row: the kernel's device ms,
    the plain chain's (as a graph), wrapper ms and the bound; and the
    whole motion phase from the indices (the noise drawn) both ways, as
    graphs."""
    import torch

    from monte_carlo_localization_tpu_torch.models.motion import (
        gather_rows,
        motion_model,
        motion_model_plain,
    )
    from monte_carlo_localization_tpu_torch.ops.motion import MOTION_KERNEL
    from monte_carlo_localization_tpu_torch.ops.resample import SYSTEMATIC_KERNEL
    from monte_carlo_localization_tpu_torch.utils.timing import graph_ms

    t0 = time.perf_counter()
    disp = (0.05, 0.025, 0.25)
    rng = np.random.default_rng(0)
    calls = []
    for f, n in ((1, N_PARTICLES), (CONFIG5_FLEET, N_PARTICLES),
                 (1, SYSTEMATIC_KERNEL.max_row(device))):
        lead = (f,) if f > 1 else ()
        p = np.stack([rng.uniform(-60, 60, lead + (n,)), rng.uniform(-60, 60, lead + (n,)),
                      rng.uniform(-7, 7, lead + (n,))], axis=-1).astype(np.float32)
        particles = torch.from_numpy(p).to(device)
        idx = torch.from_numpy(rng.integers(0, n, lead + (n,)).astype(np.int32)).to(device)
        acts = rng.uniform(-0.1, 0.1, lead + (3,)).astype(np.float32)
        action = torch.from_numpy(acts).to(device)
        noise = torch.randn(lead + (2 * n, 3), device=device)[..., n // 2:n // 2 + n, :]
        launches = MOTION_KERNEL.launch_count
        got = MOTION_KERNEL(particles, action, noise, disp, True, idx)
        want = motion_model_plain(gather_rows(particles, idx), action, *disp, noise=noise)
        torch.cuda.synchronize()
        check(MOTION_KERNEL.launch_count == launches + 1, "motion: the kernel did not launch")
        check(torch.equal(got, want), f"motion: kernel != plain version at {f} x {n}")
        timed = device_ms(lambda: MOTION_KERNEL(particles, action, noise, disp, True, idx),
                          "motion_kernel")
        calls.append({
            "label": f"{f} x {n}", "ms": timed["ms"], "time_source": timed["source"],
            "wrapper_ms": event_ms(
                lambda: MOTION_KERNEL(particles, action, noise, disp, True, idx)),
            "plain_ms": graph_ms(lambda: motion_model_plain(
                gather_rows(particles, idx), action, *disp, noise=noise)),
            "whole_kernel_ms": graph_ms(
                lambda: motion_model(particles, action, *disp, indices=idx)),
            "whole_torch_ms": graph_ms(
                lambda: motion_model_plain(gather_rows(particles, idx), action, *disp)),
            **motion_bound(f, n),
        })
    emit("motion", t0, launches=MOTION_KERNEL.launch_count, calls=calls)
    return dict(launches=MOTION_KERNEL.launch_count, calls=calls)


def phase_norm_table(device) -> dict:
    """The normaliser table the kernels read (log_norm_kernel): against its
    plain version within TABLE_TOL, bit for bit against the analytic
    device function at every entry value. The sub-bin table K3 reads
    (subbin_norm_kernel): against its plain version within TABLE_TOL, its
    integer nodes bit for bit the normaliser table of the same range, read
    at any range within SUBBIN_READ_TOL of the analytic device function.
    End to end: the sub-bin kernel on headings whose fractional bin is 0
    must give the table kernel's bits."""
    import torch

    from monte_carlo_localization_tpu_torch.ops.lut_query import (
        _log_norm,
        log_norm_table,
        subbin_log_norm,
        subbin_norm_table,
    )
    from monte_carlo_localization_tpu_torch.utils.timing import graph_ms

    t0 = time.perf_counter()
    rng = np.random.default_rng(6)
    cases = []
    timed = None
    for max_range_px in (200, 400, 198.4):
        q = synthetic_case(rng, _beams(60), max_range_px, False, 8, device)[0]
        q.table_launch_count = 0
        table = q.norm_table(device)
        check(q.table_launch_count == 1 and q.norm_table(device) is table,
              "the table is filled once per query and device")
        plain = log_norm_table(q, device)
        check(tuple(table.shape) == tuple(plain.shape) == (math.ceil(max_range_px) + 1, 2),
              f"table shape {tuple(table.shape)}")
        err = float((table[:, 0] - plain[:, 0]).abs().max())
        check(err <= TABLE_TOL, f"table vs plain at m={max_range_px}: {err} > {TABLE_TOL}")
        check(torch.equal(table[:, 1], plain[:, 1]), f"reciprocal column differs at m={max_range_px}")
        d = torch.clamp(torch.arange(table.shape[0], dtype=torch.float32, device=device), max=q.m)
        analytic = q.launch_log_norm(d)
        check(torch.equal(analytic, table), f"table differs from the analytic function at m={max_range_px}")
        frac = torch.rand(4096, device=device) * q.m
        err_frac = float((q.launch_log_norm(frac)[:, 0] - _log_norm(q, frac)).abs().max())
        check(err_frac <= TABLE_TOL, f"analytic log_norm vs plain at fractional d: {err_frac}")
        cases.append(dict(max_range_px=max_range_px, entries=table.shape[0], max_abs_err=err,
                          analytic_bits="torch.equal", fractional_d_max_abs_err=err_frac))
        if max_range_px == 200:
            entries = table.shape[0]
            timed = dict(
                ms=graph_ms(lambda: q.launch_log_norm(device=device)), time_source="cuda_graph",
                wrapper_ms=event_ms(lambda: q.launch_log_norm(device=device)),
                plain_ms=event_ms(lambda: log_norm_table(q, device)),
                # entries x {2 erf (division, exp, 11 ops), a log, a reciprocal, ~12 more}
                **bound(8 * entries + 60, 50 * entries, 0),
            )
    sub_cases, sub_timed = [], None
    for max_range_px in (200, 238, 400):  # 238: basement_fixed's max range
        qs = synthetic_case(rng, _beams(60), max_range_px, False, 8, device, subbin=True)[0]
        q = synthetic_case(rng, _beams(60), max_range_px, False, 8, device)[0]
        table = qs.subbin_table(device)
        check(qs.subbin_table_launch_count == 1 and qs.subbin_table(device) is table,
              "the sub-bin table is filled once per query and device")
        plain = subbin_norm_table(qs, device)
        check(tuple(table.shape) == tuple(plain.shape) == (2 * max_range_px + 1, 4),
              f"sub-bin table shape {tuple(table.shape)}")
        err = float((table - plain).abs().max())
        check(err <= TABLE_TOL, f"sub-bin table vs plain at m={max_range_px}: {err} > {TABLE_TOL}")
        check(torch.equal(table[::2, 0], q.norm_table(device)[:, 0]),
              f"sub-bin table's integer nodes differ from the normaliser table at m={max_range_px}")
        d = torch.rand(100_000, device=device) * max_range_px
        d[:1000] *= 1e-3  # the first segment, past the short term's jump at 0
        err_read = float((subbin_log_norm(table, d) - qs.launch_log_norm(d)[:, 0]).abs().max())
        check(err_read <= SUBBIN_READ_TOL,
              f"sub-bin table read vs analytic at m={max_range_px}: {err_read} > {SUBBIN_READ_TOL}")
        sub_cases.append(dict(max_range_px=max_range_px, entries=table.shape[0], max_abs_err=err,
                              integer_nodes="torch.equal", read_vs_analytic_max_abs_err=err_read))
        if max_range_px == 238:
            entries = table.shape[0]
            sub_timed = dict(
                ms=graph_ms(lambda: qs.launch_subbin_norm(device)), time_source="cuda_graph",
                wrapper_ms=event_ms(lambda: qs.launch_subbin_norm(device)),
                plain_ms=event_ms(lambda: subbin_norm_table(qs, device)),
                # entries x {2 log_norm (~50 each), 2 slopes (2 double exps, ~12
                # double ops each), the segment (~10 double ops)}
                **bound(16 * entries + 60, 100 * entries, 40 * entries),
            )
    whole_bins = {}
    for num_beams in (60, 1080):
        q, lut, parts, obs, row_map = synthetic_case(rng, _beams(num_beams), 200, True,
                                                     6000, device)
        qs = synthetic_case(rng, _beams(num_beams), 200, True, 8, device, subbin=True)[0]
        k = torch.from_numpy(rng.integers(-q.t_bins, q.t_bins, 6000).astype(np.float32)).to(device)
        theta = k / q.bin_scale
        bpos = theta * q.bin_scale
        keep = (bpos == torch.floor(bpos)) & (bpos == torch.round(bpos))
        parts = parts[keep].contiguous()
        parts[:, 2] = theta[keep]
        got, want = qs.launch(lut, parts, obs, row_map), q.launch(lut, parts, obs, row_map)
        torch.cuda.synchronize()
        check(qs.subbin_table_launch_count == 1, "the whole-bin K3 should read the sub-bin table")
        on = int((want != -1e4).sum())
        check(on > 1000, f"whole-bin case at {num_beams} beams kept {on} particles on the map")
        check(torch.equal(got, want),
              f"sub-bin kernel on whole-bin headings differs from the table kernel at {num_beams} beams")
        whole_bins[f"{num_beams} beams"] = dict(particles=int(keep.sum()), on_map=on, result="torch.equal")
    emit("norm_table", t0, tol=TABLE_TOL, cases=cases, subbin_tol=SUBBIN_READ_TOL,
         subbin_cases=sub_cases, subbin_on_whole_bins_vs_table_kernel=whole_bins,
         fill_times=timed, subbin_fill_times=sub_timed)
    return dict(norm=dict(max_abs_err=max(c["max_abs_err"] for c in cases), **timed),
                subbin=dict(max_abs_err=max(c["max_abs_err"] for c in sub_cases), **sub_timed))


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
    against its plain version, its overflow count against dedup_plan's,
    and its key kernel against its plain version (bit for bit), on one
    cloud; raises on a gate."""
    import torch

    from monte_carlo_localization_tpu_torch.ops.lut_query import (
        dedup_keys,
        lut_dedup_reference,
        window_keys,
    )

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
    keys, starts, fracs, _ = q.launch_window_keys(lut, parts, row_map)
    want = window_keys(q, parts, row_map)
    key_err = max(float((keys.to(torch.int64) - want[0].to(torch.int64)).abs().max()),
                  float((starts - want[1]).abs().max()),
                  0.0 if fracs is None else float((fracs - want[2]).abs().max()))
    check(torch.equal(keys, want[0]) and torch.equal(starts, want[1])
          and (fracs is None or torch.equal(fracs, want[2])),
          f"{what}: window_key_kernel differs from its plain version by {key_err}")
    check(torch.equal(keys.to(torch.int64), dedup_keys(q, parts, row_map)),
          f"{what}: window keys differ from dedup_plan's")
    return dict(max_abs_err=err, overflowed_blocks=int(overflow),
                blocks=-(-parts.shape[0] // q.block), slots=q.launched_slots,
                off_map=int((plain == -1e4).sum()), key_max_abs_err=key_err)


def dedup_times(q, lut, parts, obs, row_map, n_on: int) -> dict:
    """Device times of the unique-window kernel, of the LUT kernel on the
    same cloud, of the plan (the key kernel and the sort) per call and of
    the key kernel alone; wrapper and plain times; the bounds."""
    from monte_carlo_localization_tpu_torch.ops.lut_query import lut_dedup_reference, window_keys

    dev = device_ms(lambda: q.launch_dedup(lut, parts, obs, row_map), "lut_dedup_kernel")
    k1 = device_ms(lambda: q.launch(lut, parts, obs, row_map), "lut_loglik_kernel")
    keys = device_ms(lambda: q.launch_window_keys(lut, parts, row_map), "window_key_kernel")
    plan_rows, _ = profile_run(lambda: q.plan_dedup(lut, parts, row_map), 10)
    n = parts.shape[0]
    key_bytes = 12 * n + 4 * n_on * (row_map is not None) + (4 + 8 + 4 * q.subbin) * n + 4
    return dict(
        device_ms=dev["ms"], time_source=dev["source"], k1_device_ms=k1["ms"],
        plan_device_ms=sum(us for us, _ in plan_rows.values()) / 1e3 / 10,
        plan_device_kernels=sum(n for _, n in plan_rows.values()) / 10,
        plan_kernels={k[:60]: dict(us=us / 10, launches=c / 10) for k, (us, c) in plan_rows.items()},
        key_kernel=dict(
            ms=keys["ms"], time_source=keys["source"],
            wrapper_ms=event_ms(lambda: q.launch_window_keys(lut, parts, row_map)),
            plain_ms=event_ms(lambda: window_keys(q, parts, row_map)),
            **bound(key_bytes, OPS_PER_PARTICLE_KEY * n, 0)),
        wrapper_ms=event_ms(lambda: q.launch_dedup(lut, parts, obs, row_map)),
        k1_wrapper_ms=event_ms(lambda: q.launch(lut, parts, obs, row_map)),
        plain_ms=event_ms(lambda: lut_dedup_reference(q, lut, parts, obs, row_map), iters=10),
        **lut_bound(parts.shape[0], n_on, q.num_beams, q.lut_dtype.itemsize, row_map is not None,
                    subbin=q.subbin, **dict(zip(("windows", "sectors"), cloud_reads(q, parts, row_map)))),
    )


def phase_dedup_vs_plain(device) -> dict:
    """K4/K5 at 100k particles on a random 200 x 200 LUT: converged,
    uniform and mixed clouds, with the sub-bin lerp, u16 and a row map,
    and 1080 beams (u16 windows past the 48 KB shared-memory default).
    Timed: the 60-beam converged and uniform clouds and both 1080-beam
    ones."""
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
        (1080, 400, False, True, ("converged", "mixed")),
    ):
        beams = _beams(num_beams)
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
            if num_beams == 1080:  # u16 windows: the largest slots
                times[f"{n}x1080 {kind}, u16, subbin"] = dedup_times(
                    q, lut, parts, obs, row_map, n - res_c["off_map"])
        del lut, row_map, parts
        torch.cuda.empty_cache()
    emit("dedup_vs_plain", t0, tol=KERNEL_TOL, slots=DEDUP_SLOTS, block=160, cases=cases,
         synthetic_lut_times=times)
    return dict(max_abs_err=max(c["max_abs_err"] for c in cases), times=times,
                key_max_abs_err=max(c["key_max_abs_err"] for c in cases))


def knife_edge_ranges(res: float, max_range_px: int, count: int, seed: int = 0) -> np.ndarray:
    """``count`` float32 ranges in meters: every half-pixel knife edge
    (k + 0.5) * res of [0, max_range_px] and its neighbours up to 2 ulp
    away, the rest uniform over 0..1.05 max range (past it the index
    clips)."""
    half = ((np.arange(max_range_px + 1) + 0.5) * res).astype(np.float32)
    up, down = [half], [half]
    for _ in range(2):
        up.append(np.nextafter(up[-1], np.float32(np.inf)))
        down.append(np.nextafter(down[-1], np.float32(0)))
    edge = np.concatenate(up + down[1:])
    rng = np.random.default_rng(seed)
    rest = rng.uniform(0.0, 1.05 * max_range_px * res, count - edge.size).astype(np.float32)
    return np.concatenate([edge, rest])


def phase_division(device) -> None:
    """``SensorModel.to_pixel_index`` on the card against the CPU, bit
    for bit, on 10^6 ranges with every half-pixel knife edge (config #1's
    0.05 m map and 12 m range: 240 px). Beside it, the same count for the
    expression the port used before, a division by a Python number, which
    CUDA torch runs as a multiply by the reciprocal; and the share of
    raw quotients in which that multiply and the division differ."""
    import torch

    from monte_carlo_localization_tpu_torch import MCLConfig
    from monte_carlo_localization_tpu_torch.models.sensor import SensorModel

    t0 = time.perf_counter()
    res = 0.05
    m = MCLConfig().max_range_px(res)
    ranges = torch.from_numpy(knife_edge_ranges(res, m, 1_000_000))
    cards = ranges.to(device)
    got = SensorModel.create(m, res, device=device).to_pixel_index(cards).cpu()
    want = SensorModel.create(m, res, device="cpu").to_pixel_index(ranges)
    differing = int((got != want).sum())

    def reciprocal_form(r):  # the expression before the repair
        px = torch.nan_to_num(r / res, nan=float(m), posinf=float(m), neginf=0.0)
        return torch.floor(torch.clamp(px, 0.0, float(m)) + 0.5).to(torch.int32)

    before = int((reciprocal_form(cards).cpu() != reciprocal_form(ranges)).sum())
    quotients = float(((cards / res).cpu() != ranges / res).float().mean())
    check(differing == 0, f"to_pixel_index differs between card and CPU on {differing} ranges")
    emit("division", t0, ranges=ranges.numel(), max_range_px=m, differing=differing,
         differing_reciprocal_form=before, reciprocal_quotients_off=quotients)


def zero_motion() -> None:
    """Zero the motion kernel's counters before a main-path run."""
    from monte_carlo_localization_tpu_torch.ops.motion import MOTION_KERNEL

    MOTION_KERNEL.launch_count = MOTION_KERNEL.plain_launch_count = 0


def motion_launches(corrections: int, where: str) -> int:
    """The motion kernel's launches since :func:`zero_motion`, checked to
    be one a correction with no call on the plain version."""
    from monte_carlo_localization_tpu_torch.ops.motion import MOTION_KERNEL

    launches, plain = MOTION_KERNEL.launch_count, MOTION_KERNEL.plain_launch_count
    check(launches == corrections and plain == 0,
          f"{where}: {launches} motion launches and {plain} plain calls for "
          f"{corrections} corrections")
    return launches


def phase_config1(device) -> dict:
    import torch

    from monte_carlo_localization_tpu_torch import MCLConfig, ParticleFilter, load_map
    from monte_carlo_localization_tpu_torch.ops.resample import SYSTEMATIC_KERNEL
    from monte_carlo_localization_tpu_torch.runtime import Trace, replay_chained

    t0 = time.perf_counter()
    trace = REPO / "traces" / "config1_map_1753950572.npz"
    gm = load_map(REPO / "maps" / "map_1753950572.yaml", device=device)
    cfg = MCLConfig(max_particles=N_PARTICLES, angle_step=18)
    pf = ParticleFilter(gm, cfg)
    sweep_reset()
    pf.set_beam_angles(Trace.load(trace).beam_angles[:: cfg.angle_step])
    t_setup = time.perf_counter() - t0
    built = lut_built_on_card("config1_replay", pf.grid_map)
    pf.likelihood.launch_count = pf.likelihood.table_launch_count = 0
    SYSTEMATIC_KERNEL.launch_count = 0
    zero_motion()
    res = replay_chained(pf, trace, chunk=64)
    launches, table_launches = pf.likelihood.launch_count, pf.likelihood.table_launch_count
    resample_launches = SYSTEMATIC_KERNEL.launch_count
    check(resample_launches == res.corrections,
          f"{resample_launches} resampler launches for {res.corrections} corrections")
    moves = motion_launches(res.corrections, "config #1")
    check(table_launches == 1, f"{table_launches} fills of the normaliser table in one replay (want 1)")
    check(np.isfinite(res.poses).all(), "config #1 replay gave non-finite poses")
    check(launches == res.corrections == 500,
          f"{launches} kernel launches for {res.corrections} corrections (want 500)")
    check(res.rmse_xy <= CONFIG1_RMSE_MAX, f"config #1 RMSE {res.rmse_xy} m > {CONFIG1_RMSE_MAX}")
    emit("config1_replay", t0, setup_s=t_setup, particles=N_PARTICLES,
         beams=int(pf.beam_angles.shape[0]), lut=("compact " if pf.grid_map.lut_row_map is not None else "dense ") + str(pf.grid_map.range_lut.dtype),
         **built, corrections=res.corrections, launches=launches, table_fills=table_launches,
         resample_launches=resample_launches, motion_launches=moves, rmse_xy_m=res.rmse_xy,
         rmse_theta_rad=res.rmse_theta, chained_updates_per_s=res.updates_per_sec)
    del pf, gm
    torch.cuda.empty_cache()
    return dict(launches=launches, table_launches=table_launches, rmse_xy=res.rmse_xy,
                rate=res.updates_per_sec, resample_launches=resample_launches,
                motion_launches=moves)


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
    from monte_carlo_localization_tpu_torch.ops.resample import SYSTEMATIC_KERNEL

    t0 = time.perf_counter()
    gm = load_map(REPO / "maps" / "Spielberg_map.yaml", device=device)
    t_map = time.perf_counter() - t0
    pf = ParticleFilter(gm, MCLConfig(max_particles=N_PARTICLES))
    beams = _beams(1080)
    sweep_reset()
    t1 = time.perf_counter()
    pf.set_beam_angles(beams)  # builds the compact LUT on the card
    torch.cuda.synchronize()
    t_lut = time.perf_counter() - t1
    built = lut_built_on_card("headline_spielberg", pf.grid_map)
    lut, row_map = pf.grid_map.range_lut, pf.grid_map.lut_row_map
    check(row_map is not None, "Spielberg should take the row-compacted LUT")
    lut_bytes = lut.numel() * lut.element_size()
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
    # warm-up at the timed shapes: the chain's and the step's graphs are captured here
    state, _ = pf.step_many(state, actions, scans)
    state, _ = pf.step(state, actions[0], scan)
    torch.cuda.synchronize()

    pf.likelihood.launch_count = SYSTEMATIC_KERNEL.launch_count = 0
    zero_motion()
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
    resample_launches = SYSTEMATIC_KERNEL.launch_count
    check(resample_launches == chain + 30,
          f"{resample_launches} resampler launches for {chain + 30} corrections")
    moves = motion_launches(chain + 30, "headline")
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
    bnd = lut_bound(N_PARTICLES, n_on, 1080, 1, True,
                    sectors=cloud_reads(pf.likelihood, parts, row_map)[1])
    emit("headline_spielberg", t0, particles=N_PARTICLES, beams=1080, lut="compact u8",
         lut_rows=lut.numel() // pf.grid_map.row_stride, row_stride=pf.grid_map.row_stride,
         lut_bytes=lut_bytes, map_load_s=t_map, set_beam_angles_s=t_lut,
         lut_build_s=built["lut_build_s"], lut_route=built["lut_route"],
         sweep_launches=built["sweep_launches"], launches=launches,
         resample_launches=resample_launches, motion_launches=moves,
         chained_updates_per_s=chain / t_chain, per_step_updates_per_s=30 / t_steps,
         drift_from_start_m=drift, max_abs_err=err, kernel_device_ms=kernel_ms,
         kernel_time_source=dev["source"], wrapper_ms=wrapper_ms, plain_ms=plain_ms, **bnd,
         peak_device_bytes=torch.cuda.max_memory_allocated(device))
    return dict(launches=launches, max_abs_err=err, ms=kernel_ms, wrapper_ms=wrapper_ms,
                plain_ms=plain_ms, bound_ms=bnd["bound_ms"], bound_by=bnd["bound_by"],
                sector_bound_ms=bnd["sector_bound_ms"], sector_bytes=bnd["sector_bytes"],
                resample_launches=resample_launches, motion_launches=moves)


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
    again = torch.empty_like(parts), torch.empty_like(logw), torch.empty_like(sums)
    step.launch(lut, parts, logw, noise, obs, scalars, *again)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip((out_p, out_w, sums), again)),
          f"{what}: two launches on the same inputs differ")
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
                max_err=mx_err, off_map=off, two_launches="torch.equal")


def mega_times(step, lut, parts, logw, noise, obs, scalars, n_on: int) -> dict:
    """Device time of the kernel (and of each debug_phases part), wrapper
    time, plain time, the launcher's plan and the bound, on these inputs."""
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
    grid, chunk, small = step.plan(n)
    return dict(
        device_ms=dev["ms"], time_source=dev["source"], phase_device_ms=phases,
        wrapper_ms=event_ms(launch()),
        plain_ms=event_ms(lambda: mega_step_reference(step, lut, parts, logw, noise, obs, scalars)),
        grid_blocks=grid, particles_per_block=chunk,
        phase1="per block, no grid barrier" if small else "across a cooperative grid",
        **mega_bound(n, n_on, r, lut.element_size()),
    )


def phase_mega_vs_plain(device) -> dict:
    import torch

    t0 = time.perf_counter()
    rng = np.random.default_rng(2)
    cases, times = [], {}
    for num_beams in (60, 1080):
        beams = _beams(num_beams)
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
    # each side of the launcher's choice: up to 8192 particles every block
    # computes the weight CDF itself, past that a cooperative grid does
    scalars = torch.tensor(MOTIONS["arc"] + [0.0] * 4, dtype=torch.float32, device=device)
    for num_beams, n in ((60, 1), (60, 8192), (1080, 8192), (60, 30_011), (1080, 30_011), (60, 100_000)):
        step, lut, parts, logw, noise, obs = mega_case(rng, _beams(num_beams), 200, n, device)
        if n == 1:
            parts[:, :2] = torch.tensor([1.0, 2.0], device=device)  # on the map
        what = f"mega {n} x {num_beams}"
        res = mega_compare(step, lut, parts, logw, noise, obs, scalars, what)
        grid, chunk, small = step.plan(n)
        check(small == (n <= 8192) and grid == -(-n // chunk), f"{what}: plan {(grid, chunk, small)}")
        cases.append(dict(beams=num_beams, lut="u8", motion="arc", grid_blocks=grid,
                          phase1="per block" if small else "cooperative grid", **res))
        if n == 100_000:
            times[f"{n}x{num_beams}"] = mega_times(step, lut, parts, logw, noise, obs, scalars,
                                                   n - res["off_map"])
    emit("mega_vs_plain", t0, row_tol=MEGA_ROW_TOL, rows_min=MEGA_ROWS_MIN, lw_tol=KERNEL_TOL,
         sums_rtol=MEGA_SUMS_RTOL, cases=cases, synthetic_lut_times=times)
    return dict(max_abs_err=max(c["max_abs_err"] for c in cases), times=times)


def trace_inputs(pf, trace):
    from monte_carlo_localization_tpu_torch.runtime import Trace, trace_actions

    t = Trace.load(trace)
    stride = pf.config.angle_step
    scans = np.ascontiguousarray(t.scan_ranges[:, ::stride], dtype=np.float32)
    return vars(t), trace_actions(t.odom_t, t.odom_twist, t.scan_t), scans


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
    beams = _beams(1080)
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
        f.step_many(s0, actions, scans)  # warm-up at the timed shape (its graph's capture)
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
    sweep_reset()
    t1 = time.perf_counter()
    pf.set_beam_angles(beams)  # builds the compact LUT on the card
    torch.cuda.synchronize()
    t_lut = time.perf_counter() - t1
    built = lut_built_on_card("config4_replay", pf.grid_map)
    gm = pf.grid_map
    check(gm.lut_row_map is not None, "basement_fixed should take the row-compacted LUT")
    pf_sub = ParticleFilter(gm, cfg.replace(pallas_subbin=True))
    pf_sub.set_beam_angles(beams)
    check(pf_sub.grid_map.range_lut is gm.range_lut, "the subbin filter should share the LUT")
    runs = {}
    for name, f in (("default", pf), ("subbin", pf_sub)):
        f.likelihood.launch_count = f.likelihood.subbin_table_launch_count = 0
        reps = [replay_chained(f, trace, chunk=64, seed=seed) for seed in CONFIG4_SEEDS]
        launches = f.likelihood.launch_count
        for res in reps:
            check(np.isfinite(res.poses).all(), f"config #4 {name} replay gave non-finite poses")
        corrections = sum(res.corrections for res in reps)
        check(launches == corrections == 500 * len(CONFIG4_SEEDS),
              f"config #4 {name}: {launches} kernel launches for {corrections} corrections")
        rmses = [res.rmse_xy for res in reps]
        median = float(np.median(rmses))
        check(median <= CONFIG4_RMSE_MAX,
              f"config #4 {name} replay median RMSE {median} m > {CONFIG4_RMSE_MAX}")
        spread = dict(zip(("min", "q1", "median", "q3", "max"),
                          np.quantile(rmses, [0.0, 0.25, 0.5, 0.75, 1.0]).tolist()))
        truth = np.stack([np.interp(reps[0].times, tr["truth_t"], tr["truth_pose"][:, i])
                          for i in range(2)], 1)
        errs = np.concatenate([np.hypot(*(res.poses[:, :2] - truth).T) for res in reps])
        runs[name] = dict(launches=launches, median_rmse_xy_m=median,
                          rmse_xy_m_spread=spread,
                          subbin_table_fills=f.likelihood.subbin_table_launch_count,
                          jax_engine_rmse_xy_m=CONFIG4_JAX_RMSE,
                          per_scan_err_m_quantiles={q: float(np.quantile(errs, q))
                                                    for q in (0.5, 0.9, 0.99)},
                          rmse_xy_m=[res.rmse_xy for res in reps],
                          rmse_theta_rad=[res.rmse_theta for res in reps],
                          chained_updates_per_s=[res.updates_per_sec for res in reps])

    check(runs["subbin"]["subbin_table_fills"] == 1,
          f"{runs['subbin']['subbin_table_fills']} fills of the sub-bin table in the replays (want 1)")
    # K3 against its plain version on the real LUT, at this path's shape
    q, lut, row_map = pf_sub.likelihood, gm.range_lut, gm.lut_row_map
    check(q.subbin_table_entries == 2 * int(q.m) + 1, "K3 on basement should read the sub-bin table")
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
              **lut_bound(N_PARTICLES, n_on, q.num_beams, 1, True, subbin=True,
                          **dict(zip(("windows", "sectors"), cloud_reads(q, parts, row_map)))))
    s0 = pf.init_pose(tr["truth_pose"][0], seed=3)
    prof = {name: chain_profile(lambda f=f: f.step_many(s0, actions[:20], scans[:20]), 20)
            for name, f in (("default", pf), ("subbin", pf_sub))}
    emit("config4_replay", t0, map="basement_fixed", particles=N_PARTICLES, beams=len(beams),
         lut="compact " + str(lut.dtype), lut_rows=lut.numel() // gm.row_stride,
         row_stride=gm.row_stride, set_beam_angles_s=t_lut, **built,
         corrections_per_replay=500, seeds=list(CONFIG4_SEEDS),
         runs=runs, k3_on_basement=k3,
         profile_20_steps=prof)
    del pf, pf_sub, state, parts
    torch.cuda.empty_cache()
    return dict(k1_launches=runs["default"]["launches"], k3=k3,
                subbin_table_fills=runs["subbin"]["subbin_table_fills"]), gm, beams


def phase_config4_converge(device, gm, beams) -> dict:
    """Config #4: 100k particles seeded over basement_fixed, chained
    corrections in chunks of 5 until within 0.5 m (at most 80), 5 trials,
    each with the unique-window kernel (K4) and without it (K2), the
    first also with ``pallas_dedup_matmul`` (K5). The trial seeds are
    shared, so the runs must agree bit for bit. Then CONVERGE_MORE trials
    from further start poses without dedup: the share within 0.5 m out of
    20, beside the JAX engine's (no gate beyond one converged trial)."""
    import torch

    from monte_carlo_localization_tpu_torch import MCLConfig, ParticleFilter
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
    truths = _convergence_truths(gm, CONVERGE_TRIALS + CONVERGE_MORE)
    scans = [_synth_scan(gm, beams, p) for p in truths]
    for f in filters.values():  # pay first launches outside every trial's timer
        converge_global(f, scans[0], truths[0], seed=99, max_updates=5)
    torch.cuda.synchronize()
    for f in filters.values():
        q = f.likelihood
        q.launch_count = q.dedup_launch_count = q.key_launch_count = 0
    trials = []
    runs = {name: [] for name in filters}
    for i, (truth, scan) in enumerate(zip(truths[:CONVERGE_TRIALS], scans)):
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
    key_launches = {name: f.likelihood.key_launch_count for name, f in filters.items()}
    for name, f in filters.items():
        check(launches[name] > 0, f"{name}: its kernel was never launched")
        if f.likelihood.dedup_slots:
            check(f.likelihood.launch_count == 0, f"{name} launched the LUT kernel")
            check(key_launches[name] == launches[name],
                  f"{name}: {key_launches[name]} key-kernel launches for {launches[name]} corrections")
    ok = [t for t in trials if t["updates"] is not None]
    check(len(ok) >= 1, "no config #4 trial converged")
    # more start poses on the K2 filter alone: is 3 of 5 the random stream?
    more = []
    for i in range(CONVERGE_TRIALS, CONVERGE_TRIALS + CONVERGE_MORE):
        r = converge_global(filters["plain_K2"], scans[i], truths[i], seed=100 + i)
        more.append(dict(trial=i, truth=truths[i].tolist(), updates=r.updates, err_m=r.err_m,
                         seconds=r.seconds))
    all_trials = [dict(trial=i, truth=t["truth"], updates=t["updates"], err_m=t["err_m"])
                  for i, t in enumerate(trials)] + more
    converged = sum(t["updates"] is not None for t in all_trials)

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
        kernels[name] = dict(launches=launches[name], key_launches=key_launches[name], **cmp,
                             **dedup_times(q, gm.range_lut, parts, obs, gm.lut_row_map, n_on))
    # kernels per correction and idle share at 100k, 10 chained steps from a
    # uniform seed against the first trial's scan
    s0 = filters["plain_K2"].init_global(seed=7)
    zeros, tiled = np.zeros((10, 3), np.float32), np.tile(scans[0], (10, 1))
    prof = {name: chain_profile(lambda f=filters[name]: f.step_many(s0, zeros, tiled), 10)
            for name in ("plain_K2", "dedup_K4")}
    emit("config4_converge", t0, map="basement_fixed", particles=n, beams=len(beams),
         slots=DEDUP_SLOTS, block=filters["dedup_K4"].likelihood.block, trials=trials,
         success_rate=len(ok) / len(trials), launches=launches, key_launches=key_launches,
         trials_20=[dict(trial=t["trial"], updates=t["updates"], err_m=t["err_m"]) for t in all_trials],
         converged_of_20=f"{converged} of {len(all_trials)}", jax_engine_converged=JAX_CONVERGED,
         failed_start_poses={t["trial"]: t["truth"] for t in all_trials if t["updates"] is None},
         summary={name: summary(name) for name in runs}, kernels_on_converged_cloud=kernels,
         profile_10_steps=prof)
    del filters, runs
    torch.cuda.empty_cache()
    return kernels

# fleet cases: (map shapes, members, particles per member, map_of,
# member_base, compact, max_range_px, subbin). npm 4001 and 1003 are not
# multiples of 8, so a block of 8 warps would straddle two members; every
# case has particles off their member's map. The last three are members
# smaller than a block, than a lane group's share and of one particle,
# and members whose last block is ragged at several particles per group.
FLEET_CASES = {
    "3_members_2_maps": ([(64, 80), (40, 120)], 3, 4000, [0, 1, 0], 0, False, 200, False),
    "shared_map_of": ([(64, 80), (40, 120)], 8, 1003, [1, 1, 0, 1, 0, 0, 1, 1], 0, False, 200,
                      False),
    "compact_row_map_bases": ([(64, 80), (40, 120)], 3, 4000, [1, 0, 1], 0, True, 200, False),
    "u16": ([(64, 80), (40, 120)], 3, 4001, [0, 1, 1], 0, False, 400, False),
    "subbin": ([(64, 80), (40, 120)], 3, 4000, [0, 1, 0], 0, True, 200, True),
    "member_base_2": ([(64, 80), (40, 120)], 2, 1003, [0, 0, 1, 0, 1], 2, False, 200, False),
    "npm_7": ([(64, 80), (40, 120)], 9, 7, [0, 1, 0, 1, 1, 0, 0, 1, 0], 0, False, 200, False),
    "npm_1": ([(64, 80), (40, 120)], 40, 1, [0, 1] * 20, 0, True, 200, False),
    "ragged_70001": ([(64, 80), (40, 120)], 5, 70_001, [0, 1, 0, 1, 1], 0, False, 400, False),
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

    beams = _beams(60)
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
                np.random.default_rng(5), _beams(60), 200, compact, N_PARTICLES + 1,
                device, subbin=subbin)
            fq = LUTQuery(q.t_bins, _beams(60), height=q.height, width=q.width,
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


def phase_config5(device, classic_kernels: float) -> dict:
    """BASELINE.json config #5 as bench.py ``bench_fleet`` runs it: 64 cars
    x 4000 particles x 60 beams over 4 maps (map_assignment = arange(64) %
    4), tight dense member LUTs, each car at its map's best-cleared pose
    with a sphere-cast scan; chains of 10 corrections (1 warm + 3 rounds x
    3), then 3 rounds of 20 single steps."""
    import torch

    from monte_carlo_localization_tpu_torch import MCLConfig
    from monte_carlo_localization_tpu_torch.ops.lut_query import fleet_window_start
    from monte_carlo_localization_tpu_torch.ops.lut_query import lut_log_weights_reference
    from monte_carlo_localization_tpu_torch.ops.resample import SYSTEMATIC_KERNEL
    from monte_carlo_localization_tpu_torch.parallel import FleetFilter

    t0 = time.perf_counter()
    f, n, r = CONFIG5_FLEET, N_PARTICLES, 60
    maps, stacked, asg, beams, poses0, scans = config5_fleet_inputs(device)
    ff = FleetFilter(stacked, f, MCLConfig(max_particles=n, lut_theta_bins=720),
                     map_assignment=asg)
    sweep_reset()
    t1 = time.perf_counter()
    ff.set_beam_angles(beams)  # builds the tight member LUTs on the card
    torch.cuda.synchronize()
    t_lut = time.perf_counter() - t1
    built = lut_built_on_card("config5_fleet", ff.map)
    gm, q = ff.map, ff.likelihood
    check(gm.lut_row_map is None and gm.lut_member_base is not None,
          "config #5 should take tight dense member LUTs")
    lut_bytes = gm.range_lut.numel() * gm.range_lut.element_size()
    cells = [int(h) * int(w) for h, w in gm.member_dims.tolist()]
    check(lut_bytes == sum(cells) * gm.row_stride * gm.range_lut.element_size(),
          f"member LUT of {lut_bytes} B is not the sum of the true map areas")
    action = np.zeros((f, 3), np.float32)
    actions_k = np.tile(action, (CONFIG5_CHAIN, 1, 1))
    scans_k = np.tile(scans, (CONFIG5_CHAIN, 1, 1))
    state = ff.init_pose(poses0, seed=1)
    q.fleet_launch_count = q.launch_count = SYSTEMATIC_KERNEL.launch_count = 0
    zero_motion()

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
    state, pose_s = ff.step(state, action, scans)  # warm-up: the step's graph is captured
    n_corr += 1
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
    resample_launches = SYSTEMATIC_KERNEL.launch_count
    check(resample_launches == n_corr,
          f"{resample_launches} resampler launches ({f} rows each) for {n_corr} fleet corrections")
    moves = motion_launches(n_corr, "config #5")

    # the fleet kernel against its plain version at this path's shape
    obs = ff.sensor.to_pixel_index(torch.as_tensor(scans, device=device)).float()
    parts = state.particles.reshape(-1, 3).contiguous()
    fleet = dict(origins=(gm.origin_x, gm.origin_y), map_of=ff._member_map, dims=gm.member_dims,
                 lut_bases=gm.lut_member_base, row_map_bases=gm.lut_row_map_base)
    cmp = fleet_compare(q, gm.range_lut, parts, obs, None, fleet, "config #5 fleet kernel",
                        synthetic=False)
    tables = q.fleet_tables(parts, obs, None, **fleet)
    start, _, oob, _ = fleet_window_start(q, parts, tables)
    windows, sectors = lut_reads(q, start, oob)
    dev = device_ms(lambda: q.launch(gm.range_lut, parts, obs, None, tables),
                    "lut_loglik_kernel")
    kernel = dict(
        launches=launches, max_abs_err=cmp["max_abs_err"], ms=dev["ms"], time_source=dev["source"],
        wrapper_ms=event_ms(lambda: q.launch(gm.range_lut, parts, obs, None, tables)),
        plain_ms=event_ms(lambda: lut_log_weights_reference(q, gm.range_lut, parts, obs, None, tables),
                         iters=10),
        distinct_windows=windows,
        **lut_bound(f * n, f * n - cmp["off_map"], r, 1, False, windows=windows, sectors=sectors),
    )
    prof = chain_profile(lambda: ff.step_many(state, actions_k, scans_k), CONFIG5_CHAIN)
    kernels = prof["device_kernels_per_correction"]
    check(kernels <= FLEET_KERNELS_MAX * classic_kernels,
          f"config #5: {kernels} device kernels per correction > {FLEET_KERNELS_MAX} x "
          f"the single filter's {classic_kernels}")
    emit("config5_fleet", t0, maps=[m.name for m in maps], fleet=f, particles=n, beams=r,
         map_assignment="arange(64) % 4", lut="tight dense " + str(gm.range_lut.dtype),
         lut_bytes=lut_bytes, lut_row_stride=gm.row_stride, lut_theta_bins=gm.lut_theta_bins,
         member_cells=cells, set_beam_angles_s=t_lut, lut_build_s=built["lut_build_s"],
         lut_route=built["lut_route"], sweep_launches=built["sweep_launches"],
         corrections=n_corr,
         fleet_launches=launches, resample_launches=resample_launches, motion_launches=moves,
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
    return {**kernel, "resample_launches": resample_launches, "motion_launches": moves}


SHARDED_CHAIN = 10  # chained corrections holding bucketed against allgather
SHARDED_CHUNK = 5  # corrections a chunk (converge_on_draws) and of the re-run test
MULTIHOST_PROCESSES = 2
MULTIHOST_CHAINS = 4  # chains of CONFIG5_CHAIN steps: 1 warm + 3 timed
DRAW_SEED = 5  # the card generator of the multihost member draws


def result_line(outs: list[str]) -> dict:
    """The ``RESULT {json}`` line that rank 0 of a spawned run printed."""
    lines = [ln for ln in outs[0].splitlines() if ln.startswith("RESULT ")]
    check(len(lines) == 1, f"rank 0 printed {len(lines)} result lines:\n{outs[0][-3000:]}")
    return json.loads(lines[0][len("RESULT "):])


def converge_on_draws(spf, scan_m, truth, seed: int, chunk: int = SHARDED_CHUNK,
                      max_updates: int = 80, tol_m: float = 0.5) -> dict:
    """``runtime/converge.py`` ``converge_global``'s loop (chunks of 5
    chained corrections from ``init_global(seed)``, one readback a chunk,
    until within ``tol_m``) on draws from a card generator seeded by
    ``seed``: u0 (chunk,) and noise (chunk, N, 3), the same in every
    process, of which each shard takes its rows. So D = 1 and D = 2 run one
    trajectory up to the CDF's last bits."""
    import torch

    dev, n = spf.device, spf.config.max_particles
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    scans = np.tile(np.asarray(scan_m, np.float32), (chunk, 1))
    actions = np.zeros((chunk, 3), np.float32)
    state = spf.init_global(seed=seed)
    updates, err, u = None, math.inf, 0
    t0 = time.perf_counter()
    for u in range(chunk, max_updates + 1, chunk):
        u0 = torch.rand((chunk,), generator=gen, device=dev)
        noise = torch.randn((chunk, n, 3), generator=gen, device=dev)
        state, p = spf.step_many(state, actions, scans, u0=u0, noise=noise)
        p = p.cpu().numpy()
        err = float(math.hypot(p[-1, 0] - truth[0], p[-1, 1] - truth[1]))
        if err < tol_m:
            updates = u
            break
    seconds = time.perf_counter() - t0
    return dict(updates=updates, seconds=seconds, err_m=err, corrections=u,
                chained_updates_per_s=u / seconds, state=state)


def basement_for_sharding(device):
    """Config #4's map and beams (the trace's 60) and its five start poses
    with their sphere-cast scans, as ``phase_config4_converge`` makes them."""
    from monte_carlo_localization_tpu_torch import load_map
    from monte_carlo_localization_tpu_torch.runtime import Trace

    gm = load_map(REPO / "maps" / "basement_fixed.map.yaml", device=device)
    beams = np.asarray(Trace.load(REPO / "traces" / "config4_basement_fixed.npz").beam_angles[::18],
                       np.float32)
    truths = _convergence_truths(gm, CONVERGE_TRIALS)
    return gm, beams, truths, [_synth_scan(gm, beams, p) for p in truths]


def sharded_trials(spf, truths, scans) -> dict:
    """Config #4's five global-localization trials on a sharded filter (this
    process's shard; graph replays, except under ``disable_graphs()`` and
    over gloo), gated on one LUT-kernel launch a shard and correction
    (and one more for each correction of a re-run chunk) and on the
    kernel against its plain version on this shard's particles.
    ``overflow_reads`` is one a chunk of the bucketed path (D > 1), and
    ``rerun_chunks`` the chunks its overflow ran again through the
    all-gather."""
    import torch

    from monte_carlo_localization_tpu_torch.ops.lut_query import lut_log_weights_reference

    q, gm, dev = spf.likelihood, spf.map, spf.device
    converge_on_draws(spf, scans[0], truths[0], seed=99, max_updates=5)  # first launches
    torch.cuda.synchronize()
    q.launch_count = 0
    spf.overflow_reads = spf.fallbacks = 0
    spf.comm.reset_counts()
    trials = [converge_on_draws(spf, scan, truth, seed=100 + i)
              for i, (truth, scan) in enumerate(zip(truths, scans))]
    corrections = sum(t["corrections"] for t in trials)
    launches = q.launch_count
    chunks = corrections // SHARDED_CHUNK
    # a chunk re-run through the all-gather launches its K corrections again
    rerun = SHARDED_CHUNK * spf.fallbacks
    check(launches == corrections + rerun,
          f"shard {spf.shard}: {launches} LUT-kernel launches for {corrections} corrections "
          f"and {spf.fallbacks} re-run chunks of {SHARDED_CHUNK}")
    check(spf.overflow_reads == (chunks if spf.num_devices > 1 else 0),
          f"shard {spf.shard}: {spf.overflow_reads} overflow reads for {chunks} chunks")
    syncs = dict(overflow_reads=spf.overflow_reads / corrections,
                 gloo_host_copies=spf.comm.host_copies / corrections,
                 readbacks=chunks / corrections)
    comm = dict(calls_per_correction=spf.comm.calls / corrections,
                bytes_per_correction=spf.comm.bytes / corrections, chunks=chunks,
                rerun_chunks=spf.fallbacks, rerun_corrections=rerun)
    parts = trials[-1]["state"].particles.contiguous()
    obs = spf.sensor.to_pixel_index(torch.as_tensor(scans[-1], device=dev)).float()
    got = q(gm.range_lut, parts, obs, row_map=gm.lut_row_map)
    want = lut_log_weights_reference(q, gm.range_lut, parts, obs, gm.lut_row_map)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    check(err <= KERNEL_TOL, f"shard {spf.shard}: K2 vs plain {err} > {KERNEL_TOL}")
    return dict(
        trials=[{k: v for k, v in t.items() if k != "state"} for t in trials],
        converged=[i for i, t in enumerate(trials) if t["updates"] is not None],
        corrections=corrections, k2_launches=launches, syncs_per_correction=syncs,
        collectives=comm, k2_max_abs_err=err, k2_particles=int(parts.shape[0]),
    )


def sharded_chain(spf, scan, steps: int):
    """``step_many`` of ``steps`` zero-action corrections from a fixed
    ``init_global`` state of ``spf`` on ``scan``, as a function of no
    arguments (for :func:`chain_profile` and :func:`graph_pair`)."""
    s0 = spf.init_global(seed=7)
    zeros, tiled = np.zeros((steps, 3), np.float32), np.tile(scan, (steps, 1))
    return lambda: spf.step_many(s0, zeros, tiled)


def _sharded_rank() -> None:
    """One process of the sharded filter at D = 2 on the one card (gloo):
    config #4's trials, ``bucketed`` against ``allgather`` over 10 chained
    corrections on the same draws, the fringe-overflow fallback, and a
    probe of which gloo collectives take card tensors."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from monte_carlo_localization_tpu_torch import MCLConfig
    from monte_carlo_localization_tpu_torch.parallel import ShardedParticleFilter

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    gm, beams, truths, scans = basement_for_sharding(device)
    n = CONFIG4_PARTICLES
    spf = ShardedParticleFilter(gm, MCLConfig(max_particles=n), beam_angles=beams)
    check(spf.num_devices == 2 and spf.comm.backend == "gloo", "D = 2 runs over gloo")
    out = sharded_trials(spf, truths, scans)
    out["profile_10_steps"] = chain_profile(sharded_chain(spf, scans[0], 10), 10)
    check(not spf.programs.cache, "a step over gloo was captured")

    runs = {}
    for mode in ("bucketed", "allgather"):
        f = ShardedParticleFilter(spf.map, MCLConfig(max_particles=n, sharded_resample=mode),
                                  beam_angles=beams)  # the map's LUT is reused
        s = f.init_global(seed=7)
        torch.cuda.synchronize()
        f.comm.reset_counts()
        s, poses = f.step_many(s, np.zeros((SHARDED_CHAIN, 3), np.float32),
                               np.tile(scans[0], (SHARDED_CHAIN, 1)))
        whole = f.gather_state(s)
        runs[mode] = dict(bytes=f.comm.bytes / SHARDED_CHAIN, calls=f.comm.calls / SHARDED_CHAIN,
                          state=whole, poses=poses, fallbacks=f.fallbacks)
    out["chain_rerun_chunks"] = runs["bucketed"]["fallbacks"]
    equal = all(torch.equal(getattr(runs["bucketed"]["state"], k), getattr(runs["allgather"]["state"], k))
                for k in ("particles", "log_weights")) and torch.equal(runs["bucketed"]["poses"],
                                                                      runs["allgather"]["poses"])
    check(equal, "bucketed and allgather corrections differ")

    # a chunk whose first correction overflows a one-slot fringe: run
    # again through the all-gather; each mode twice, the second timed
    fb = {}
    chunk = np.zeros((SHARDED_CHUNK, 3), np.float32), np.tile(scans[0], (SHARDED_CHUNK, 1))
    for mode, fringe in (("bucketed", 1), ("allgather", 0)):
        f = ShardedParticleFilter(spf.map, MCLConfig(max_particles=n, sharded_resample=mode,
                                                     sharded_fringe=fringe), beam_angles=beams)
        whole = f.gather_state(f.init_global(seed=4))
        lw = torch.full((n,), -80.0, device=device)
        lw[n - n // 2:] = 0.0  # all the mass on the last shard
        for _ in range(2):
            s0 = f.place_state(dataclasses.replace(whole, log_weights=lw))
            f.overflow_reads = f.fallbacks = 0
            torch.cuda.synchronize()
            t = time.perf_counter()
            st, poses = f.step_many(s0, *chunk, u0=np.full(SHARDED_CHUNK, 0.5, np.float32))
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t) * 1e3
        fb[mode] = (f.gather_state(st).particles, poses, f.fallbacks, f.overflow_reads, ms)
    check(fb["bucketed"][2:4] == (1, 1),
          f"a one-slot fringe: {fb['bucketed'][3]} reads, {fb['bucketed'][2]} re-run chunks")
    check(torch.equal(fb["bucketed"][0], fb["allgather"][0])
          and torch.equal(fb["bucketed"][1], fb["allgather"][1]),
          "the overflowed chunk's re-run differs from allgather")

    probe = {}
    for name in ("all_reduce", "all_gather"):
        x = torch.ones(4, device=device)
        try:
            if name == "all_reduce":
                dist.all_reduce(x)
                ok = bool((x == 2).all())
            else:
                parts = [torch.empty_like(x) for _ in range(2)]
                dist.all_gather(parts, x)
                ok = all(bool((p == 1).all()) for p in parts)
            torch.cuda.synchronize()
            probe[name] = "takes card tensors" + ("" if ok else ", wrong result")
        except (RuntimeError, ValueError) as e:
            probe[name] = f"refuses card tensors: {str(e).splitlines()[0][:120]}"
    probe["send/recv"] = "not probed (collectives.py hands gloo host tensors in every call)"
    ranks = [None] * spf.num_devices
    dist.all_gather_object(ranks, {k: out[k] for k in ("k2_launches", "k2_max_abs_err",
                                                       "corrections", "converged")})
    out.update(
        ranks=ranks,
        bucketed_equals_allgather=equal, chained=SHARDED_CHAIN,
        bytes_per_correction={m: r["bytes"] for m, r in runs.items()},
        calls_per_correction={m: r["calls"] for m, r in runs.items()},
        exchange_bytes_saved_per_correction=runs["allgather"]["bytes"] - runs["bucketed"]["bytes"],
        rerun=dict(rerun_chunks=fb["bucketed"][2], overflow_reads=fb["bucketed"][3],
                   equal_to_allgather=True, chunk=SHARDED_CHUNK,
                   bucketed_and_rerun_chunk_ms=fb["bucketed"][4],
                   allgather_chunk_ms=fb["allgather"][4]),
        gloo_card_tensors=probe,
    )
    if dist.get_rank() == 0:
        print("RESULT " + json.dumps(out), flush=True)


def sharded_d1(gm, beams, truths, scans) -> dict:
    """D = 1 over the NCCL group of one this process is in: the trials as
    graphs and under ``disable_graphs()``, and an eager/graph pair of
    GRAPH_STEPS chained corrections."""
    from monte_carlo_localization_tpu_torch import MCLConfig, disable_graphs
    from monte_carlo_localization_tpu_torch.parallel import ShardedParticleFilter

    spf = ShardedParticleFilter(gm, MCLConfig(max_particles=CONFIG4_PARTICLES),
                                beam_angles=beams)
    check(spf.num_devices == 1 and spf.comm.backend == "nccl", "D = 1 runs over NCCL")
    graph = sharded_trials(spf, truths, scans)
    check(len(spf.programs.cache) >= 1, "D = 1 over NCCL ran no graph")
    with disable_graphs():
        eager = sharded_trials(spf, truths, scans)
    pair = graph_pair(sharded_chain(spf, scans[0], GRAPH_STEPS), GRAPH_STEPS, spf.programs)
    return dict(graph=graph, eager=eager, pair=pair)


def phase_sharded(device) -> dict:
    """The sharded filter (``parallel/sharded.py``) on config #4's global
    localization at full width: 100k particles x 60 beams on basement_fixed
    under ``lut_pallas``, its five start poses, chunks of 5 up to 80
    updates. (a) D = 1 over an NCCL process group of one, in this process,
    as graphs and eagerly, with an eager/graph pair; (b) eager/graph pairs
    of D = 1 in a one-shard world (no group) and of the single filter on
    the same map in this call; (c) D = 2 processes on this one card over
    gloo (NCCL refuses two ranks on one GPU), eager by rule. The same
    trials must converge in (a) both ways and in (c)."""
    import torch

    from monte_carlo_localization_tpu_torch import MCLConfig, ParticleFilter
    from monte_carlo_localization_tpu_torch.parallel import ShardedParticleFilter
    from monte_carlo_localization_tpu_torch.parallel.multihost import spawn

    t0 = time.perf_counter()
    gm, beams, truths, scans = basement_for_sharding(device)
    with nccl_group_of_one():
        d1 = sharded_d1(gm, beams, truths, scans)
    world = ShardedParticleFilter(gm, MCLConfig(max_particles=CONFIG4_PARTICLES),
                                  beam_angles=beams)
    check(world.num_devices == 1 and world.comm.group is None, "a one-shard world")
    pairs = dict(d1_nccl=d1.pop("pair"),
                 d1_world=graph_pair(sharded_chain(world, scans[0], GRAPH_STEPS), GRAPH_STEPS,
                                     world.programs))
    del world
    pf = ParticleFilter(gm, MCLConfig(max_particles=CONFIG4_PARTICLES))
    pf.set_beam_angles(beams)
    s0 = pf.init_global(seed=7)
    zeros, tiled = np.zeros((GRAPH_STEPS, 3), np.float32), np.tile(scans[0], (GRAPH_STEPS, 1))
    pairs["single_filter"] = graph_pair(lambda: pf.step_many(s0, zeros, tiled), GRAPH_STEPS,
                                        pf.programs)
    del pf, gm
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    d2 = result_line(spawn("chip_smoke:_sharded_rank", 2, timeout_s=600.0))
    d2_wall = time.perf_counter() - t1
    converged = dict(d1_graph=d1["graph"]["converged"], d1_eager=d1["eager"]["converged"],
                     d2=d2["converged"])
    check(len({tuple(c) for c in converged.values()}) == 1 and d2["converged"],
          f"converged trials differ: {converged}")
    emit("sharded", t0, card=CARD, map="basement_fixed", particles=CONFIG4_PARTICLES,
         beams=len(beams), chunk=SHARDED_CHUNK, converged=converged, d1_nccl=d1, pairs=pairs,
         d2_gloo=d2, d2_spawn_wall_s=d2_wall)
    return dict(d1=d1["graph"]["k2_launches"] + d1["eager"]["k2_launches"],
                d2=[r["k2_launches"] for r in d2["ranks"]],
                max_abs_err=max([d1["graph"]["k2_max_abs_err"], d1["eager"]["k2_max_abs_err"]]
                                + [r["k2_max_abs_err"] for r in d2["ranks"]]))


def config5_fleet_inputs(device):
    """Config #5 as the port's bench ``bench_fleet`` sets it up
    (``_fleet_inputs``): the four maps, ``map_assignment = arange(64) %
    4``, 60 beams, each car at its map's start pose with a sphere-cast
    scan. Returns (maps, stacked map, assignment, beams, start poses (64,
    3), scans (64, 60))."""
    from monte_carlo_localization_tpu_torch import load_map
    from monte_carlo_localization_tpu_torch.parallel import stack_maps

    maps = [load_map(REPO / "maps" / name, device=device) for name in CONFIG5_MAPS]
    return maps, stack_maps(maps), *_fleet_inputs(CONFIG5_FLEET, 60, maps)


def multihost_draws(device):
    """The member draws of the multihost chains, the same in every process:
    per correction u0 (64,) and noise (64, 4000, 3) from a card generator."""
    import torch

    gen = torch.Generator(device=device)
    gen.manual_seed(DRAW_SEED)
    for _ in range(MULTIHOST_CHAINS * CONFIG5_CHAIN):
        yield (torch.rand((CONFIG5_FLEET,), generator=gen, device=device),
               torch.randn((CONFIG5_FLEET, N_PARTICLES, 3), generator=gen, device=device))


def _multihost_rank() -> None:
    """One process of config #5 across MULTIHOST_PROCESSES on the card: 32
    members, their own scans only, chains of 10 corrections (graph
    replays), the pose table gathered; then the step held to its eager
    run and eager/graph pairs, per step and chained."""
    import torch
    import torch.distributed as dist

    from monte_carlo_localization_tpu_torch import MCLConfig
    from monte_carlo_localization_tpu_torch.parallel import MultiHostFleet

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    _, stacked, asg, beams, poses0, scans = config5_fleet_inputs(device)
    mh = MultiHostFleet(stacked, CONFIG5_FLEET, MCLConfig(max_particles=N_PARTICLES,
                                                          lut_theta_bins=720),
                        beam_angles=beams, map_assignment=asg)
    mine = list(mh.local_members)
    check(mh.process_count == MULTIHOST_PROCESSES and len(mine) == CONFIG5_FLEET // 2,
          f"process {mh.process_index} owns members {mine}")
    scans_local = mh.scatter_local(scans[mine])
    actions_local = mh.scatter_local(np.zeros((len(mine), 3), np.float32))
    state = mh.init_pose(poses0, seed=1)
    q = mh.fleet.likelihood
    q.fleet_launch_count = q.launch_count = 0
    draws = multihost_draws(device)
    rates = []
    for _ in range(MULTIHOST_CHAINS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(CONFIG5_CHAIN):
            u0, noise = next(draws)
            state, poses = mh.step(state, actions_local, scans_local, u0=u0, noise=noise)
        torch.cuda.synchronize()
        rates.append(CONFIG5_CHAIN / (time.perf_counter() - t))
    corrections = MULTIHOST_CHAINS * CONFIG5_CHAIN
    launches = q.fleet_launch_count
    check(launches == corrections and q.launch_count == 0,
          f"process {mh.process_index}: {launches} fleet launches for {corrections} corrections")
    table = mh.gather_poses(poses)
    err = np.linalg.norm(table[:, :2] - poses0[:, :2], axis=1)
    thr = _drift_threshold(corrections)
    check(bool(np.isfinite(err).all()) and err.max() < thr,
          f"multihost: max member error {err.max()} m >= {thr}")
    gm = mh.fleet.map
    obs = mh.fleet.sensor.to_pixel_index(scans_local).float()
    fleet = dict(origins=(gm.origin_x, gm.origin_y), map_of=mh.fleet._member_map,
                 dims=gm.member_dims, lut_bases=gm.lut_member_base,
                 row_map_bases=gm.lut_row_map_base)
    cmp = fleet_compare(q, gm.range_lut, state.particles.reshape(-1, 3).contiguous(), obs, None,
                        fleet, f"multihost process {mh.process_index}", synthetic=False)
    # the step (one graph replay a process, over gloo too: no collective
    # in a correction) against disable_graphs() on this process's rows of
    # given draws and on its generator's, then eager/graph pairs
    k, rng = GRAPH_CHAIN, np.random.default_rng(DRAW_SEED + mh.process_index)
    held_draws = dict(u0=rng.random((k, len(mine)), dtype=np.float32),
                      noise=rng.standard_normal((k, len(mine), N_PARTICLES, 3), dtype=np.float32))

    def steps(s, d):
        poses = []
        for i in range(k):
            s, p = mh.step(s, actions_local, scans_local, **{key: v[i] for key, v in d.items()})
            poses.append(p)
        return s, torch.stack(poses)

    held = hold_graph_to_eager(lambda: mh.init_pose(poses0, seed=1), steps, held_draws, [q], k,
                               [mh.fleet._fleet_comm, mh.fleet._particle_comm])
    held["graphs"] = sum(key[0] == "fleet_step" for key in mh.fleet.programs.cache)

    def one_at_a_time():
        s = state
        for _ in range(CONFIG5_CHAIN):
            s, _ = mh.step(s, actions_local, scans_local)

    actions_k = np.zeros((CONFIG5_CHAIN, len(mine), 3), np.float32)
    scans_k = scans_local.expand(CONFIG5_CHAIN, -1, -1)
    pairs = dict(per_step=graph_pair(one_at_a_time, CONFIG5_CHAIN, mh.fleet.programs),
                 chained=graph_pair(lambda: mh.fleet.step_many(state, actions_k, scans_k),
                                    CONFIG5_CHAIN, mh.fleet.programs))
    out = dict(process=mh.process_index, members=[mine[0], mine[-1]], corrections=corrections,
               fleet_launches=launches, chained_fleet_steps_per_s=rates,
               chained_member_updates_per_s=[r * len(mine) for r in rates],
               max_member_err_m=float(err.max()), drift_threshold_m=thr,
               fleet_kernel_max_abs_err=cmp["max_abs_err"], held=held, pairs=pairs,
               table=[[float(v).hex() for v in row] for row in table])
    outs = [None] * MULTIHOST_PROCESSES
    dist.all_gather_object(outs, {k: out[k] for k in ("process", "fleet_launches",
                                                      "chained_fleet_steps_per_s",
                                                      "fleet_kernel_max_abs_err",
                                                      "held", "pairs")})
    if dist.get_rank() == 0:
        print("RESULT " + json.dumps(dict(out, ranks=outs)), flush=True)


def phase_multihost(device) -> dict:
    """Config #5 at full width across MULTIHOST_PROCESSES processes on this
    card (``MultiHostFleet`` over gloo): each owns 32 of the 64 cars (4000
    particles x 60 beams over the four maps), feeds its own members' scans,
    runs chains of 10 corrections on member draws from a card generator and
    gathers the (64, 3) table. The one-process ``FleetFilter`` of
    ``phase_config5``'s setup then runs the same draws: the tables must be
    equal bit for bit. Each process's step is a graph (a 1-D fleet mesh
    calls no collective in a correction), held ``torch.equal`` to its
    eager run; eager/graph pairs per process."""
    import torch

    from monte_carlo_localization_tpu_torch import MCLConfig
    from monte_carlo_localization_tpu_torch.parallel import FleetFilter
    from monte_carlo_localization_tpu_torch.parallel.multihost import spawn

    t0 = time.perf_counter()
    res = result_line(spawn("chip_smoke:_multihost_rank", MULTIHOST_PROCESSES, timeout_s=600.0))
    spawn_s = time.perf_counter() - t0
    table = np.array([[float.fromhex(v) for v in row] for row in res.pop("table")], np.float32)
    _, stacked, asg, beams, poses0, scans = config5_fleet_inputs(device)
    ff = FleetFilter(stacked, CONFIG5_FLEET, MCLConfig(max_particles=N_PARTICLES, lut_theta_bins=720),
                     beam_angles=beams, map_assignment=asg)
    state = ff.init_pose(poses0, seed=1)
    actions = np.zeros((CONFIG5_FLEET, 3), np.float32)
    for u0, noise in multihost_draws(device):
        state, poses = ff.step(state, actions, scans, u0=u0, noise=noise)
    one = poses.cpu().numpy()
    equal = bool(np.array_equal(one, table))
    emit("multihost", t0, card=CARD, processes=MULTIHOST_PROCESSES, backend="gloo",
         fleet=CONFIG5_FLEET, particles=N_PARTICLES, beams=60, map_assignment="arange(64) % 4",
         spawn_wall_s=spawn_s, **res, table_equal_to_one_process=equal,
         table_max_abs_diff=float(np.abs(one - table).max()))
    check(equal, "multihost: the gathered pose table differs from the one-process fleet's")
    for r in res["ranks"]:
        gate_held("multihost", f"process {r['process']}'s step", r["held"])
        check(r["held"]["graphs"] == 2, f"multihost: process {r['process']} captured "
                                        f"{r['held']['graphs']} step graphs, not 2")
    del ff, state
    torch.cuda.empty_cache()
    return dict(launches=[r["fleet_launches"] for r in res["ranks"]],
                max_abs_err=max(r["fleet_kernel_max_abs_err"] for r in res["ranks"]))


def host_cpu() -> str:
    """The host CPU: ``/proc/cpuinfo``'s model name, or where a sandbox
    reports it as unknown, its vendor, family and model numbers (else
    ``lscpu``'s model name, else the architecture), and the logical core
    count."""
    import platform

    info = {}
    try:
        with open("/proc/cpuinfo") as f:
            for ln in f:
                if not ln.strip():
                    break  # the first processor's block
                key, _, value = ln.partition(":")
                info[key.strip()] = value.strip()
    except OSError:
        pass
    name = info.get("model name", "unknown")
    if name == "unknown" and "cpu family" in info:
        name = f"{info.get('vendor_id', '')} family {info['cpu family']} model {info.get('model')}"
    if name == "unknown":
        try:
            out = subprocess.run(["lscpu"], capture_output=True, text=True, timeout=30).stdout
            name = next((ln.split(":", 1)[1].strip() for ln in out.splitlines()
                         if ln.startswith("Model name")), f"an unnamed {platform.machine()} CPU")
        except (OSError, subprocess.SubprocessError):
            name = f"an unnamed {platform.machine()} CPU"
    return f"{name}, {os.cpu_count()} logical cores"


BASELINE_CORRECTIONS = 30


def phase_baseline(config1_rate: float) -> dict:
    """``cli baseline`` on config #1's golden trace at 4000 particles: the
    measured CPU reference harness (numpy + the native DDA caster), on
    the host CPU, beside config #1's chained rate on the card."""
    t0 = time.perf_counter()
    out = cli_json(["baseline", "--map", str(REPO / "maps" / "map_1753950572.yaml"),
                    "--trace", str(REPO / "traces" / "config1_map_1753950572.npz"),
                    "--particles", str(N_PARTICLES), "--corrections", str(BASELINE_CORRECTIONS)])
    check(out["corrections"] == BASELINE_CORRECTIONS and np.isfinite(out["rmse_xy_m"]),
          f"cli baseline: {out}")
    emit("baseline", t0, host_cpu=host_cpu(), **out,
         card_config1_chained_updates_per_s=config1_rate, card=CARD)
    return out


FLEET_LIVE_DEPTH = 4  # bench.py bench_fleet_live: async depth 4, an 8 s window
FLEET_LIVE_SECONDS = 8.0
FLEET_SYNC_TICKS = 30
FLEET_RUNNER_SECONDS = 3.0
FLEET_WARM_S_MAX = 300.0
# the stationary fleet's member error gate: twice config #1's RMSE gate
# (the cars start at and keep their true poses)
FLEET_STATIONARY_ERR_M = 2 * CONFIG1_RMSE_MAX


def phase_fleet_live(device) -> dict:
    """Config #5's workload through the port's ``FleetNode``, as bench.py
    ``bench_fleet_live`` runs it: 64 cars x 4000 particles x 60 beams over
    the four maps (map_assignment = arange(64) % 4), each car at its map's
    best-cleared pose with a sphere-cast scan, ``async_correction`` at
    depth 4; warm up until the first harvest, then an 8 s window. Then
    the same workload synchronous (30 ticks at an explicit clock), the
    kernels and idle share of 20 synchronous updates, and a LiveRunner
    driving the async node for 3 s. Gates: a harvest, finite poses, every
    member within ``_drift_threshold(harvested + 4)`` (bench.py's
    divergence gate) and within FLEET_STATIONARY_ERR_M (the cars stand
    still at their true poses), the fleet kernel launched once per
    dispatched correction and no single-filter launch."""
    import torch

    from monte_carlo_localization_tpu_torch import MCLConfig
    from monte_carlo_localization_tpu_torch.runtime import FleetNode, LiveRunner

    t0 = time.perf_counter()
    f, n, r = CONFIG5_FLEET, N_PARTICLES, 60
    maps, stacked, asg, beams, poses0, scans = config5_fleet_inputs(device)

    def make_node(async_correction: bool):
        cfg = MCLConfig(max_particles=n, angle_step=1, async_correction=async_correction,
                        async_depth=FLEET_LIVE_DEPTH)
        node = FleetNode(stacked, f, cfg, map_assignment=asg, rng_seed=0)
        sweep_reset()
        t1 = time.perf_counter()
        for i in range(f):  # the first scan attaches the member LUTs
            node.on_scan(i, scans[i], beam_angles=beams)
            node.on_odometry(i, *poses0[i], 0.0, 0.0, stamp=0.0)
        torch.cuda.synchronize()
        first_scans_s = time.perf_counter() - t1
        node.initialize_pose(poses0)
        q = node.filter.likelihood
        q.fleet_launch_count = q.launch_count = 0
        node.dispatched = 0
        step = node._step

        def counted(actions, scans):
            node.dispatched += 1
            return step(actions, scans)

        node._step = counted
        return node, q, first_scans_s

    def member_err(poses, what, corrections):
        check(poses is not None and bool(np.isfinite(poses).all()), f"{what}: non-finite poses")
        err = np.linalg.norm(poses[:, :2] - poses0[:, :2], axis=1)
        thr = _drift_threshold(corrections)
        check(err.max() < thr, f"{what}: max member error {err.max()} m >= {thr}")
        check(err.max() < FLEET_STATIONARY_ERR_M, f"{what}: max member error {err.max()} m "
              f">= {FLEET_STATIONARY_ERR_M} m for cars standing at their true poses")
        return float(err.max()), thr

    def launches_match(node, q, what):
        check(q.fleet_launch_count == node.dispatched and q.launch_count == 0,
              f"{what}: {q.fleet_launch_count} fleet-kernel launches (and {q.launch_count} "
              f"single) for {node.dispatched} dispatched corrections")

    node, q, first_s = make_node(True)
    built = lut_built_on_card("fleet_live", node.filter.map)
    t1 = time.perf_counter()
    while node.update() is None:
        check(time.perf_counter() - t1 < FLEET_WARM_S_MAX, "fleet live: the warm-up never harvested")
    warm_s = time.perf_counter() - t1
    harvested, last = 0, None
    t1 = time.perf_counter()
    while time.perf_counter() - t1 < FLEET_LIVE_SECONDS:
        got = node.update()
        if got is not None:
            last, harvested = got, harvested + 1
    window = time.perf_counter() - t1
    check(harvested >= 1, "fleet live harvested nothing in its window")
    err, thr = member_err(last, "fleet live", harvested + FLEET_LIVE_DEPTH)
    launches_match(node, q, "fleet live")
    live = dict(harvested=harvested, window_s=window, dispatched=node.dispatched,
                fleet_launches=q.fleet_launch_count, warmup_s=warm_s,
                fleet_corrections_per_s=harvested / window,
                member_corrections_per_s=harvested * f / window,
                max_member_err_m=err, drift_threshold_m=thr, first_scans_s=first_s)
    launches = q.fleet_launch_count

    # a LiveRunner at timer_frequency drives the same async node
    q.fleet_launch_count, node.dispatched = 0, 0
    node._last_update_time = None
    with LiveRunner(node) as runner:
        time.sleep(FLEET_RUNNER_SECONDS)
    check(runner.corrections >= 1, "the LiveRunner's fleet harvested nothing")
    err_r, _ = member_err(node.inferred_poses, "fleet LiveRunner",
                          live["dispatched"] + node.dispatched)
    launches_match(node, q, "fleet LiveRunner")
    runner_out = dict(seconds=FLEET_RUNNER_SECONDS, ticks=runner.ticks,
                      corrections=runner.corrections, skipped_ticks=runner.skipped,
                      dispatched=node.dispatched, fleet_launches=q.fleet_launch_count,
                      timer_frequency=node.config.timer_frequency, max_member_err_m=err_r)
    launches += q.fleet_launch_count
    del node, q
    torch.cuda.empty_cache()

    # the same workload synchronous, at an explicit clock
    node, q, first_s = make_node(False)
    lut_built_on_card("fleet_live_sync", node.filter.map)
    tick = {"t": 0.0}

    def sync_updates(steps: int):
        def run():
            out = None
            for _ in range(steps):
                tick["t"] += 0.05
                out = node.update(now=tick["t"])
            return out
        return run

    node.update(now=tick["t"])
    sync_updates(3)()  # warm
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    last = sync_updates(FLEET_SYNC_TICKS)()
    sync_s = time.perf_counter() - t1
    err_s, thr_s = member_err(last, "fleet sync", node.dispatched)
    launches_match(node, q, "fleet sync")
    sync = dict(ticks=FLEET_SYNC_TICKS, seconds=sync_s,
                fleet_corrections_per_s=FLEET_SYNC_TICKS / sync_s,
                member_corrections_per_s=FLEET_SYNC_TICKS * f / sync_s,
                max_member_err_m=err_s, drift_threshold_m=thr_s, fleet_launches=node.dispatched)
    launches += q.fleet_launch_count
    before = q.fleet_launch_count
    prof = chain_profile(sync_updates(20), 20)
    # chain_profile runs its 20 updates three times: warm, profiled, timed
    check(q.fleet_launch_count - before == 60, f"{q.fleet_launch_count - before} fleet "
          "launches in three runs of 20 profiled updates (want 60)")
    del node, q, maps, stacked
    torch.cuda.empty_cache()
    emit("fleet_live", t0, card=CARD, maps=list(CONFIG5_MAPS), fleet=f, particles=n, beams=r,
         map_assignment="arange(64) % 4", async_depth=FLEET_LIVE_DEPTH, **built,
         live=live, live_runner=runner_out, synchronous=sync, profile_20_sync_updates=prof,
         fleet_launches=launches)
    return dict(launches=launches, live=live, synchronous=sync, live_runner=runner_out)


GRAPH_CHAIN = 12  # chained corrections each program is held to eager over (>= 10)
GRAPH_STEPS = 20  # corrections of each eager/graph timing pair
GRAPH_CAST_STEPS = 5  # the same under sphere and dda (~1700 and ~7200 kernels a correction)
# the wrappers' per-correction launch counts (the table fills happen once)
STEP_COUNTERS = ("launch_count", "fleet_launch_count", "dedup_launch_count")
GRAPH_MILLION_STEPS = 10  # bench.py run_million's chain
MESH_FLEET = 4  # members of the 2-D fleet held to eager on a 1 x 1 NCCL mesh
MEGA_COOP_PARTICLES = 20_000  # past the mega step's 8192: its cooperative launch


def _launch_total(wrappers) -> int:
    return sum(getattr(w, name, 0) for w in wrappers for name in STEP_COUNTERS)


def _comm_total(comms) -> list[int]:
    """The collectives' calls and bytes, summed over ``comms``."""
    return [sum(c.calls for c in comms), sum(c.bytes for c in comms)]


def hold_graph_to_eager(make_state, run, draws: dict, wrappers=(), corrections: int = 0,
                        comms=()) -> dict:
    """``run(state, draws)`` on fresh ``make_state()`` states (one seed),
    under ``disable_graphs()`` and graphed: with the given ``draws`` and
    with the generators' own, the graph's poses, particles, log weights,
    log quality and final generator states (a sharded state's motion
    generator too) against eager's (``torch.equal``), a second graphed
    call (a replay only) against the first, the first call's outputs
    unchanged by the second (no aliasing), the wrappers' likelihood or
    mega launches of each call against ``corrections``, and the calls and
    bytes of the collectives ``comms`` each call made. Returns the
    findings; the caller gates."""
    import torch

    from monte_carlo_localization_tpu_torch import disable_graphs

    def outs(s, p):
        gens = [g for g in (s.generator, getattr(s, "motion_generator", None)) if g is not None]
        return (p, s.particles, s.log_weights, s.log_quality, *(g.get_state() for g in gens))

    res = {}
    for kind, d in (("given_draws", draws), ("generator_draws", {})):
        calls = []
        for graphed in (False, True, True):
            before, comm_before = _launch_total(wrappers), _comm_total(comms)
            with contextlib.ExitStack() as stack:
                if not graphed:
                    stack.enter_context(disable_graphs())
                s, p = run(make_state(), d)
            calls.append((outs(s, p), _launch_total(wrappers) - before,
                          [a - b for a, b in zip(_comm_total(comms), comm_before)]))
            if len(calls) == 2:
                kept = [t.clone() for t in outs(s, p)]
        torch.cuda.synchronize()
        (eager, n_e, c_e), (graph, n_g, c_g), (again, n_a, c_a) = calls
        equal = all(torch.equal(a.cpu(), b.cpu()) for a, b in zip(eager, graph))
        diff = (eager[0] != graph[0]).reshape(eager[0].shape[0], -1).any(dim=1)
        res[kind] = dict(
            equal=equal,
            replay_equal=all(torch.equal(a.cpu(), b.cpu()) for a, b in zip(graph, again)),
            no_aliasing=all(torch.equal(a.cpu(), b.cpu()) for a, b in zip(kept, graph)),
            first_differing_step=int(diff.nonzero()[0, 0]) if bool(diff.any()) else None,
            max_abs_pose_diff=float((eager[0] - graph[0]).abs().max()),
            launches=dict(eager=n_e, graph=n_g, replay=n_a, corrections=corrections),
            collectives=dict(eager=c_e, graph=c_g, replay=c_a),
        )
    return res


def gate_held(where: str, name: str, res: dict) -> None:
    """Refuse a program that :func:`hold_graph_to_eager` found unequal to
    its eager run, changed by a replay, or launching kernels or calling
    collectives other than eager did."""
    for kind in ("given_draws", "generator_draws"):
        r = res[kind]
        check(r["equal"], f"{where}: {name} ({kind}) differs from eager from step "
                          f"{r['first_differing_step']}")
        check(r["replay_equal"] and r["no_aliasing"],
              f"{where}: {name} ({kind}): a replay changed an earlier call's outputs")
        n = r["launches"]
        check(n["eager"] == n["graph"] == n["replay"] == n["corrections"],
              f"{where}: {name} ({kind}) launches {n}")
        c = r.get("collectives")
        check(c is None or c["eager"] == c["graph"] == c["replay"],
              f"{where}: {name} ({kind}) collective calls and bytes {c}")


@contextlib.contextmanager
def nccl_group_of_one():
    """An NCCL process group of this one process (D = 1). The caller drops
    every filter whose graphs hold the group's communicator before the
    block ends; the group is destroyed after a collection."""
    import gc

    import torch
    import torch.distributed as dist

    from monte_carlo_localization_tpu_torch.parallel import init_multihost
    from monte_carlo_localization_tpu_torch.parallel.multihost import _free_port

    init_multihost(f"127.0.0.1:{_free_port()}", 1, 0, backend="nccl")
    try:
        yield
    finally:
        gc.collect()
        torch.cuda.synchronize()
        dist.destroy_process_group()


def graph_pair(run, steps: int, programs) -> dict:
    """:func:`chain_profile` of ``run`` (``steps`` corrections) eagerly and
    as graphs in this call, with the graphs' capture ms and pool bytes."""
    from monte_carlo_localization_tpu_torch import disable_graphs

    with disable_graphs():
        eager = chain_profile(run, steps)
    graph = chain_profile(run, steps)
    stats = programs.stats()
    return dict(eager=eager, graph=graph,
                wall_speedup=eager["wall_ms_per_correction"] / graph["wall_ms_per_correction"],
                updates_per_s=dict(eager=1e3 / eager["wall_ms_per_correction"],
                                   graph=1e3 / graph["wall_ms_per_correction"]),
                capture_ms=sum(s["warmup_ms"] + s["capture_ms"] for s in stats.values()),
                pool_bytes=programs.pool_bytes, programs=len(stats))


def graph_programs(device) -> dict:
    """Each graphed program against ``disable_graphs()`` on config #1
    (:func:`hold_graph_to_eager` over GRAPH_CHAIN corrections): the
    classic ``step_many`` under K2, K1 (1080 beams), K3 (``pallas_subbin``),
    K4 and K5 (``pallas_dedup_slots``), the ``lut``, ``sphere`` and ``dda``
    methods, the single ``step`` and the injection step (a fraction per
    step through one graph), the mega step (4000 particles, and past 8192
    its cooperative launch), and the fleet's ``step`` and ``step_many``
    (config #5's 64 cars over 4 maps)."""
    import torch

    from monte_carlo_localization_tpu_torch import MCLConfig, ParticleFilter, load_map
    from monte_carlo_localization_tpu_torch.parallel import FleetFilter

    gm = load_map(REPO / CONFIG1_MAP, device=device)
    tr, actions_all, scans_all = None, None, None
    k = GRAPH_CHAIN
    rng = np.random.default_rng(11)
    out = {}

    def single(name, n=N_PARTICLES, angle_step=18, **opts):
        nonlocal tr, actions_all, scans_all
        cfg = MCLConfig(max_particles=n, angle_step=angle_step, **opts)
        pf = ParticleFilter(gm, cfg)
        tr, actions_all, scans_all = trace_inputs(pf, REPO / CONFIG1_TRACE)
        pf.set_beam_angles(tr["beam_angles"][::angle_step])
        actions, scans = actions_all[:k], scans_all[:k]
        draws = dict(u0=rng.random(k, dtype=np.float32),
                     noise=rng.standard_normal((k, n, 3), dtype=np.float32))
        wrappers = [w for w in (pf.likelihood, pf.mega and pf.mega.mega) if w is not None]
        res = hold_graph_to_eager(lambda: pf.init_pose(tr["truth_pose"][0], seed=7),
                                  lambda s, d: pf.step_many(s, actions, scans, **d), draws,
                                  wrappers, k if wrappers else 0)
        out[name] = res
        return pf

    single("classic_K2")
    single("classic_K1_1080", angle_step=1)
    single("subbin_K3", pallas_subbin=True)
    single("dedup_K4", pallas_dedup_slots=DEDUP_SLOTS)
    single("dedup_K5", pallas_dedup_slots=DEDUP_SLOTS, pallas_dedup_matmul=True)
    for method in ("lut", "sphere", "dda"):
        single(method, raycast_method=method)
    mega = single("mega", pallas_mega=True)
    out["mega"]["graphs"] = len(mega.mega.programs.cache)
    coop = single("mega_cooperative", n=MEGA_COOP_PARTICLES, pallas_mega=True)
    # past 8192 particles the kernel's cooperative launch, captured like any other
    out["mega_cooperative"]["graphs"] = len(coop.mega.programs.cache)
    out["mega_cooperative"]["plan"] = list(coop.mega.mega.plan(MEGA_COOP_PARTICLES))
    del mega, coop

    # one correction per call: the plain step and the injection step
    pf = ParticleFilter(gm, MCLConfig(max_particles=N_PARTICLES, angle_step=18))
    pf.set_beam_angles(tr["beam_angles"][::18])
    fractions = [0.0, 0.05, 0.3, 0.0, 1.0, 0.1, 0.02, 0.5, 0.0, 0.25, 0.07, 0.9][:k]
    step_draws = dict(u0=rng.random(k, dtype=np.float32),
                      noise=rng.standard_normal((k, N_PARTICLES, 3), dtype=np.float32),
                      mask_u=rng.random((k, N_PARTICLES), dtype=np.float32),
                      injected=rng.standard_normal((k, N_PARTICLES, 3), dtype=np.float32))

    def steps(inject):
        def run(s, d):
            poses = []
            for i in range(k):
                di = {name: v[i] for name, v in d.items()
                      if inject or name in ("u0", "noise")}
                if di.get("u0") is not None:
                    di["u0"] = float(di["u0"])
                if inject:
                    s, p = pf.step(s, actions_all[i], scans_all[i],
                                   inject_fraction=fractions[i], **di)
                else:
                    s, p = pf.step(s, actions_all[i], scans_all[i], **di)
                poses.append(p)
            return s, torch.stack(poses)
        return run

    make = lambda: pf.init_pose(tr["truth_pose"][0], seed=7)  # noqa: E731
    out["step"] = hold_graph_to_eager(make, steps(False), step_draws, [pf.likelihood], k)
    out["inject_step"] = hold_graph_to_eager(make, steps(True), step_draws, [pf.likelihood], k)
    out["inject_step"]["programs"] = sum(key[:2] == ("step", True) for key in pf.programs.cache)
    beams = tr["beam_angles"][::18]
    del pf
    # the sharded filter's and the meshed fleet's programs
    with nccl_group_of_one():
        out.update(graph_sharded(gm, beams, actions_all, scans_all, rng, "sharded_nccl"))
        out.update(graph_fleet_2d(gm, beams, tr, actions_all, scans_all, rng))
    out.update(graph_sharded(gm, beams, actions_all, scans_all, rng, "sharded_world"))
    del gm

    maps, stacked, asg, beams, poses0, scans5 = config5_fleet_inputs(device)
    f = CONFIG5_FLEET
    ff = FleetFilter(stacked, f, MCLConfig(max_particles=N_PARTICLES, lut_theta_bins=720),
                     map_assignment=asg)
    ff.set_beam_angles(beams)
    fleet_draws = dict(u0=rng.random((k, f), dtype=np.float32),
                       noise=rng.standard_normal((k, f, N_PARTICLES, 3), dtype=np.float32))
    acts = np.zeros((k, f, 3), np.float32)
    scans_k = np.tile(scans5, (k, 1, 1))
    make = lambda: ff.init_pose(poses0, seed=7)  # noqa: E731
    out["fleet_step_many"] = hold_graph_to_eager(
        make, lambda s, d: ff.step_many(s, acts, scans_k, **d), fleet_draws, [ff.likelihood], k)

    def fleet_steps(s, d):
        poses = []
        for i in range(k):
            s, p = ff.step(s, acts[i], scans5, **{name: v[i] for name, v in d.items()})
            poses.append(p)
        return s, torch.stack(poses)

    out["fleet_step"] = hold_graph_to_eager(make, fleet_steps, fleet_draws, [ff.likelihood], k)
    del ff, maps, stacked
    torch.cuda.empty_cache()
    return out


def hold_step_and_chain(name: str, flt, key: str, make, acts, scans, draws: dict, wrappers,
                        corrections: int, comms) -> dict:
    """:func:`hold_graph_to_eager` of a filter's ``step_many`` over the
    chunk and of its ``step`` once a correction, as ``{name}_step_many``
    and ``{name}_step``; ``graphs`` counts each program's keys
    (``{key}_step_many``, ``{key}_step``) in the filter's programs."""
    import torch

    def steps(s, d):
        poses = []
        for i in range(len(acts)):
            s, p = flt.step(s, acts[i], scans[i], **{k: v[i] for k, v in d.items()})
            poses.append(p)
        return s, torch.stack(poses)

    out = {}
    for program, run in (("step_many", lambda s, d: flt.step_many(s, acts, scans, **d)),
                         ("step", steps)):
        res = out[f"{name}_{program}"] = hold_graph_to_eager(make, run, draws, wrappers,
                                                             corrections, comms)
        res["graphs"] = sum(k[0] == f"{key}_{program}" for k in flt.programs.cache)
    return out


def graph_sharded(gm, beams, actions_all, scans_all, rng, name: str) -> dict:
    """The sharded filter's ``step_many`` and ``step`` (config #1's map and
    trace, N_PARTICLES particles) against ``disable_graphs()`` over
    GRAPH_CHAIN corrections: over the NCCL group of one this process is in
    (``sharded_nccl``), or in a one-shard world outside any group
    (``sharded_world``). ``graphs``: the program's keys captured (2: given
    draws and the generators')."""
    from monte_carlo_localization_tpu_torch import MCLConfig
    from monte_carlo_localization_tpu_torch.parallel import ShardedParticleFilter

    k, n = GRAPH_CHAIN, N_PARTICLES
    spf = ShardedParticleFilter(gm, MCLConfig(max_particles=n, angle_step=18), beam_angles=beams)
    backend = "nccl" if name == "sharded_nccl" else None
    check(spf.num_devices == 1 and spf.comm.backend == backend,
          f"graphs: {name} runs on {spf.num_devices} shards over {spf.comm.backend}")
    draws = dict(u0=rng.random(k, dtype=np.float32),
                 noise=rng.standard_normal((k, n, 3), dtype=np.float32))
    return hold_step_and_chain(name, spf, "sharded", lambda: spf.init_global(seed=7),
                               actions_all[:k], scans_all[:k], draws, [spf.likelihood], k,
                               [spf.comm])


def graph_fleet_2d(gm, beams, tr, actions_all, scans_all, rng) -> dict:
    """A fleet of MESH_FLEET members on a 1 x 1 fleet x particle mesh over
    the NCCL group of one this process is in (``lut``, config #1's map
    and trace, N_PARTICLES particles a member): its ``step_many`` and
    ``step`` against ``disable_graphs()`` over GRAPH_CHAIN corrections,
    with the particle axis's collectives counted."""
    from torch.distributed.device_mesh import init_device_mesh

    from monte_carlo_localization_tpu_torch import MCLConfig
    from monte_carlo_localization_tpu_torch.parallel import FleetFilter

    k, n, f = GRAPH_CHAIN, N_PARTICLES, MESH_FLEET
    mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("fleet", "p"))
    ff = FleetFilter(gm, f, MCLConfig(max_particles=n, angle_step=18, raycast_method="lut"),
                     beam_angles=beams, mesh=mesh, particle_axis="p")
    comm = ff._particle_comm
    check(comm.backend == "nccl", f"graphs: the 2-D fleet's particle axis is {comm.backend}")
    draws = dict(u0=rng.random((k, f), dtype=np.float32),
                 noise=rng.standard_normal((k, f, n, 3), dtype=np.float32))
    return hold_step_and_chain(
        "fleet_2d_nccl", ff, "fleet", lambda: ff.init_pose(np.tile(tr["truth_pose"][0], (f, 1)),
                                                           seed=7),
        np.tile(actions_all[:k, None], (1, f, 1)), np.tile(scans_all[:k, None], (1, f, 1)),
        draws, (), 0, [comm])


def graph_cells(device) -> dict:
    """Eager against graph in this call (:func:`graph_pair`) on the cells
    PERF.md tracks: config #1 under the classic step (chained and one
    correction a call), the mega step, ``sphere`` and ``dda``; the
    Spielberg headline (4000 x 1080, K1 on the compact LUT); config #4 at
    100k particles with and without dedup; config #5 (chained and one
    fleet step a call); and 1M particles on basement_fixed."""
    import torch

    from monte_carlo_localization_tpu_torch import MCLConfig, ParticleFilter, load_map
    from monte_carlo_localization_tpu_torch.parallel import FleetFilter

    cells = {}
    t_cell = time.perf_counter()

    def timed(name):
        nonlocal t_cell
        cells[name]["seconds"] = time.perf_counter() - t_cell
        t_cell = time.perf_counter()

    def pairs(pf, s0, actions, scans, per_step=True):
        progs = pf.mega.programs if pf.mega is not None else pf.programs
        k = actions.shape[0]
        got = dict(chained=graph_pair(lambda: pf.step_many(s0, actions, scans), k, progs))
        if per_step:
            def one_at_a_time():
                s = s0
                for i in range(k):
                    s, _ = pf.step(s, actions[i], scans[i])
            got["per_step"] = graph_pair(one_at_a_time, k, pf.programs)
        return got

    gm = load_map(REPO / CONFIG1_MAP, device=device)
    for name, opts in (("config1_classic", {}), ("config1_mega", dict(pallas_mega=True)),
                       ("config1_sphere", dict(raycast_method="sphere")),
                       ("config1_dda", dict(raycast_method="dda"))):
        pf = ParticleFilter(gm, MCLConfig(max_particles=N_PARTICLES, angle_step=18, **opts))
        tr, actions, scans = trace_inputs(pf, REPO / CONFIG1_TRACE)
        pf.set_beam_angles(tr["beam_angles"][::18])
        s0 = pf.init_pose(tr["truth_pose"][0], seed=3)
        k = GRAPH_CAST_STEPS if "raycast_method" in opts else GRAPH_STEPS
        cells[name] = pairs(pf, s0, actions[:k], scans[:k], per_step=name != "config1_mega")
        timed(name)
        del pf
    del gm

    gm = load_map(REPO / "maps" / "Spielberg_map.yaml", device=device)
    pf = ParticleFilter(gm, MCLConfig(max_particles=N_PARTICLES))
    pf.set_beam_angles(_beams(1080))
    pose = _start_pose(gm)
    scans = np.tile(lut_scan(pf, pose).astype(np.float32), (GRAPH_STEPS, 1))
    actions = np.tile(np.float32([0.05, 0.0, 0.01]), (GRAPH_STEPS, 1))
    cells["headline"] = pairs(pf, pf.init_pose(pose, seed=1), actions, scans)
    timed("headline")
    del pf, gm
    torch.cuda.empty_cache()

    gm, beams, truths, scans4 = basement_for_sharding(device)
    actions = np.zeros((GRAPH_STEPS, 3), np.float32)
    scans = np.tile(scans4[0], (GRAPH_STEPS, 1))
    for name, opts in (("config4_100k", {}),
                       ("config4_100k_dedup", dict(pallas_dedup_slots=DEDUP_SLOTS))):
        pf = ParticleFilter(gm, MCLConfig(max_particles=CONFIG4_PARTICLES, **opts))
        pf.set_beam_angles(beams)
        cells[name] = pairs(pf, pf.init_global(seed=100), actions, scans)
        timed(name)
        del pf
        torch.cuda.empty_cache()
    pf = ParticleFilter(gm, MCLConfig(max_particles=BENCH_MILLION))
    pf.set_beam_angles(beams)
    pose = _start_pose(gm)
    scans = np.tile(_synth_scan(gm, beams, pose), (GRAPH_MILLION_STEPS, 1))
    cells["million"] = pairs(pf, pf.init_pose(pose, seed=1), actions[:GRAPH_MILLION_STEPS],
                             scans, per_step=False)
    timed("million")
    del pf, gm
    torch.cuda.empty_cache()

    maps, stacked, asg, beams, poses0, scans5 = config5_fleet_inputs(device)
    f = CONFIG5_FLEET
    ff = FleetFilter(stacked, f, MCLConfig(max_particles=N_PARTICLES, lut_theta_bins=720),
                     map_assignment=asg)
    ff.set_beam_angles(beams)
    s0 = ff.init_pose(poses0, seed=1)
    acts = np.zeros((CONFIG5_CHAIN, f, 3), np.float32)
    scans_k = np.tile(scans5, (CONFIG5_CHAIN, 1, 1))

    def fleet_one_at_a_time():
        s = s0
        for i in range(CONFIG5_CHAIN):
            s, _ = ff.step(s, acts[i], scans5)

    cells["config5"] = dict(
        chained=graph_pair(lambda: ff.step_many(s0, acts, scans_k), CONFIG5_CHAIN, ff.programs),
        per_step=graph_pair(fleet_one_at_a_time, CONFIG5_CHAIN, ff.programs))
    timed("config5")
    del ff, maps, stacked
    torch.cuda.empty_cache()
    return cells


def phase_graphs(device) -> dict:
    """The JAX package's compiled step programs as CUDA graphs
    (``utils/graphs.py``): every program held ``torch.equal`` to its
    eager run under ``disable_graphs()`` on the same draws, given and
    from the generator (:func:`graph_programs`), with launches equal to
    corrections, and the eager/graph timing pairs (:func:`graph_cells`)."""
    t0 = time.perf_counter()
    programs = graph_programs(device)
    cells = graph_cells(device)
    summary = {name: {kind: (r["equal"], r["first_differing_step"]) for kind, r in res.items()
                      if isinstance(r, dict) and "equal" in r}
               for name, res in programs.items()}
    emit("graphs", t0, card=CARD, chain=GRAPH_CHAIN, equal=summary, programs=programs,
         cells=cells)
    for name, res in programs.items():
        gate_held("graphs", name, res)
        check(res.get("graphs", 2) == 2, f"graphs: {name} captured {res.get('graphs')} graphs, "
                                         "not one for the given draws and one for the generators'")
    check(programs["mega_cooperative"]["graphs"] == 2,
          "graphs: the mega step's cooperative launch did not run as a graph")
    check(programs["inject_step"]["programs"] == 2,
          f"graphs: the injection step took {programs['inject_step']['programs']} programs")
    return dict(programs=programs, cells=cells)


def phase_probes(device) -> dict:
    """The probes of tools/mega_probe.py through their Hopper kernels (the
    port's ``tools/mega_probe.py``): every probe once with the launch
    counts reset (a failed probe or a kernel off its plain version fails
    the run), then each kernel call timed: kernel and library ms as CUDA
    graphs, wrapper ms, plain ms, bound. The gather and the normals run
    at the probe's shape and at 4,000, 100,000 and 1,000,000 particles,
    each timed beside the kernel as first ported (``ported_ms``)."""
    import torch

    from monte_carlo_localization_tpu_torch.ops.probes import Probes
    from monte_carlo_localization_tpu_torch.tools.mega_probe import PROBES, measure
    from monte_carlo_localization_tpu_torch.utils.timing import graph_ms

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
    # the calls redesigned against their library call: both times, and
    # the launch the wrapper chose (grid, threads, shared memory); the
    # gather and the normals at the main path's sizes also against the
    # kernel as first ported and the bound
    redesigned = [
        {k: m[k] for k in ("label", "ms", "library_ms", "shape")}
        for name in ("scratch", "smem_roundtrip", "cumsum", "mega_parts") for m in timed[name]
        if name != "mega_parts" or " roll " in m["label"]
    ] + [
        {k: m[k] for k in ("label", "ms", "library_ms", "ported_ms", "bound_ms", "bound_by",
                           "shape")}
        for name in ("smem", "rng") for m in timed[name]
    ]
    # the least a graph node costs on this card, for the launch-bound
    # probes: a kernel (a PyTorch fill of one float) and a memcpy node (a
    # copy of one float, the node the staged writes' library call is)
    one, other = torch.zeros(1, device=device), torch.ones(1, device=device)
    floors = dict(kernel_node_ms=graph_ms(lambda: one.fill_(1.0)),
                  memcpy_node_ms=graph_ms(lambda: one.copy_(other)))
    from monte_carlo_localization_tpu_torch.ops._cuda_build import load_library

    from monte_carlo_localization_tpu_torch.tools.mega_probe import normals_error_bound

    # the normals' largest difference from the plain version over every input
    normals_bound = normals_error_bound(pr, device)
    check(normals_bound["bound"] <= 1e-5, f"probes: normals bound {normals_bound}")
    sass = sass_counts(load_library().paths["probes"])
    check(len(sass) == len(SASS_KERNELS) + 1, f"probes: SASS of {sorted(sass)}")
    emit("probes", t0, passed=list(calls), launches=launches, redesigned=redesigned,
         **floors, normals_bound=normals_bound, sass=sass, calls=timed)
    return dict(launches=launches, timed=timed, sass=sass)


# the probe kernels whose instructions the probes phase counts: the two
# redesigned for the main path's sizes and their forms as first ported
SASS_KERNELS = ("probe_gather_rows_kernel", "gather_rows_staged_kernel",
                "probe_philox_normals_kernel", "philox_normals_pair_kernel")
SASS_OPS = ("IMAD.WIDE.U32", "IMAD.HI.U32", "LOP3.LUT", "FFMA", "FMUL", "MUFU", "I2F", "BRA",
            "LDG", "STG", "LDL", "STL")


def sass_counts(so_path: Path, kernels=SASS_KERNELS) -> dict:
    """Static SASS of each named kernel of a built library (``cuobjdump
    -sass``, beside nvcc), by mangled name: its instructions and those of
    the opcodes that bound the probes (64-bit integer products, logic,
    float math, the special-function unit, conversions, branches, memory).
    Static: every path of the function counts once, taken or not."""
    from monte_carlo_localization_tpu_torch.ops._cuda_build import nvcc_path

    tool = Path(nvcc_path()).with_name("cuobjdump")
    txt = subprocess.run([str(tool), "-sass", str(so_path)], capture_output=True, text=True,
                         check=True, timeout=120).stdout
    counts, name = {}, None
    for line in txt.splitlines():
        if "Function : " in line:
            name = line.split("Function : ")[1].strip()
            name = name if any(k in name for k in kernels) else None
            if name:
                counts[name] = {"total": 0}
            continue
        parts = line.split("*/", 1)
        if name is None or not parts[0].strip().startswith("/*") or len(parts) < 2:
            continue
        words = parts[1].split()
        if not words or words[0].startswith("0x"):
            continue
        op = words[1] if words[0].startswith("@") and len(words) > 1 else words[0]
        counts[name]["total"] += 1
        for key in SASS_OPS:
            if op.startswith(key):
                counts[name][key] = counts[name].get(key, 0) + 1
    return counts


def probe_entries(probes: dict) -> list[dict]:
    """The kernels-line entries of the four probe kernels."""
    timed, launches = probes["timed"], probes["launches"]
    keys = ("ms", "time_source", "wrapper_ms", "plain_ms", "library_ms", "ported_ms", "bound_ms",
            "bound_by", "rows_off", "shape")
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
              timed["smem"][0], timed["smem"][1:]),
        entry("probe_philox_normals", "philox_normals", "tools/mega_probe.py:97",
              timed["rng"][0], timed["rng"][1:]),
        entry("probe_staged_writes", "staged_writes", "tools/mega_probe.py:155, 303",
              timed["scratch"][0], timed["smem_roundtrip"]),
        entry("probe_scan_resample", "scan_resample",
              "tools/mega_probe.py:127, 238, 369, 380, 401, 423, 436, 487, 526, 567",
              timed["mega_ops"][0], scans),
    ]


# --- the single-filter runtime and the command line -------------------
CLI_RMSE_MAX = CONFIG1_RMSE_MAX  # m, config #1 through the CLI, per correction and chained
# m, 1.5x the 0.0427 m the JAX engine records on the u16 golden trace
# (BENCHES.md, "u16 (long-range) LUT family")
U16_RMSE_MAX = 0.064
U16_MAX_RANGE = 25.6  # m: 507 px on basement_fixed, u16 LUT entries
LIVE_POSE_TOL = 0.15  # m, the live run's last harvested pose vs the truth at its scan
INJECT_RMSE_MAX = CONFIG1_RMSE_MAX  # m, config #1 replayed with Augmented-MCL injection
METHODS_RMSE_MAX = CONFIG1_RMSE_MAX  # m, config #1 under --raycast lut, sphere and dda
LIVE_SECONDS = 10.0  # seconds of the config #1 trace fed in real time
LIVE_CHUNK = 4
RESUME_SCANS = 50  # scans replayed after resuming from a checkpoint
CONFIG1_MAP = "maps/map_1753950572.yaml"
CONFIG1_TRACE = "traces/config1_map_1753950572.npz"


def run_cli(argv: list[str]):
    """``cli.main(argv)`` in this process, with its node recorded: returns
    (the JSON line it printed, the node). The node times its first
    ``on_scan`` (the LUT build) and keeps the trace index of the latest
    scan behind each async dispatch."""
    import contextlib
    import io

    from monte_carlo_localization_tpu_torch import cli

    made = []

    class Recording(cli.MCLNode):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.lut_build_s = None
            self.scans_seen = 0
            self.dispatch_scans = []
            made.append(self)

        def on_scan(self, *a, **k):
            first = not self.lidar_initialized
            t0 = time.perf_counter()
            super().on_scan(*a, **k)
            if first:
                self.lut_build_s = time.perf_counter() - t0
            self.scans_seen += 1

        def _enqueue_dispatch(self, pose_dev, t_mono, count):
            self.dispatch_scans.append(self.scans_seen - 1)
            super()._enqueue_dispatch(pose_dev, t_mono, count)

    out = io.StringIO()
    saved, cli.MCLNode = cli.MCLNode, Recording
    try:
        with contextlib.redirect_stdout(out):
            rc = cli.main(argv)
    finally:
        cli.MCLNode = saved
    check(rc == 0 and len(made) == 1, f"cli {argv[0]} returned {rc} with {len(made)} nodes")
    return json.loads(out.getvalue().strip().splitlines()[-1]), made[0]


def node_updates(node, steps: int):
    """``steps`` synchronous ``MCLNode.update`` ticks 40 ms apart on the
    node's latest scan (each reads its pose back), for ``chain_profile``."""
    def run():
        for _ in range(steps):
            node._last_update_time = 0.0
            node.update(now=0.04)
    return run


def lut_counts(node) -> dict:
    q, mega = node.filter.likelihood, node.filter.mega
    return dict(lut_loglik_kernel=q.launch_count, log_norm_kernel=q.table_launch_count,
                mega_step_kernel=0 if mega is None else mega.mega.launch_count)


def trace_slice(trace, first: int, last: int, path: Path) -> Path:
    """Scans first..last-1 of a trace with the odometry and truth of their
    time window, written to ``path``."""
    from monte_carlo_localization_tpu_torch.runtime import Trace

    lo, hi = trace.scan_t[first], trace.scan_t[last - 1]
    od = (trace.odom_t >= lo) & (trace.odom_t <= hi)
    tt = (trace.truth_t >= lo) & (trace.truth_t <= hi)
    return Trace(odom_t=trace.odom_t[od], odom_pose=trace.odom_pose[od],
                 odom_twist=trace.odom_twist[od], scan_t=trace.scan_t[first:last],
                 scan_ranges=trace.scan_ranges[first:last], beam_angles=trace.beam_angles,
                 truth_t=trace.truth_t[tt], truth_pose=trace.truth_pose[tt],
                 map_name=trace.map_name).save(path)


def phase_cli_replay(device, tmp: Path) -> dict:
    """``cli replay`` of config #1: one correction per scan through the
    tracker with a JSONL sink and a checkpoint; chained, with and without
    ``pallas_mega``; a resume from a checkpoint written after 450 scans
    for the last RESUME_SCANS."""
    import torch

    from monte_carlo_localization_tpu_torch.runtime import Trace, load_state

    t0 = time.perf_counter()
    common = ["--device", str(device), "--map", str(REPO / CONFIG1_MAP),
              "--particles", str(N_PARTICLES)]
    trace = str(REPO / CONFIG1_TRACE)
    mega_cfg = tmp / "mega.yaml"
    mega_cfg.write_text("pallas_mega: true\n")
    runs = {}
    for name, extra in (
        ("per_correction", ["--record-out", str(tmp / "run.jsonl"),
                            "--checkpoint-out", str(tmp / "run.npz")]),
        ("chained", ["--chained"]),
        ("chained_mega", ["--chained", "--config", str(mega_cfg)]),
    ):
        sweep_reset()
        out, node = run_cli(["replay", *common, "--trace", trace, "--init", "truth", *extra])
        counts = lut_counts(node)
        built = lut_built_on_card(f"cli_{name}", node.filter.grid_map)
        k = out["corrections"]
        check(np.isfinite(node.inferred_pose).all(), f"cli replay {name}: non-finite pose")
        check(out["rmse_xy_m"] <= CLI_RMSE_MAX,
              f"cli replay {name}: RMSE {out['rmse_xy_m']} m > {CLI_RMSE_MAX}")
        kernel = "mega_step_kernel" if name == "chained_mega" else "lut_loglik_kernel"
        check(counts[kernel] == k, f"cli replay {name}: {counts[kernel]} {kernel} launches "
              f"for {k} corrections")
        if name == "chained_mega":
            check(counts["lut_loglik_kernel"] == 0, "the mega replay launched the LUT kernel")
        runs[name] = dict(**out, launches=counts,
                          launches_per_correction={c: n / k for c, n in counts.items()},
                          first_scan_s=node.lut_build_s, **built)
        if name == "per_correction":
            runs[name]["profile_20_updates"] = chain_profile(node_updates(node, 20), 20)
        del node
    events = (tmp / "run.jsonl").read_text().splitlines()
    poses = sum(json.loads(e)["topic"] == "pose" for e in events)
    check(poses == runs["per_correction"]["corrections"],
          f"the sink got {poses} poses for {runs['per_correction']['corrections']} corrections")
    state, meta = load_state(tmp / "run.npz", device=device)
    check(bool(torch.isfinite(state.particles).all()) and meta["iters"] > 0,
          "the replay's checkpoint does not load")

    tr = Trace.load(trace)
    k = len(tr.scan_t)
    head = trace_slice(tr, 0, k - RESUME_SCANS, tmp / "head.npz")
    tail = trace_slice(tr, k - RESUME_SCANS, k, tmp / "tail.npz")
    run_cli(["replay", *common, "--trace", str(head), "--checkpoint-out", str(tmp / "head_ck.npz")])
    out, node = run_cli(["replay", *common, "--trace", str(tail), "--resume-from",
                         str(tmp / "head_ck.npz")])
    check(out["corrections"] == RESUME_SCANS - 1 and np.isfinite(out["rmse_xy_m"]),
          f"the resumed replay ran {out['corrections']} corrections, RMSE {out['rmse_xy_m']}")
    runs["resumed"] = dict(**out, launches=lut_counts(node), iters=node.iters)
    del node
    torch.cuda.empty_cache()
    emit("cli_replay", t0, rmse_max_m=CLI_RMSE_MAX, sink_events=len(events), runs=runs)
    return runs


def phase_u16_basement(device, tmp: Path) -> dict:
    """The u16 golden trace: ``cli replay --chained --init truth
    --max-range 25.6`` on basement_fixed, 4000 particles x 60 beams on the
    compact u16 LUT (507 px), built here."""
    import torch

    t0 = time.perf_counter()
    sweep_reset()
    out, node = run_cli(["replay", "--device", str(device), "--chained", "--init", "truth",
                         "--max-range", str(U16_MAX_RANGE),
                         "--map", str(REPO / "maps" / "basement_fixed.map.yaml"),
                         "--trace", str(REPO / "traces" / "u16_basement.npz"),
                         "--particles", str(N_PARTICLES)])
    gm, counts = node.filter.grid_map, lut_counts(node)
    built = lut_built_on_card("u16_basement", gm)
    lut, row_map = gm.range_lut, gm.lut_row_map
    check(lut.dtype == torch.uint16 and row_map is not None and gm.max_range_px > 254,
          f"u16_basement should take the compact u16 LUT ({lut.dtype}, {gm.max_range_px} px)")
    check(counts["lut_loglik_kernel"] == out["corrections"] == 500,
          f"{counts['lut_loglik_kernel']} LUT launches for {out['corrections']} corrections")
    check(out["rmse_xy_m"] <= U16_RMSE_MAX, f"u16_basement RMSE {out['rmse_xy_m']} m > {U16_RMSE_MAX}")
    tr, actions, scans = trace_inputs(node.filter, REPO / "traces" / "u16_basement.npz")
    s0 = node.filter.init_pose(tr["truth_pose"][0], seed=3)
    prof = chain_profile(lambda: node.filter.step_many(s0, actions[:20], scans[:20]), 20)
    res = dict(**out, launches=counts, max_range_px=gm.max_range_px, lut="compact uint16",
               lut_rows=lut.numel() // gm.row_stride, row_stride=gm.row_stride,
               row_map_bytes=row_map.numel() * row_map.element_size(),
               first_scan_s=node.lut_build_s, **built, jax_engine_rmse_xy_m=0.0427,
               profile_20_steps=prof)
    del node, gm, lut, row_map, s0
    torch.cuda.empty_cache()
    emit("u16_basement", t0, rmse_max_m=U16_RMSE_MAX, **res)
    return res


def phase_live(device, tmp: Path) -> dict:
    """``cli live`` of config #1 for LIVE_SECONDS with ``--async-correction
    --live-chunk 4``: the LiveRunner's thread ticks at 100 Hz while this
    thread feeds the trace in real time. Gates: a correction, and the last
    harvested pose within LIVE_POSE_TOL of the truth at its scan's time."""
    import torch

    from monte_carlo_localization_tpu_torch.runtime import Trace

    t0 = time.perf_counter()
    sweep_reset()
    out, node = run_cli(["live", "--device", str(device), "--map", str(REPO / CONFIG1_MAP),
                         "--trace", str(REPO / CONFIG1_TRACE), "--particles", str(N_PARTICLES),
                         "--duration", str(LIVE_SECONDS), "--async-correction",
                         "--live-chunk", str(LIVE_CHUNK)])
    check(out["corrections"] >= 1, "the live run harvested no correction")
    built = lut_built_on_card("live", node.filter.grid_map)
    harvested = len(node.dispatch_scans) - len(node._inflight_q)
    scan = node.dispatch_scans[harvested - 1]
    tr = Trace.load(REPO / CONFIG1_TRACE)
    t_scan = float(tr.scan_t[scan])
    truth = np.array([np.interp(t_scan, tr.truth_t, tr.truth_pose[:, i]) for i in range(2)])
    err = float(np.hypot(*(node.inferred_pose[:2] - truth)))
    check(err <= LIVE_POSE_TOL, f"live: last pose {err} m from the truth at {t_scan} s "
          f"> {LIVE_POSE_TOL}")
    res = dict(**out, live_chunk=LIVE_CHUNK, particles=N_PARTICLES, last_pose_err_m=err,
               last_pose_scan_t=t_scan, dispatches=len(node.dispatch_scans),
               launches=lut_counts(node), first_scan_s=node.lut_build_s, **built)
    del node
    torch.cuda.empty_cache()
    emit("live", t0, pose_tol_m=LIVE_POSE_TOL, **res)
    return res


def phase_inject(device) -> dict:
    """An ``MCLNode`` with ``auto_reinit=True, reinit_mode="inject"``
    replays config #1, one correction per scan; then ``profile_phases``
    of its filter."""
    import torch

    from monte_carlo_localization_tpu_torch import MCLConfig, load_map
    from monte_carlo_localization_tpu_torch.runtime import MCLNode, Trace, trace_actions

    t0 = time.perf_counter()
    tr = Trace.load(REPO / CONFIG1_TRACE)
    gm = load_map(REPO / CONFIG1_MAP, device=device)
    cfg = MCLConfig(max_particles=N_PARTICLES, angle_step=18, auto_reinit=True,
                    reinit_mode="inject")
    node = MCLNode(gm, cfg)
    sweep_reset()
    node.on_scan(tr.scan_ranges[0], beam_angles=tr.beam_angles)
    built = lut_built_on_card("inject", node.filter.grid_map)
    q = node.filter.likelihood
    q.launch_count = q.table_launch_count = 0
    node.initialize_pose(tr.truth_pose[0])
    res = node.replay(tr)
    launches = q.launch_count
    check(np.isfinite(res.poses).all(), "inject replay gave non-finite poses")
    check(launches == res.corrections, f"{launches} LUT launches for {res.corrections} corrections")
    check(res.rmse_xy <= INJECT_RMSE_MAX, f"inject replay RMSE {res.rmse_xy} m > {INJECT_RMSE_MAX}")
    actions = trace_actions(tr.odom_t, tr.odom_twist, tr.scan_t)
    stats = node.filter.profile_phases(node.state, actions[1],
                                       tr.scan_ranges[1, :: cfg.angle_step], iters=20)
    per = {k: getattr(stats, k) / stats.measurement_count
           for k in ("resampling_time", "motion_model_time", "sensor_model_time",
                     "total_mcl_time")}
    out = dict(corrections=res.corrections, rmse_xy_m=res.rmse_xy, rmse_theta_rad=res.rmse_theta,
               updates_per_s=res.updates_per_sec, inject_steps=node.inject_steps,
               auto_reinits=node.auto_reinits, lut_launches=launches, **built,
               profile_phases_ms=per)
    del node, gm
    torch.cuda.empty_cache()
    emit("inject", t0, rmse_max_m=INJECT_RMSE_MAX, particles=N_PARTICLES, **out)
    return out


SERVE_SECONDS = 4.0  # seconds of `cli live --serve 0` on config #1
SERVE_POLLS = 5  # /state.json polls from a second thread, 0.5 s apart
VIZ_EVERY = 100  # `replay --viz-out`: one frame every 100 corrections
BAG_TIME_TOL = 2e-9  # s: times come back through integer nanoseconds
BAG_YAW_TOL = 1e-9  # rad: headings come back through a quaternion
# rad: beam angles come back as angle_min + k * increment from the scan's
# float32 fields (1.7e-5 at config #1's 1080 beams, in both packages)
BAG_BEAM_TOL = 1e-4


def cli_json(argv: list[str]) -> dict:
    """``cli.main(argv)`` in this process (a command with no node): the
    JSON line it printed last."""
    import contextlib
    import io

    from monte_carlo_localization_tpu_torch import cli

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    check(rc == 0, f"cli {argv[0]} returned {rc}")
    return json.loads(out.getvalue().strip().splitlines()[-1])


def pil_available() -> bool:
    try:
        import PIL  # noqa: F401
    except ImportError:
        return False
    return True


def bag_roundtrip_errors(orig, back) -> dict:
    """What a rosbag2 round trip may change of a trace, against its own
    gates: scans, twists and xy are stored as they are and must come back
    bit for bit; times, headings and beam angles within BAG_TIME_TOL,
    BAG_YAW_TOL and BAG_BEAM_TOL."""
    def yaw_err(a, b):
        return float(np.abs(np.angle(np.exp(1j * (a - b)))).max())

    for name in ("scan_ranges", "odom_twist"):
        check(np.array_equal(getattr(orig, name), getattr(back, name)),
              f"the bag round trip changed {name}")
    for name in ("odom_pose", "truth_pose"):
        check(np.array_equal(getattr(orig, name)[:, :2], getattr(back, name)[:, :2]),
              f"the bag round trip changed {name} x/y")
    errs = dict(
        time_s=max(float(np.abs(getattr(orig, k) - getattr(back, k)).max())
                   for k in ("odom_t", "scan_t", "truth_t")),
        yaw_rad=max(yaw_err(orig.odom_pose[:, 2], back.odom_pose[:, 2]),
                    yaw_err(orig.truth_pose[:, 2], back.truth_pose[:, 2])),
        beam_angle_rad=float(np.abs(orig.beam_angles - back.beam_angles).max()),
    )
    check(errs["time_s"] <= BAG_TIME_TOL and errs["yaw_rad"] <= BAG_YAW_TOL
          and errs["beam_angle_rad"] <= BAG_BEAM_TOL, f"the bag round trip moved {errs}")
    return errs


def phase_runtime_io(device, tmp: Path) -> dict:
    """The runtime's I/O on config #1: ``cli export-bag`` of the golden
    trace and ``cli import-bag`` back (the trace must come back as the
    round trip keeps it), ``cli replay --chained`` of the imported trace
    on the card (config #1's RMSE gate), ``cli live --serve 0`` with
    /state.json (and /frame.png where PIL imports) polled from a second
    thread while the loop runs, and ``replay --viz-out`` where PIL
    imports."""
    import threading
    import urllib.request

    import torch

    from monte_carlo_localization_tpu_torch import cli
    from monte_carlo_localization_tpu_torch.runtime import Trace

    t0 = time.perf_counter()
    pil = pil_available()
    orig = Trace.load(REPO / CONFIG1_TRACE)
    bag, back = tmp / "config1_bag", tmp / "config1_back.npz"
    t1 = time.perf_counter()
    exported = cli_json(["export-bag", "--trace", str(REPO / CONFIG1_TRACE), "--out", str(bag)])
    imported = cli_json(["import-bag", "--bag", str(bag), "--out", str(back),
                         "--map-name", orig.map_name])
    bag_s = time.perf_counter() - t1
    errs = bag_roundtrip_errors(orig, Trace.load(back))
    common = ["--device", str(device), "--map", str(REPO / CONFIG1_MAP),
              "--particles", str(N_PARTICLES)]

    sweep_reset()
    out, node = run_cli(["replay", *common, "--trace", str(back), "--chained"])
    built = lut_built_on_card("runtime_io_replay", node.filter.grid_map)
    counts = lut_counts(node)
    check(out["rmse_xy_m"] <= CLI_RMSE_MAX,
          f"the imported trace's replay: RMSE {out['rmse_xy_m']} m > {CLI_RMSE_MAX}")
    check(counts["lut_loglik_kernel"] == out["corrections"],
          f"{counts['lut_loglik_kernel']} LUT launches for {out['corrections']} corrections")
    replay = dict(**out, launches=counts, **built)
    del node

    polls, frames, errors = [], [], []

    class Polled(cli.WebViz):
        """The viewer, polled from a second thread while the loop runs."""

        def start(self):
            super().start()

            def poll():
                try:
                    for _ in range(SERVE_POLLS):
                        time.sleep(0.5)
                        with urllib.request.urlopen(self.url + "state.json", timeout=30) as rsp:
                            polls.append(json.loads(rsp.read()))
                        if pil:
                            with urllib.request.urlopen(self.url + "frame.png", timeout=30) as rsp:
                                frames.append(rsp.read()[:4])
                except Exception as e:  # noqa: BLE001 - re-raised by the phase below
                    errors.append(e)

            self.poller = threading.Thread(target=poll, daemon=True)
            self.poller.start()
            return self

        def close(self):
            self.poller.join(timeout=60)
            super().close()

    saved, cli.WebViz = cli.WebViz, Polled
    sweep_reset()
    try:
        out, node = run_cli(["live", *common, "--trace", str(REPO / CONFIG1_TRACE),
                             "--duration", str(SERVE_SECONDS), "--serve", "0"])
    finally:
        cli.WebViz = saved
    if errors:
        raise errors[0]
    check(len(polls) == SERVE_POLLS and all(np.isfinite(p["pose"]).all() for p in polls),
          f"live --serve: {len(polls)} of {SERVE_POLLS} /state.json replies with finite poses")
    check(frames == [b"\x89PNG"] * (SERVE_POLLS if pil else 0),
          f"live --serve: /frame.png replies {frames}")
    check(out["corrections"] >= 1, "live --serve harvested no correction")
    serve = dict(**out, polls=len(polls), last_poll=polls[-1], frames=len(frames),
                 launches=lut_counts(node), **lut_built_on_card("runtime_io_serve",
                                                                node.filter.grid_map))
    del node

    viz = dict(rendered=False, reason="PIL does not import here: no PNG was rendered")
    if pil:
        sweep_reset()
        out, node = run_cli(["replay", *common, "--trace", str(REPO / CONFIG1_TRACE),
                             "--viz-out", str(tmp / "viz"), "--viz-every", str(VIZ_EVERY)])
        names = sorted(p.name for p in (tmp / "viz").glob("*.png"))
        want = -(-out["corrections"] // VIZ_EVERY)
        check(len(names) == want + 1 and names[-1] == "trajectory.png",
              f"replay --viz-out wrote {names} for {out['corrections']} corrections")
        viz = dict(rendered=True, **out, frames=len(names) - 1, every=VIZ_EVERY,
                   launches=lut_counts(node))
        del node
    torch.cuda.empty_cache()
    emit("runtime_io", t0, card=CARD, pil=pil, export=exported, imported=imported,
         bag_seconds=bag_s, roundtrip_errors=errs, replay_imported=replay, live_serve=serve,
         viz_out=viz, rmse_max_m=CLI_RMSE_MAX)
    return dict(replay=replay, serve=serve, viz=viz)


# the bench phase: the port's harness (monte_carlo_localization_tpu_torch/
# bench.py) on the workloads chip_smoke's other phases do not drive, at
# full width, cut in depth only (rounds, trials, windows)
BENCH_MILLION = 1_000_000  # bench.py run_million: particles of the 1M workload
BENCH_MILLION_ROUNDS = 2  # bench_updates rounds at 1M (chain 10, reps 2)
BENCH_MILLION_TRIALS = 2  # bench_convergence trials at 1M (max_updates 60)
BENCH_MEGA_AB = dict(particles=4000, beams=1080, chain=50, reps=2, rounds=2)  # on Spielberg
BENCH_MEGA_LUT_BYTES = 2000 * 2000 * 3072  # Spielberg's dense u8 LUT at 1080 beams: 12.3 GB
BENCH_ABLATE = dict(particles=4000, beams=60, chain=50, reps=2)  # config #1's shape
BENCH_UNROLL = dict(particles=4000, beams=60, chain=48, reps=2, unroll=16)  # u = 1 .. 16
BENCH_SIBAL1_RANGE_PX = 239  # int(12 m / the f32-fuzzed 0.05000000074505806 m) of config #2
# the keys of the JAX harness's lines (bench.py run_config / run_headline,
# run_million, bench_convergence's lines, run_fleet_giant, run_kidnap,
# run_live), and the rates each must show finite and positive
BENCH_UPDATES_KEYS = {"metric", "value", "unit", "vs_baseline", "value_min", "value_max", "rounds",
                      "dispatch_updates_per_sec", "dispatch_min", "dispatch_max", "rays_per_sec",
                      "method"}
BENCH_LINES = {
    "updates": (BENCH_UPDATES_KEYS, ("value", "value_min", "value_max", "dispatch_updates_per_sec",
                                     "dispatch_min", "dispatch_max", "rays_per_sec")),
    "million": ({"metric", "value", "unit", "vs_baseline", "spread", "dispatch", "ns_per_particle",
                 "method"}, ("value", "ns_per_particle")),
    "converge": ({"metric", "value", "unit", "vs_baseline", "success_rate", "median_updates",
                  "trials", "method"}, ()),
    "fleet": ({"metric", "value", "unit", "vs_baseline", "value_min", "value_max", "rounds",
               "member_updates_per_sec", "chained_fleet_steps_per_sec", "rays_per_sec",
               "lut_bytes", "method"},
              ("value", "value_min", "value_max", "member_updates_per_sec",
               "chained_fleet_steps_per_sec")),
    "kidnap": ({"metric", "value", "unit", "vs_baseline", "recovery_rate", "arm", "eligible",
                "trials", "method"}, ()),
    "live": ({"metric", "value", "unit", "vs_baseline", "spread", "median_pose_staleness_ms",
              "method"}, ("value",)),
}


def bench_line(res: dict, device, kind: str) -> dict:
    """``res`` as the harness prints it (``bench.labelled``), parsed back;
    raises unless it has the JAX line's keys, the card's name and power
    limit, and finite, positive rates."""
    from monte_carlo_localization_tpu_torch import bench

    line = json.loads(json.dumps(bench.labelled(res, device)))
    keys, rates = BENCH_LINES[kind]
    missing = keys - set(line)
    check(not missing, f"bench line {line.get('metric')!r} lacks the JAX keys {sorted(missing)}")
    import torch

    check(line["device"] == torch.cuda.get_device_name(device) and line["power_limit_w"] > 0,
          f"bench line {line['metric']!r} names {line['device']!r} at {line['power_limit_w']} W")
    for k in rates:
        check(math.isfinite(line[k]) and line[k] > 0,
              f"bench line {line['metric']!r}: {k} = {line[k]}")
    return line


def k2_compare(pf, particles, scan, what: str) -> dict:
    """The LUT kernel of a harness filter ``pf`` on ``particles`` and its
    ``scan`` (meters) against the plain version; raises past KERNEL_TOL.
    Its launch is made outside the filter's steps, so the harness does not
    count it."""
    import torch

    from monte_carlo_localization_tpu_torch.ops.lut_query import lut_log_weights_reference

    gm, q = pf.grid_map, pf.likelihood
    obs = pf.sensor.to_pixel_index(torch.as_tensor(scan, device=particles.device)).float()
    got = q(gm.range_lut, particles, obs, row_map=gm.lut_row_map)
    want = lut_log_weights_reference(q, gm.range_lut, particles, obs, gm.lut_row_map)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    check(err <= KERNEL_TOL, f"{what}: K2 vs plain {err} > {KERNEL_TOL}")
    return dict(max_abs_err=err, particles=int(particles.shape[0]), beams=int(obs.shape[0]),
                max_range_px=int(gm.max_range_px))


def bench_launches(what: str, single: bool = True) -> dict:
    """The kernel launches the harness's wrappers counted in the workload
    just run (``bench.LAUNCHES``), held to its corrections: one LUT-kernel
    launch per correction of a filter, one fleet launch per fleet
    correction, and no other kernel."""
    from monte_carlo_localization_tpu_torch import bench

    got = dict(bench.LAUNCHES)
    kernel, corr = (("lut_loglik", "corrections") if single
                    else ("lut_loglik_fleet", "fleet_corrections"))
    check(got.get(corr, 0) > 0 and got.get(kernel, 0) == got[corr],
          f"{what}: {got.get(kernel, 0)} {kernel} launches for {got.get(corr, 0)} {corr}")
    others = {k: v for k, v in got.items() if k not in (kernel, corr) and v}
    check(not others, f"{what}: other launches or corrections {others}")
    return got


def phase_bench(device) -> dict:
    """The port's benchmark harness on the workloads no other phase runs,
    at full width (every workload's particles, beams and maps), cut in
    depth: config #2 (``run_config(2, quick=True)``, sibal1 at the fuzzed
    resolution, max_range_px 239), K2 held against its plain version on a
    filter of config #2 after 10 corrections; 1,000,000 particles on
    basement_fixed (``bench_updates`` chain 10, reps 2,
    BENCH_MILLION_ROUNDS rounds, and BENCH_MILLION_TRIALS
    ``bench_convergence`` trials of at most 60 updates), with a profile of
    10 chained corrections of the filter ``bench_updates`` times and K2
    held against its plain version on its 1M particles; the giant fleet
    (``run_fleet_giant(quick=True)``: 16 cars over basement and its
    rotation, per-member compact LUTs), its fleet kernel held against the
    plain version on all 16 x 4000 particles and a profile of 10 chained
    corrections; the three kidnap arms
    (``run_kidnap(quick=True)``); the live loop at chunks 1, 8 and 32
    (``run_live(quick=True)``); the synthetic 768^2 headline; the mega
    A/B on Spielberg's 12.3 GB dense LUT (``tools/mega_ab.py``, K6 held
    to its plain version there); ``tools/perf_ablate.py`` at config #1's
    shape; and the three examples at their default sizes. Every LUT comes
    from the sweep kernel, every workload's kernel launches equal its
    corrections, and each workload's LUTs are freed before the next."""
    import gc

    import torch

    from monte_carlo_localization_tpu_torch import bench
    from monte_carlo_localization_tpu_torch.examples import (
        fleet_live_loop,
        fleet_racing,
        localize_on_map,
    )
    from monte_carlo_localization_tpu_torch.ops.range_lut_sweep import sweep
    from monte_carlo_localization_tpu_torch.tools import mega_ab, perf_ablate

    t_phase = time.perf_counter()
    torch.zeros(1, device=device)  # the allocator keeps peak stats once it has allocated
    base_bytes = torch.cuda.memory_allocated(device)
    subs, lines, launches = {}, {}, {}

    def run(name: str, fn):
        """One workload, with every count set to 0 just before it; its
        seconds, sweep launches and peak device bytes recorded."""
        bench.LAUNCHES.clear()
        sweep_reset()
        torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        out = fn()
        seconds = time.perf_counter() - t0
        check(sweep.launch_count > 0, f"bench {name}: no LUT built by the sweep kernel")
        SWEEP_LAUNCHES[f"bench_{name}"] = sweep.launch_count
        subs[name] = dict(seconds=seconds, sweep_launches=sweep.launch_count,
                          peak_device_bytes=torch.cuda.max_memory_allocated(device))
        return out

    def freed(name: str) -> None:
        """Free the workload's LUTs (its nodes may hold reference cycles)
        and check that it left less than 1 GiB allocated."""
        gc.collect()
        torch.cuda.empty_cache()
        left = torch.cuda.memory_allocated(device) - base_bytes
        check(left < 1 << 30, f"bench {name}: {left} B still allocated after the workload")
        subs[name]["left_bytes"] = left

    # config #2, then K2 against its plain version on a config #2 filter
    def config2():
        res = bench.run_config(2, quick=True, device=device)
        c = bench.CONFIGS[2]
        gm = bench._load_real_map(bench.CONFIG_MAPS[2], device)
        pf, state, scan = bench._build_single(c["particles"], c["beams"], gm)
        check(pf.grid_map.max_range_px == BENCH_SIBAL1_RANGE_PX
              and pf.grid_map.lut_route == "kernel",
              f"config #2: max_range_px {pf.grid_map.max_range_px}, LUT by "
              f"{pf.grid_map.lut_route!r}")
        state, _ = pf.step_many(state, np.zeros((10, 3), np.float32), np.tile(scan, (10, 1)))
        return res, k2_compare(pf, state.particles, scan, "config #2 (sibal1)")

    res, k2_config2 = run("config2", config2)
    lines["config2"] = [bench_line(res, device, "updates")]
    launches["config2"] = bench_launches("config #2")
    subs["config2"]["k2_vs_plain"] = k2_config2
    freed("config2")

    # 1,000,000 particles on basement_fixed: a profile of the filter that
    # bench_updates then times, K2 against its plain version on its
    # particles, and the convergence trials
    def million():
        gm = bench._load_real_map(bench.CONFIG_MAPS[4], device)
        setup = bench._build_single(BENCH_MILLION, 60, gm)
        pf, state, scan = setup
        check(gm.max_range_px <= 254 and pf.grid_map.lut_route == "kernel",
              f"1M: LUT by {pf.grid_map.lut_route!r}")
        act, scans = np.zeros((10, 3), np.float32), np.tile(scan, (10, 1))
        moved, _ = pf.step_many(state, act, scans)
        prof = chain_profile(lambda: pf.step_many(state, act, scans), 10)
        upd = bench.bench_updates(BENCH_MILLION, 60, gm, chain=10, reps=2,
                                  rounds=BENCH_MILLION_ROUNDS, setup=setup)
        k2 = k2_compare(pf, moved.particles, scan, "1M")
        del setup, pf, state, moved
        gc.collect()
        torch.cuda.empty_cache()
        conv = bench.bench_convergence(BENCH_MILLION, 60, gm, trials=BENCH_MILLION_TRIALS,
                                       max_updates=60)
        return prof, k2, bench.million_lines(BENCH_MILLION, False, "lut_pallas", upd, conv)

    prof_1m, k2_1m, res = run("million", million)
    lines["million"] = [bench_line(res[0], device, "million"),
                        bench_line(res[1], device, "converge")]
    check(len(lines["million"][1]["trials"]) == BENCH_MILLION_TRIALS, "1M: trials missing")
    check(k2_1m["particles"] == BENCH_MILLION, f"1M: K2 held on {k2_1m['particles']} particles")
    launches["million"] = bench_launches("1M")
    subs["million"].update(profile_10_steps=prof_1m, k2_vs_plain=k2_1m)
    freed("million")

    # the giant fleet: its kernel against the plain version and a profile,
    # then the harness
    def fleet_giant():
        from monte_carlo_localization_tpu_torch.ops.lut_query import lut_log_weights_reference

        maps = bench._giant_fleet_maps(device)
        ff, state, poses0, scans = bench._fleet_setup(16, 4000, 60, maps, "lut_pallas")
        gm, q = ff.map, ff.likelihood
        check(gm.lut_row_map is not None and gm.lut_row_map_base is not None
              and gm.lut_route == "kernel", "fleet giant: per-member compact LUTs on the card")
        act, scans_k = np.zeros((10, 16, 3), np.float32), np.tile(scans, (10, 1, 1))
        state, _ = ff.step_many(state, act, scans_k)
        prof = chain_profile(lambda: ff.step_many(state, act, scans_k), 10)
        parts = state.particles.reshape(-1, 3).contiguous()
        obs = ff.sensor.to_pixel_index(torch.as_tensor(scans, device=device)).float()
        fleet = dict(origins=(gm.origin_x, gm.origin_y), map_of=ff._member_map,
                     dims=gm.member_dims, lut_bases=gm.lut_member_base,
                     row_map_bases=gm.lut_row_map_base)
        cmp = fleet_compare(q, gm.range_lut, parts, obs, gm.lut_row_map, fleet,
                            "fleet giant kernel", synthetic=False)
        tables = q.fleet_tables(parts, obs, gm.lut_row_map, **fleet)
        cmp.update(
            kernel_device_ms=device_ms(lambda: q.launch(gm.range_lut, parts, obs, gm.lut_row_map,
                                                        tables), "lut_loglik_kernel")["ms"],
            plain_ms=event_ms(lambda: lut_log_weights_reference(
                q, gm.range_lut, parts, obs, gm.lut_row_map, tables), iters=5),
            lut_bytes=gm.range_lut.numel() * gm.range_lut.element_size())
        del ff, state, parts, tables
        gc.collect()
        torch.cuda.empty_cache()
        return prof, cmp, bench.run_fleet_giant(quick=True, device=device)

    prof_fg, cmp_fg, res = run("fleet_giant", fleet_giant)
    lines["fleet_giant"] = [bench_line(res, device, "fleet")]
    launches["fleet_giant"] = bench_launches("fleet giant", single=False)
    subs["fleet_giant"].update(profile_10_steps=prof_fg, kernel_vs_plain=cmp_fg)
    freed("fleet_giant")

    # the three kidnap arms
    res = run("kidnap", lambda: list(bench.run_kidnap(quick=True, device=device)))
    lines["kidnap"] = [bench_line(r, device, "kidnap") for r in res]
    check([ln["arm"] for ln in lines["kidnap"]] == ["inject", "reinit", "off"],
          "kidnap: an arm is missing")
    launches["kidnap"] = bench_launches("kidnap")
    freed("kidnap")

    # the live loop at chunks 1, 8 and 32
    res = run("live", lambda: bench.run_live(quick=True, device=device))
    lines["live"] = [bench_line(r, device, "live") for r in res]
    check([ln["metric"].split("live_chunk=")[1][:2].rstrip("]") for ln in lines["live"]]
          == ["1", "8", "32"], "live: a chunk is missing")
    launches["live"] = bench_launches("live")
    freed("live")

    # the synthetic 768^2 headline
    res = run("headline_synthetic", lambda: bench.run_headline(quick=True, synthetic=True,
                                                               device=device))
    lines["headline_synthetic"] = [bench_line(res, device, "updates")]
    launches["headline_synthetic"] = bench_launches("synthetic headline")
    freed("headline_synthetic")

    # the mega A/B on Spielberg's dense LUT, K6 held to its plain version there
    def mega():
        out = mega_ab.run(**BENCH_MEGA_AB, device=device)
        arms = out["arms"]
        classic, fused = arms["classic"]["filter"], arms["mega"]["filter"]
        gm = classic.grid_map
        check(gm.lut_row_map is None and gm.lut_route == "kernel"
              and out["lut_bytes"] == BENCH_MEGA_LUT_BYTES,
              f"mega A/B: LUT of {out['lut_bytes']} B by {gm.lut_route!r} (want the dense "
              f"{BENCH_MEGA_LUT_BYTES} B by the kernel)")
        check(classic.likelihood.launch_count == arms["classic"]["corrections"]
              and fused.mega.mega.launch_count == arms["mega"]["corrections"]
              and fused.likelihood.launch_count == 0,
              f"mega A/B launches: classic {classic.likelihood.launch_count}, mega "
              f"{fused.mega.mega.launch_count}, mega's LUT kernel {fused.likelihood.launch_count}")
        counted = dict(classic=classic.likelihood.launch_count, mega=fused.mega.mega.launch_count)
        step, state = fused.mega.mega, arms["mega"]["state"]
        obs = torch.clamp(fused.sensor.to_pixel_index(
            torch.as_tensor(out["scan"], device=device)).float(), max=float(gm.max_range_px))
        noise = torch.randn((state.num_particles, 3), generator=state.generator, device=device)
        scalars = torch.tensor([0.05, 0.01, 0.0, 0.5, 0, 0, 0, 0], dtype=torch.float32,
                               device=device)
        args = (gm.range_lut, state.particles, state.log_weights, noise, obs, scalars)
        cmp = mega_compare(step, *args, "mega on Spielberg's dense LUT")
        times = mega_times(step, *args, state.num_particles - cmp["off_map"])
        summary = dict(
            lut_bytes=out["lut_bytes"], build_s=out["build_s"],
            arms={k: dict(spread=a["spread"], rates=a["rates"], err_m=a["err_m"],
                          corrections=a["corrections"]) for k, a in arms.items()},
            mega_over_classic=arms["mega"]["spread"]["median"]
            / arms["classic"]["spread"]["median"],
            launches=counted, k6_vs_plain=cmp, k6_times=times)
        return summary

    subs_mega = run("mega_ab", mega)
    subs["mega_ab"].update(subs_mega)
    freed("mega_ab")

    # perf_ablate at config #1's shape
    def ablate():
        out = perf_ablate.run(**BENCH_ABLATE, map_name=bench.CONFIG_MAPS[1], device=device)
        q = out["query"]
        check(q.launch_count == out["kernel_corrections"],
              f"perf_ablate: {q.launch_count} launches for {out['kernel_corrections']} corrections")
        check(all(math.isfinite(v) and v > 0 for v in out["median"].values()),
              f"perf_ablate rates {out['median']}")
        # --unroll: the corrections-per-replay sweep, the lax.scan unroll's counterpart
        sweep = perf_ablate.run(**BENCH_UNROLL, map_name=bench.CONFIG_MAPS[1], device=device)
        qs = sweep["query"]
        check(list(sweep["median"]) == [f"full_unroll{1 << i}" for i in range(5)],
              f"perf_ablate --unroll ran {list(sweep['median'])}")
        check(qs.launch_count == sweep["kernel_corrections"],
              f"perf_ablate --unroll: {qs.launch_count} launches for "
              f"{sweep['kernel_corrections']} corrections")
        return dict(median_updates_per_s=out["median"], marginal_ms=out["marginal_ms"],
                    full_ms=out["full_ms"], rates=out["rates"],
                    launches=q.launch_count + qs.launch_count,
                    unroll_updates_per_s=sweep["median"], unroll_rates=sweep["rates"],
                    capture=dict(out["capture"], **sweep["capture"]))

    subs_ablate = run("perf_ablate", ablate)
    subs["perf_ablate"].update(subs_ablate)
    freed("perf_ablate")

    # the three examples at their default sizes
    def examples():
        said = []
        loc = localize_on_map.run(device=device, log=said.append)
        race = fleet_racing.run(device=device, log=said.append)
        live = fleet_live_loop.run(device=device, log=said.append)
        q = race["filter"].likelihood
        check(loc["filter"].grid_map.lut_route == race["filter"].map.lut_route
              == live["node"].filter.map.lut_route == "kernel", "examples: a LUT off the kernel")
        check(q.fleet_launch_count == 15 and q.launch_count == 0,
              f"fleet_racing: {q.fleet_launch_count} fleet launches for 15 corrections")
        return dict(localize_err_m=loc["err_m"], racing_max_err_m=float(race["err_m"].max()),
                    racing_fleet_launches=q.fleet_launch_count,
                    live_loop=dict(corrections=live["corrections"], ticks=live["ticks"],
                                   skipped=live["skipped"],
                                   fleet_corrections_per_s=live["fleet_corrections_per_s"],
                                   max_err_m=float(live["err_m"].max())),
                    printed=said)

    subs_examples = run("examples", examples)
    subs["examples"].update(subs_examples)
    launches["examples"] = {"lut_loglik_fleet": subs_examples["racing_fleet_launches"]}
    freed("examples")

    emit("bench", t_phase, card=CARD, sub_phases=subs, lines=lines, launches=launches)
    single = sum(v.get("lut_loglik", 0) for v in launches.values())
    single += subs["mega_ab"]["launches"]["classic"]
    return dict(
        lut_launches=single + subs_ablate["launches"],
        fleet_launches=sum(v.get("lut_loglik_fleet", 0) for v in launches.values()),
        mega_launches=subs["mega_ab"]["launches"]["mega"],
        k6_max_abs_err=subs["mega_ab"]["k6_vs_plain"]["max_abs_err"],
        fleet_max_abs_err=subs["fleet_giant"]["kernel_vs_plain"]["max_abs_err"],
        k2_max_abs_err=max(k2_config2["max_abs_err"], k2_1m["max_abs_err"]),
        launches_by_workload=dict(launches, mega_ab=subs["mega_ab"]["launches"],
                                  perf_ablate=subs_ablate["launches"]),
    )


def main() -> int:
    global CARD
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    csrc = REPO / "monte_carlo_localization_tpu_torch" / "csrc"
    if not all((csrc / f).exists() for f in ("lut_likelihood.cu", "lut_dedup.cu", "mega_step.cu",
                                             "probes.cu", "range_lut_sweep.cu",
                                             "resample.cu", "motion.cu", "beam_model.cuh")):
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    CARD = card
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
    check(set(built.libs) == {"lut_likelihood", "lut_dedup", "mega_step", "probes",
                              "range_lut_sweep", "resample", "motion"},
          f"built {sorted(built.libs)}")
    keep = ("== ", "Compiling entry", "registers", "smem", "spill")
    ptxas = [ln.strip() for ln in built.log.splitlines() if any(k in ln for k in keep)]
    grids = {}
    for num_beams in (60, 1080):
        for max_range_px in (200, 400):
            step = mega_case(np.random.default_rng(0), _beams(num_beams), max_range_px, 8, device)[0]
            grids[f"{num_beams} beams {'u8' if max_range_px <= 254 else 'u16'}"] = {
                n: step.plan(n)[0] for n in (N_PARTICLES, CONFIG4_PARTICLES)}
    emit("build", t0, nvcc_s=built.seconds,
         so={k: str(v.relative_to(REPO)) for k, v in built.paths.items()}, ptxas=ptxas,
         mega_grid_blocks=grids, sms=torch.cuda.get_device_properties(0).multi_processor_count)

    phase_division(device)
    lut_build = phase_lut_build(device)
    lut_plain = phase_kernel_vs_plain(device)
    table = phase_norm_table(device)
    resample = phase_resample(device)
    motion = phase_motion(device)
    dedup_plain = phase_dedup_vs_plain(device)
    mega_plain = phase_mega_vs_plain(device)
    config1 = phase_config1(device)
    mega1 = phase_config1_mega(device, config1["rate"])
    graphs = phase_graphs(device)
    phase_mega_full_window(device)
    config4, gm4, beams4 = phase_config4_replay(device)
    conv = phase_config4_converge(device, gm4, beams4)
    del gm4
    torch.cuda.empty_cache()
    sharded = phase_sharded(device)
    head = phase_headline(device)
    fleet_plain = phase_fleet_vs_plain(device)
    config5 = phase_config5(device, mega1["classic_kernels_per_correction"])
    multihost = phase_multihost(device)
    fleet_live = phase_fleet_live(device)
    # the single-filter runtime through the port's command line
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        cli_runs = phase_cli_replay(device, Path(tmp))
        u16 = phase_u16_basement(device, Path(tmp))
        live = phase_live(device, Path(tmp))
        runtime_io = phase_runtime_io(device, Path(tmp))
    inject = phase_inject(device)
    phase_methods(device)
    probes = phase_probes(device)
    phase_baseline(config1["rate"])
    bench_run = phase_bench(device)
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
            "sector_bytes": c["sector_bytes"], "sector_bound_ms": c["sector_bound_ms"],
            "k1_ms_same_cloud": c["k1_device_ms"], "plan_ms": c["plan_device_ms"],
            "plan_device_kernels": c["plan_device_kernels"],
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
            "launches": (head["launches"] + sharded["d1"] + sum(sharded["d2"])
                         + bench_run["lut_launches"]),
            "max_abs_err": max(head["max_abs_err"], sharded["max_abs_err"],
                               bench_run["k2_max_abs_err"]),
            "library_ms": None,
            "sector_bytes": head["sector_bytes"], "sector_bound_ms": head["sector_bound_ms"],
            "headline_launches": head["launches"],
            # the sharded filter's K2, per shard: D = 1 (NCCL), D = 2 (gloo, per rank)
            "sharded_launches": {"d1": sharded["d1"], "d2": sharded["d2"]},
            "config1_launches": config1["launches"],
            "config4_launches": config4["k1_launches"],
            # the runtime's paths: cli replay (per correction, chained, the
            # resumed tail), u16_basement, live, the inject replay
            "runtime_launches": {
                **{f"cli_{k}": v["launches"]["lut_loglik_kernel"] for k, v in cli_runs.items()
                   if k != "chained_mega"},
                "u16_basement": u16["launches"]["lut_loglik_kernel"],
                "live": live["launches"]["lut_loglik_kernel"],
                "inject": inject["lut_launches"],
                "runtime_io_replay": runtime_io["replay"]["launches"]["lut_loglik_kernel"],
                "runtime_io_serve": runtime_io["serve"]["launches"]["lut_loglik_kernel"],
                "runtime_io_viz": (runtime_io["viz"]["launches"]["lut_loglik_kernel"]
                                   if runtime_io["viz"]["rendered"] else 0),
            },
            "synthetic_times": lut_plain["times"]["K1"],
            # the bench phase's workloads (K2, and K1 at 1080 beams)
            "bench_launches": bench_run["launches_by_workload"],
        },
        {
            "name": "lut_likelihood (subbin)",
            "route": "cuda",
            "source": "monte_carlo_localization_tpu_torch/csrc/lut_likelihood.cu",
            "replaces": "monte_carlo_localization_tpu/ops/pallas_lut.py:499",
            **{k: k3[k] for k in keys},
            "max_abs_err": max(k3["max_abs_err"], lut_plain["max_abs_err"]["K3"]),
            "library_ms": None,
            "sector_bytes": k3["sector_bytes"], "sector_bound_ms": k3["sector_bound_ms"],
            "synthetic_times": lut_plain["times"]["K3"],
        },
        {
            "name": "log_norm_table",
            "route": "cuda",
            "source": "monte_carlo_localization_tpu_torch/csrc/lut_likelihood.cu",
            "replaces": "monte_carlo_localization_tpu/ops/pallas_lut.py:411",
            "launches": config1["table_launches"],
            **{k: table["norm"][k] for k in keys[1:]},
            "library_ms": None,
        },
        {
            "name": "subbin_norm_table",
            "route": "cuda",
            "source": "monte_carlo_localization_tpu_torch/csrc/lut_likelihood.cu",
            "replaces": "monte_carlo_localization_tpu/ops/pallas_lut.py:411 (K3's normaliser, :499)",
            "launches": config4["subbin_table_fills"],
            **{k: table["subbin"][k] for k in keys[1:]},
            "library_ms": None,
        },
        *dedup_entries,
        {
            "name": "window_keys",
            "route": "cuda",
            "source": "monte_carlo_localization_tpu_torch/csrc/lut_dedup.cu",
            "replaces": "monte_carlo_localization_tpu/ops/pallas_lut.py:951-978",
            "launches": sum(c["key_launches"] for c in conv.values()),
            "max_abs_err": max([dedup_plain["key_max_abs_err"]]
                               + [c["key_max_abs_err"] for c in conv.values()]),
            **{k: conv["dedup_K4"]["key_kernel"][k] for k in keys[2:]},
            "library_ms": None,
            "plan_ms": conv["dedup_K4"]["plan_device_ms"],
            "plan_device_kernels": conv["dedup_K4"]["plan_device_kernels"],
        },
        {
            "name": "mega_step",
            "route": "cuda",
            "source": "monte_carlo_localization_tpu_torch/csrc/mega_step.cu",
            "replaces": "monte_carlo_localization_tpu/ops/pallas_mega.py:197",
            "launches": mega1["launches"] + bench_run["mega_launches"],
            "max_abs_err": max(mega1["max_abs_err"], mega_plain["max_abs_err"],
                               bench_run["k6_max_abs_err"]),
            "ms": mega1["device_ms"],
            "wrapper_ms": mega1["wrapper_ms"],
            "plain_ms": mega1["plain_ms"],
            "bound_ms": mega1["bound_ms"],
            "bound_by": mega1["bound_by"],
            "library_ms": None,
            "runtime_launches": {
                "cli_chained_mega": cli_runs["chained_mega"]["launches"]["mega_step_kernel"]},
            "bench_mega_ab_launches": bench_run["mega_launches"],
            "grid_blocks": mega1["grid_blocks"], "phase1": mega1["phase1"],
            "phase_device_ms": mega1["phase_device_ms"],
            "synthetic_times": mega_plain["times"],
        },
        {
            "name": "lut_likelihood (fleet)",
            "route": "cuda",
            "source": "monte_carlo_localization_tpu_torch/csrc/lut_likelihood.cu",
            "replaces": "monte_carlo_localization_tpu/ops/pallas_lut.py:835-949",
            **{k: config5[k] for k in keys},
            "launches": (config5["launches"] + fleet_live["launches"] + sum(multihost["launches"])
                         + bench_run["fleet_launches"]),
            "max_abs_err": max(config5["max_abs_err"], fleet_plain["max_abs_err"],
                               multihost["max_abs_err"], bench_run["fleet_max_abs_err"]),
            "library_ms": None,
            "sector_bytes": config5["sector_bytes"], "sector_bound_ms": config5["sector_bound_ms"],
            "config5_launches": config5["launches"],
            "fleet_live_launches": fleet_live["launches"],
            "multihost_launches": multihost["launches"],
            "bench_launches": bench_run["fleet_launches"],
        },
        {
            "name": "range_lut_sweep",
            "route": "cuda",
            "source": "monte_carlo_localization_tpu_torch/csrc/range_lut_sweep.cu",
            "replaces": "monte_carlo_localization_tpu/mapping/range_lut_device.py:35 (XLA lax.scan)",
            "launches": sum(SWEEP_LAUNCHES.values()),
            **{k: lut_build[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")},
            "library_ms": None,
            "shape": "Spielberg 2000 x 2000, compact u8, 1080-beam geometry (per launch)",
            **{k: lut_build[k] for k in ("build_device_ms", "build_bound_ms", "write_bound_ms",
                                         "plain_build_s", "time_source", "blocks_per_launch",
                                         "warm_share_build")},
            "launches_by_phase": SWEEP_LAUNCHES,
        },
        *probe_entries(probes),
        {
            "name": "systematic_resample",
            "route": "cuda",
            "source": "monte_carlo_localization_tpu_torch/csrc/resample.cu",
            "replaces": "none: XLA's work in monte_carlo_localization_tpu/ops/resample.py:16-91",
            # the main path's: one a correction (a fleet's F rows in one)
            "launches": (config1["resample_launches"] + head["resample_launches"]
                         + config5["resample_launches"]),
            "max_abs_err": 0,
            **{k: resample["calls"][0][k] for k in ("ms", "time_source", "wrapper_ms", "plain_ms",
                                                     "bound_ms", "bound_by")},
            "library_ms": None,
            "config1_launches": config1["resample_launches"],
            "headline_launches": head["resample_launches"],
            "config5_launches": config5["resample_launches"],
            "comparison_launches": resample["launches"],
            "max_row": resample["max_row"],
            "other_calls": resample["calls"][1:],
        },
        {
            "name": "motion",
            "route": "cuda",
            "source": "monte_carlo_localization_tpu_torch/csrc/motion.cu",
            "replaces": "none: XLA's work in monte_carlo_localization_tpu/models/motion.py",
            # the main path's: one a correction (a fleet's F rows in one), no plain call
            "launches": (config1["motion_launches"] + head["motion_launches"]
                         + config5["motion_launches"]),
            "max_abs_err": 0,
            **{k: motion["calls"][0][k] for k in ("ms", "time_source", "wrapper_ms", "plain_ms",
                                                   "bound_ms", "bound_by")},
            "library_ms": None,
            "config1_launches": config1["motion_launches"],
            "headline_launches": head["motion_launches"],
            "config5_launches": config5["motion_launches"],
            "comparison_launches": motion["launches"],
            "other_calls": motion["calls"][1:],
        },
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
