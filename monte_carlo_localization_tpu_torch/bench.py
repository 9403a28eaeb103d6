"""Benchmark harness of the PyTorch/CUDA port: the workloads of the JAX
package's root ``bench.py`` on the port, one JSON line per workload.

Headline metric (BASELINE.json): full MCL updates/sec at 4000 particles x
1080 beams on one card. Two numbers are measured:

* ``value`` — throughput of the production path: K sequential corrections
  chained on the card with no host wait between them
  (``ParticleFilter.step_many``). Each step is a FULL correction
  (resample -> motion -> LUT likelihood kernel -> normalize -> pose) with
  a true sequential dependency.
* ``dispatch_updates_per_sec`` — one ``step`` call per correction (what a
  live robot loop pays per correction, including the host's launches).

Every line has the JAX harness's keys and metric strings, so a port line
and a ``BENCH_r0x.json`` line read side by side, plus ``device`` (the
card's name) and ``power_limit_w`` (``nvidia-smi``), or ``"cpu"`` for
both on the CPU, where ``method`` also carries ``+cpu`` and ``note`` says
the line is not the accelerator's. Each timed round blocks the host
exactly once (``torch.cuda.synchronize``, or a readback where the JAX
harness reads back).

The harness runs in-process and has no watchdog and no fallback: a
workload that fails raises, and the command exits non-zero with its
traceback. Without a card it runs only when asked to with ``--device
cpu``.

Usage:
  python -m monte_carlo_localization_tpu_torch.bench               # headline
  python -m monte_carlo_localization_tpu_torch.bench --quick       # fewer timed rounds
  python -m monte_carlo_localization_tpu_torch.bench --config N    # BASELINE.json configs 1-5
  python -m monte_carlo_localization_tpu_torch.bench --all         # every config
  python -m monte_carlo_localization_tpu_torch.bench --method lut  # another likelihood
  python -m monte_carlo_localization_tpu_torch.bench --device cpu --config 1 --quick

One thing differs from the JAX harness's workloads, on one map: where
the JAX harness's start pose (the corner of the free cell nearest the
free space's centroid) scans 0 m on every beam, a tracking workload
starts at that cell's centre instead (:func:`_start_pose`). Of the
harness's maps only basement_fixed does (config #4, the 1M workload and
the giant fleet's first member): float32 world -> grid truncation puts
the corner in the occupied neighbour, in both packages, and a filter on
that scan wanders ~1 m in 15 corrections.

:data:`LAUNCHES` sums, as each ``step`` or ``step_many`` of a harness's
filter returns (:func:`_counted`), the corrections it ran
(``corrections`` for one filter, ``fleet_corrections`` for a fleet) and
the kernel launches its wrappers counted meanwhile (``lut_loglik``,
``lut_loglik_fleet``, ``lut_dedup``, ``mega_step``), so a caller that
clears it before a workload can hold the two against each other.
"""

from __future__ import annotations

import argparse
import collections
import functools
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from monte_carlo_localization_tpu_torch.config import MCLConfig
from monte_carlo_localization_tpu_torch.filter import ParticleFilter
from monte_carlo_localization_tpu_torch.mapping import (
    load_map,
    map_from_occupancy,
    random_obstacle_world,
)
from monte_carlo_localization_tpu_torch.ops.raycast import cast_rays_sphere
from monte_carlo_localization_tpu_torch.parallel import FleetFilter, stack_maps
from monte_carlo_localization_tpu_torch.runtime import CallbackSink, FleetNode, MCLNode
from monte_carlo_localization_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device

NORTH_STAR_UPDATES_PER_SEC = 1000.0
REPO_ROOT = Path(__file__).resolve().parents[1]
MAPS_DIR = REPO_ROOT / "maps"

# The reference's map assets (maps/README.md). levine.pgm is absent
# upstream, so config #1 uses the recorded real-sensor SLAM map.
CONFIG_MAPS = {
    1: "map_1753950572.yaml",
    2: "sibal1.yaml",
    3: "Spielberg_map.yaml",
    4: "basement_fixed.map.yaml",
    # config #5: 64 cars over four maps, 16 each, through map_assignment.
    # Stacked maps share one resolution and max_range_px; sibal1 and
    # redbull_1 store the f32-fuzzed 0.05000000074505806 m, whose
    # max_range_px truncates to 239, not 240, so the exact-0.05 group is used.
    5: ["map_1753950572.yaml", "icra_2_clean.yaml", "first_map.yaml",
        "new_map1.yaml"],
}

# kernel launches and corrections of the workloads run in this process
LAUNCHES: collections.Counter = collections.Counter()


def _load_real_map(yaml_name: str, device=DEFAULT_DEVICE):
    return load_map(MAPS_DIR / yaml_name, device=device)


def _synthetic_map(map_hw: int, seed: int = 0, device=DEFAULT_DEVICE):
    return random_obstacle_world(
        height=map_hw, width=map_hw, num_obstacles=max(10, map_hw // 12),
        seed=seed, device=device,
    )


def _beams(num_beams: int) -> np.ndarray:
    inc = 1.5 * np.pi / max(num_beams - 1, 1)
    return (-0.75 * np.pi + np.arange(num_beams) * inc).astype(np.float32)


def _free_cells(gm) -> np.ndarray:
    return gm.free_cells[: int(gm.num_free)].cpu().numpy()


def _center_pose(gm) -> np.ndarray:
    """A pose at the centroid of free space (guaranteed inside the map)."""
    row, col = _free_cells(gm).mean(axis=0)
    x = col * gm.resolution + float(gm.origin_x)
    y = row * gm.resolution + float(gm.origin_y)
    return np.array([x, y, 0.3], np.float32)


def _nearest_free_cell(gm, pose) -> np.ndarray:
    """(row, col) of the free cell nearest to ``pose``."""
    free = _free_cells(gm)
    col = (pose[0] - float(gm.origin_x)) / gm.resolution
    row = (pose[1] - float(gm.origin_y)) / gm.resolution
    return free[np.argmin((free[:, 0] - row) ** 2 + (free[:, 1] - col) ** 2)]


def _nearest_free_pose(gm, pose) -> np.ndarray:
    """Snap a pose to the nearest free cell (the centroid may fall in a
    wall), at the cell's corner as the JAX harness does."""
    row, col = _nearest_free_cell(gm, pose)
    x = col * gm.resolution + float(gm.origin_x)
    y = row * gm.resolution + float(gm.origin_y)
    return np.array([x, y, pose[2]], np.float32)


def _cell_centre_pose(gm, row, col, theta) -> np.ndarray:
    """A pose at the CENTRE of cell (row, col). Corner coordinates lie on
    resolution multiples, where float32 world -> grid truncation can land
    in the occupied neighbour and turn the pose's scan to ~0 m."""
    return np.array(
        [(col + 0.5) * gm.resolution + float(gm.origin_x),
         (row + 0.5) * gm.resolution + float(gm.origin_y),
         theta],
        np.float32,
    )


def _start_pose(gm) -> np.ndarray:
    """Where a tracking workload starts and casts its scan: the JAX
    harness's pose, the corner of the free cell nearest the free space's
    centroid (:func:`_nearest_free_pose`), unless every beam of that
    corner's scan reads 0 m (on basement_fixed the corner truncates into
    the occupied neighbour); then the centre of that cell."""
    centroid = _center_pose(gm)
    corner = _nearest_free_pose(gm, centroid)
    if _synth_scan(gm, _beams(60), corner).any():
        return corner
    row, col = _nearest_free_cell(gm, centroid)
    return _cell_centre_pose(gm, row, col, centroid[2])


def _random_free_pose(gm, free: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """A free cell drawn by ``rng`` and a uniform heading, at the cell's
    centre."""
    row, col = free[rng.integers(len(free))]
    return _cell_centre_pose(gm, row, col, rng.uniform(-np.pi, np.pi))


def _convergence_truths(gm, trials: int) -> list[np.ndarray]:
    """The truth pose of each :func:`bench_convergence` trial: one
    ``default_rng(0)`` stream over the map's free cells."""
    rng = np.random.default_rng(0)
    free = _free_cells(gm)
    return [_random_free_pose(gm, free, rng) for _ in range(trials)]


def _kidnap_pose_pairs(gm, trials: int, tol_m: float) -> list[tuple[np.ndarray, np.ndarray]]:
    """The (A, B) pose pair of each :func:`bench_kidnap` trial, a pure
    function of the trial index (one ``default_rng(7)`` stream), so trial
    indices align across arms. B is redrawn (at most 64 times) until it
    lies at least 4 ``tol_m`` from A, so "still at A" cannot count as
    recovered."""
    rng = np.random.default_rng(7)
    free = _free_cells(gm)
    pairs = []
    for _ in range(trials):
        pose_a = _random_free_pose(gm, free, rng)
        pose_b = _random_free_pose(gm, free, rng)
        guard = 0
        while np.hypot(*(pose_b[:2] - pose_a[:2])) < 4 * tol_m and guard < 64:
            pose_b = _random_free_pose(gm, free, rng)
            guard += 1
        pairs.append((pose_a, pose_b))
    return pairs


def _synth_scan(gm, beams: np.ndarray, pose) -> np.ndarray:
    """The scan (meters) at ``pose`` by ``cast_rays_sphere`` with 64
    iterations: every workload's synthetic observation."""
    q = np.stack(
        [np.full(len(beams), pose[0]), np.full(len(beams), pose[1]), pose[2] + beams], 1,
    ).astype(np.float32)
    q = torch.as_tensor(q, device=gm.device)
    return cast_rays_sphere(gm, q, num_iters=64).cpu().numpy()


def _block(t: torch.Tensor) -> None:
    """Wait for the card's work behind ``t`` (JAX's ``block_until_ready``)."""
    if t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


def _launches(filt) -> collections.Counter:
    """The kernel launches the wrappers of ``filt`` have counted."""
    got = collections.Counter()
    q = filt.likelihood
    if q is not None:
        got.update(lut_loglik=q.launch_count, lut_loglik_fleet=q.fleet_launch_count,
                   lut_dedup=q.dedup_launch_count)
    mega = getattr(filt, "mega", None)
    if mega is not None:
        got["mega_step"] = mega.mega.launch_count
    return got


def _counted(filt):
    """``filt`` (a ``ParticleFilter`` or a ``FleetFilter``), its ``step``
    and ``step_many`` adding to :data:`LAUNCHES` the corrections they run
    and the kernel launches its wrappers counted meanwhile. Launches made
    outside those calls (a caller's own comparison) are not added."""
    key = "fleet_corrections" if isinstance(filt, FleetFilter) else "corrections"

    def counting(fn, corrections):
        @functools.wraps(fn)
        def run(state, actions, *args, **kwargs):
            before = _launches(filt)
            out = fn(state, actions, *args, **kwargs)
            LAUNCHES.update(_launches(filt) - before)
            LAUNCHES[key] += corrections(actions)
            return out
        return run

    filt.step = counting(filt.step, lambda actions: 1)
    filt.step_many = counting(filt.step_many, len)
    return filt


def _build_single(num_particles, num_beams, gm, method="lut_pallas"):
    cfg = MCLConfig(max_particles=num_particles, raycast_method=method)
    pf = _counted(ParticleFilter(gm, cfg))
    beams = _beams(num_beams)
    pf.set_beam_angles(beams)
    pose = _start_pose(gm)
    scan = _synth_scan(gm, beams, pose)
    state = pf.init_pose(pose, seed=1)
    return pf, state, scan


def _spread(rates) -> dict:
    """median/min/max over measurement rounds: a single run cannot
    separate an engine change from the machine's run-to-run swing."""
    rates = sorted(float(r) for r in rates)
    return dict(
        median=float(np.median(rates)),
        min=rates[0],
        max=rates[-1],
        rounds=len(rates),
    )


def _drift_threshold(n_corrections: int, sigma_xy: float = 0.05) -> float:
    """Divergence gate for zero-action benches, scaled with the motion-noise
    budget: S corrections of iid N(0, sigma) per-axis noise random-walk a
    member ~sqrt(S)*sigma even when the scan anchors the posterior (the
    anchor bounds it BELOW this). 3 sigma of the unanchored walk, floored
    at 1 m (the posterior's own spread at small S)."""
    return max(1.0, 3.0 * float(np.sqrt(max(n_corrections, 1))) * sigma_xy)


def bench_updates(num_particles, num_beams, gm, method="lut_pallas",
                  chain=50, reps=5, quick=False, rounds=3, setup=None):
    """Measure chained-throughput and dispatch-latency updates/sec.

    Each metric is measured ``rounds`` times (each round blocks the host
    exactly once); returns (chained_stats, dispatch_stats) dicts of
    median/min/max/rounds. ``setup``: the (filter, state, scan) of
    :func:`_build_single` for these arguments, built here when None.
    """
    if quick:
        # keep the chain length (so launch overhead stays amortized as in
        # the full run) and cut only the number of timed repetitions
        reps, rounds = 2, 2
    pf, state, scan = setup or _build_single(num_particles, num_beams, gm, method)
    action = np.array([0.05, 0.0, 0.01], np.float32)
    actions = np.tile(action, (chain, 1))
    scans = np.tile(scan, (chain, 1))

    # --- chained throughput (production replay path) ---
    state, poses = pf.step_many(state, actions, scans)  # first launches + warm
    _block(poses)
    chained_rates = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        for _ in range(reps):
            state, poses = pf.step_many(state, actions, scans)
        _block(poses)
        chained_rates.append(reps * chain / (time.perf_counter() - t0))
    last_pose = poses[-1].cpu().numpy()
    if not np.isfinite(last_pose).all():
        raise RuntimeError(f"non-finite pose: {last_pose}")

    # --- per-dispatch latency path ---
    n_disp = 5 if quick else 30
    state, pose = pf.step(state, action, scan)
    _block(pose)
    dispatch_rates = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        for _ in range(n_disp):
            state, pose = pf.step(state, action, scan)
        _block(pose)
        dispatch_rates.append(n_disp / (time.perf_counter() - t0))
    return _spread(chained_rates), _spread(dispatch_rates)


def bench_convergence(num_particles, num_beams, gm, method="lut_pallas",
                      trials=5, max_updates=80, chunk=5, tol_m=0.5,
                      quick=False):
    """Config #4's semantics (BASELINE.json: "100k uniformly-seeded
    particles on basement_fixed UNTIL CONVERGENCE"): each trial seeds the
    full particle count uniformly over free space, repeats corrections
    against a scan synthesized at a random free pose, and records how
    many updates / how much wall time until the weighted pose lands
    within ``tol_m`` of the truth.

    Returns (success_rate, median_updates, median_seconds, per_trial).
    Convergence to a wrong mode in a self-similar corridor counts as a
    failure: the success rate is part of the result, not noise.
    """
    if quick:
        trials, max_updates = 2, 40
    pf = _counted(ParticleFilter(
        gm, MCLConfig(max_particles=num_particles, raycast_method=method)
    ))
    beams = _beams(num_beams)
    pf.set_beam_angles(beams)
    actions = np.zeros((chunk, 3), np.float32)

    # pay the first launches outside every trial's timer
    warm = pf.init_global(seed=99)
    warm, p = pf.step_many(warm, actions, np.tile(_synth_scan(
        gm, beams, _nearest_free_pose(gm, _center_pose(gm))), (chunk, 1)))
    _block(p)

    per_trial = []
    for trial, pose in enumerate(_convergence_truths(gm, trials)):
        scans = np.tile(_synth_scan(gm, beams, pose), (chunk, 1))
        state = pf.init_global(seed=100 + trial)
        t0 = time.perf_counter()
        hit = None
        for u in range(chunk, max_updates + 1, chunk):
            state, poses = pf.step_many(state, actions, scans)
            est = poses[-1].cpu().numpy()  # blocking readback per chunk
            err = float(np.hypot(est[0] - pose[0], est[1] - pose[1]))
            if err < tol_m:
                hit = dict(updates=u, seconds=time.perf_counter() - t0,
                           err_m=round(err, 3))
                break
        per_trial.append(hit)

    ok = [t for t in per_trial if t]
    rate = len(ok) / trials
    med_u = float(np.median([t["updates"] for t in ok])) if ok else None
    med_s = round(float(np.median([t["seconds"] for t in ok])), 3) if ok else None
    return rate, med_u, med_s, per_trial


def bench_kidnap(num_particles, num_beams, gm, method="lut_pallas",
                 trials=20, auto_reinit=True, reinit_mode="reinit",
                 converge_updates=60, recover_updates=220, tol_m=0.5,
                 quick=False, eligible_target=None):
    """Closed-loop kidnapped-robot recovery with the Augmented-MCL monitor
    in the loop.

    Each trial drives one :class:`MCLNode` per correction (synchronous,
    so the w_fast/w_slow quality monitor sees every step):

    1. converge from a uniform seed to a random true pose A;
    2. KIDNAP: teleport the truth to a different random pose B (the scan
       stream switches to B's geometry with no odometry displacement);
    3. measure updates until the pose estimate lands within ``tol_m`` of
       B. With ``auto_reinit`` the monitor detects the sustained quality
       collapse and recovers per ``reinit_mode``: ``"reinit"`` triggers a
       full global re-initialization; ``"inject"`` (Augmented MCL,
       Probabilistic Robotics §8.3) replaces a max(0, 1 − w_fast/w_slow)
       fraction of particles with uniform free-space draws every
       correction. Without the monitor the filter stays locked at A, the
       reference's behavior (recovery there is human-triggered via
       /clicked_point, reference src/particle_filter.cpp:376-379).

    With ``eligible_target`` set, trials keep running (up to
    2 × eligible_target) until that many trials pass phase-1 convergence.
    The trial-i pose pair is a pure function of i
    (:func:`_kidnap_pose_pairs`), so trial indices align across arms.

    Returns (recovery_rate, med_recover_updates, per_trial) where each
    trial dict records phase-1 convergence, recovery updates, and how
    many auto re-inits fired (or injecting corrections for the inject
    arm).
    """
    if quick:
        trials, recover_updates = 2, 120
        eligible_target = None
    beams = _beams(num_beams)
    cfg = MCLConfig(
        max_particles=num_particles, raycast_method=method,
        auto_reinit=auto_reinit, reinit_mode=reinit_mode,
        # the scans are synthesized at num_beams already; the default
        # angle_step=18 would stride them down to ~num_beams/18 beams
        angle_step=1,
    )
    # one node for the whole arm, its per-trial state reset explicitly:
    # fresh RNG, fresh global cloud, disarmed monitor
    node = MCLNode(gm, cfg, rng_seed=100)
    node.delay_compensation_enabled = False
    _counted(node.filter)

    def reset_trial(trial: int) -> None:
        node.rng = np.random.default_rng(100 + trial)
        node._flush_inflight()
        node.state = node.filter.init_global(seed=100 + trial)
        node.tracker.deactivate()
        node.inferred_pose = None
        node.iters = 0
        node._q_slow = node._q_fast = None
        node._bad_count = 0
        node._reinit_holdoff = 0
        node._inject_fraction = 0.0
        node._last_update_time = None

    per_trial = []
    eligible_n = 0
    max_trials = trials if eligible_target is None else 2 * eligible_target
    pairs = _kidnap_pose_pairs(gm, max_trials, tol_m)
    for trial in range(max_trials):
        if eligible_target is not None and eligible_n >= eligible_target:
            break
        reset_trial(trial)
        pose_a, pose_b = pairs[trial]
        scan_a, scan_b = _synth_scan(gm, beams, pose_a), _synth_scan(gm, beams, pose_b)
        node.on_scan(scan_a, beam_angles=beams)
        # zero odometry: suppresses exploration noise; motion noise only
        node.on_odometry(0.0, 0.0, 0.0, 0.0, 0.0, stamp=0.0)
        t = 0.0
        node.update(now=t)  # arms the dt clock

        converged_at = None
        for u in range(1, converge_updates + 1):
            t += 0.05
            est = node.update(now=t)
            if est is not None and np.hypot(
                est[0] - pose_a[0], est[1] - pose_a[1]
            ) < tol_m:
                converged_at = u
                if u >= 30:  # past reinit_min_iters: the monitor is armed
                    break
        reinits_before = node.auto_reinits
        injects_before = node.inject_steps
        recovered_at = None
        if converged_at is not None:
            eligible_n += 1
            node.on_scan(scan_b, beam_angles=beams)  # the kidnap event
            for u in range(1, recover_updates + 1):
                t += 0.05
                est = node.update(now=t)
                if est is not None and np.hypot(
                    est[0] - pose_b[0], est[1] - pose_b[1]
                ) < tol_m:
                    recovered_at = u
                    break
        per_trial.append(dict(
            trial=trial,
            converged=converged_at, recovered=recovered_at,
            auto_reinits=node.auto_reinits - reinits_before,
            inject_steps=node.inject_steps - injects_before,
        ))
        print(
            f"#   kidnap trial {trial}: converged={converged_at} "
            f"recovered={recovered_at} (eligible {eligible_n})",
            file=sys.stderr, flush=True,
        )

    eligible = [tr for tr in per_trial if tr["converged"] is not None]
    ok = [tr for tr in eligible if tr["recovered"] is not None]
    rate = len(ok) / len(eligible) if eligible else 0.0
    med = float(np.median([tr["recovered"] for tr in ok])) if ok else None
    return rate, med, per_trial


def bench_live(num_particles, num_beams, gm, method="lut_pallas",
               live_chunk=1, async_depth=4, duration_s=6.0, quick=False):
    """Corrections/s a LIVE robot loop gets: real wall-clock ticks
    through ``MCLNode.update`` with the async pipeline, including every
    launch the host issues. ``live_chunk=1`` is the plain depth-N
    pipeline (one ``step`` per dispatch); K > 1 buffers K ticks and
    dispatches one ``step_many(K)``, at <= K-1 ticks of pose latency.
    Returns (spread of three windows' rates, median pose staleness ms)."""
    if quick:
        duration_s = min(duration_s, 3.0)
    cfg = MCLConfig(
        max_particles=num_particles, raycast_method=method,
        async_correction=True, async_depth=async_depth,
        live_chunk=live_chunk,
        # the synthesized scan is at num_beams already (see bench_kidnap)
        angle_step=1,
    )
    node = MCLNode(gm, cfg, rng_seed=0)
    _counted(node.filter)
    beams = _beams(num_beams)
    pose = _start_pose(gm)
    scan = _synth_scan(gm, beams, pose)
    node.initialize_pose(pose)
    node.on_scan(scan, beam_angles=beams)
    node.on_odometry(pose[0], pose[1], pose[2], 0.0, 0.0, stamp=0.0)

    # spy on the anchor refresh: its avg_mcl_ms keyword is each pose's
    # measured staleness, the latency price of pipelining and chunking
    staleness_ms = []
    real_anchor = node.tracker.anchor

    def anchor_spy(p, **kw):
        if "avg_mcl_ms" in kw:
            staleness_ms.append(kw["avg_mcl_ms"])
        return real_anchor(p, **kw)

    node.tracker.anchor = anchor_spy

    # count every correction that surfaces: superseded poses go to the
    # sinks (publish_correction), the freshest returns from update(). Not
    # node.stats: the node resets its stats every 200 ticks (the
    # reference's printout cadence, reference src/utils.cpp:105-125).
    sunk = [0]
    node.add_sink(CallbackSink(
        lambda top, t, p: sunk.__setitem__(0, sunk[0] + 1), topics=("pose",)
    ))

    # warm: tick until the first harvest lands (pays the first launches;
    # the dt > 1 s gap-skip swallows the tick right after a long one)
    t_warm0 = time.perf_counter()
    warmed = 0
    while warmed < 1:
        if node.update() is not None:
            warmed += 1
        if time.perf_counter() - t_warm0 > 900.0:
            raise RuntimeError("live bench warmup never harvested")
    # three back-to-back measurement windows -> median of 3 with min/max
    rates = []
    last_pose = None
    for _ in range(3):
        staleness_ms.clear()
        sunk[0] = 0
        harvested = 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < duration_s:
            p = node.update()
            if p is not None:
                last_pose = p
                harvested += 1  # the one pose per tick NOT sink-published
        rates.append(
            (sunk[0] + harvested) / (time.perf_counter() - t0)
        )
    if last_pose is not None and not np.isfinite(last_pose).all():
        raise RuntimeError(f"non-finite live pose: {last_pose}")
    stale = float(np.median(staleness_ms)) if staleness_ms else -1.0
    return _spread(rates), stale


def _fleet_inputs(fleet_size, num_beams, maps):
    """The fleet workloads' inputs: ``map_assignment = arange(F) %
    len(maps)``, each car at its map's start pose (:func:`_start_pose`)
    with that pose's scan. Returns (assignment (F,), beams (R,), start
    poses (F, 3), scans (F, R))."""
    beams = _beams(num_beams)
    asg = np.arange(fleet_size, dtype=np.int32) % len(maps)
    map_poses = [_start_pose(m) for m in maps]
    map_scans = [_synth_scan(m, beams, p) for m, p in zip(maps, map_poses)]
    return (asg, beams, np.stack([map_poses[a] for a in asg]),
            np.stack([map_scans[a] for a in asg]))


def _fleet_setup(fleet_size, num_particles, num_beams, maps, method):
    """:func:`bench_fleet`'s filter, start state and inputs: members share
    each map's LUT block through ``map_assignment`` (:func:`_fleet_inputs`).
    Returns (filter, state, start poses (F, 3), scans (F, R))."""
    asg, beams, poses0, scans = _fleet_inputs(fleet_size, num_beams, maps)
    bm = stack_maps(maps) if len(maps) > 1 else maps[0]
    ff = _counted(FleetFilter(
        bm,
        fleet_size=fleet_size,
        config=MCLConfig(
            max_particles=num_particles,
            raycast_method=method,
            lut_theta_bins=720,
        ),
        beam_angles=beams,
        map_assignment=asg if len(maps) > 1 else None,
    ))
    return ff, ff.init_pose(poses0, seed=1), poses0, scans


def bench_fleet(fleet_size, num_particles, num_beams, maps, method="lut",
                chain=10, reps=3, iters=20, quick=False, rounds=3):
    """Fleet across MULTIPLE maps (BASELINE.json config #5): members share
    each circuit's LUT block via map_assignment. Returns
    (dispatch_stats, chained_stats, info): fleet-steps/sec spread dicts
    (each fleet step = fleet_size member updates) and the LUT's bytes.
    ``dispatch`` (one ``step`` call per fleet correction) is the headline
    ``value``; ``chained`` runs ``FleetFilter.step_many``."""
    if quick:
        chain, reps, iters, rounds = 5, 1, 5, 2
    if not isinstance(maps, (list, tuple)):
        maps = [maps]
    if method != "lut_pallas" and len(maps) > 1:
        # map sharing (map_assignment) needs the fused kernel; the other
        # methods would duplicate every member's LUT, so the fleet runs
        # on the first map, as under the JAX harness
        print("# bench: fleet fallback runs on ONE shared map", file=sys.stderr)
        maps = maps[:1]
    ff, state, poses0, scans = _fleet_setup(fleet_size, num_particles, num_beams, maps, method)
    action = np.zeros((fleet_size, 3), np.float32)
    actions_k = np.tile(action, (chain, 1, 1))
    scans_k = np.tile(scans, (chain, 1, 1))

    # --- chained throughput (replay path: K fleet corrections a call) ---
    state, poses = ff.step_many(state, actions_k, scans_k)  # first launches + warm
    _block(poses)
    chained_rates = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        for _ in range(reps):
            state, poses = ff.step_many(state, actions_k, scans_k)
        _block(poses)
        chained_rates.append(reps * chain / (time.perf_counter() - t0))
    n_corr = chain * (1 + rounds * reps)  # warm chain + measured chains
    _check_drift(poses[-1].cpu().numpy(), poses0, n_corr)

    # --- per-dispatch latency path ---
    state, poses = ff.step(state, action, scans)
    _block(poses)
    dispatch_rates = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        for _ in range(iters):
            state, poses = ff.step(state, action, scans)
        _block(poses)
        dispatch_rates.append(iters / (time.perf_counter() - t0))
    n_corr += 1 + rounds * iters  # the dispatch path continues the walk
    _check_drift(poses.cpu().numpy(), poses0, n_corr)
    info = {}
    fm = ff.map
    lut_bytes = 0
    for leaf in ("range_lut", "lut_row_map"):
        a = getattr(fm, leaf)
        if a is not None:
            lut_bytes += a.numel() * a.element_size()
    if lut_bytes:
        info["lut_bytes"] = lut_bytes
    return _spread(dispatch_rates), _spread(chained_rates), info


def _check_drift(poses: np.ndarray, poses0: np.ndarray, n_corr: int) -> None:
    """Raise if a member's (F, 3) pose is non-finite or strayed past
    :func:`_drift_threshold` of ``n_corr`` corrections from its start."""
    err = np.linalg.norm(poses[:, :2] - poses0[:, :2], axis=1)
    thr = _drift_threshold(n_corr)
    if not (np.isfinite(err).all() and err.max() < thr):
        raise RuntimeError(
            f"fleet diverged: max err {err.max()} after {n_corr} corrections "
            f"(threshold {thr:.2f})"
        )


def bench_fleet_live(fleet_size, num_particles, num_beams, maps,
                     method="lut_pallas", async_depth=4, duration_s=8.0,
                     quick=False):
    """Fleet corrections/s a LIVE fleet robot loop gets: wall-clock ticks
    through ``FleetNode.update`` (per-member trackers, async pipeline,
    one fused fleet launch per correction)."""
    if quick:
        duration_s = min(duration_s, 3.0)
    if not isinstance(maps, (list, tuple)):
        maps = [maps]
    bm = stack_maps(maps) if len(maps) > 1 else maps[0]
    asg, beams, poses0, scans = _fleet_inputs(fleet_size, num_beams, maps)
    node = FleetNode(
        bm,
        fleet_size=fleet_size,
        config=MCLConfig(
            max_particles=num_particles, raycast_method=method,
            angle_step=1, async_correction=True, async_depth=async_depth,
        ),
        map_assignment=asg if len(maps) > 1 else None,
        rng_seed=0,
    )
    _counted(node.filter)
    for m_i in range(fleet_size):
        node.on_scan(m_i, scans[m_i], beam_angles=beams)
        node.on_odometry(m_i, *poses0[m_i], 0.0, 0.0, stamp=0.0)
    node.initialize_pose(poses0)

    # warm: tick until the first harvest (pays the first launches)
    t_warm0 = time.perf_counter()
    while node.update() is None:
        if time.perf_counter() - t_warm0 > 900.0:
            raise RuntimeError("fleet live warmup never harvested")
    harvested = 0
    t0 = time.perf_counter()
    last = None
    while time.perf_counter() - t0 < duration_s:
        got = node.update()
        if got is not None:
            last = got
            harvested += 1
    rate = harvested / (time.perf_counter() - t0)
    if last is None:
        raise RuntimeError("fleet live harvested nothing in its window")
    # + async_depth: corrections dispatched during warmup before harvest
    _check_drift(last, poses0, harvested + async_depth)
    return rate


def run_fleet_live(quick=False, method="lut_pallas", device=DEFAULT_DEVICE):
    """Config #5's workload through the fleet ROBOT LOOP (FleetNode +
    async pipeline) instead of the raw step API."""
    maps = [_load_real_map(y, device) for y in CONFIG_MAPS[5]]
    fleet, particles, beams_n = 64, 4000, 60
    rate = bench_fleet_live(
        fleet, particles, beams_n, maps, method=method, quick=quick,
    )
    return dict(
        metric="fleet_live_corrections_per_sec[config#5 workload through "
               "FleetNode: 64 cars x 4000p over 4 maps, async depth 4]"
               + ("[quick]" if quick else ""),
        value=round(rate, 2),
        unit="fleet-corrections/s",
        vs_baseline=round(rate * fleet / NORTH_STAR_UPDATES_PER_SEC, 4),
        member_corrections_per_sec=round(rate * fleet, 2),
        method=method,
    )


def _giant_fleet_maps(device=DEFAULT_DEVICE):
    """Two distinct GIANT circuits at one resolution for the
    heterogeneous-compact-LUT fleet. The fleet's kernel takes ONE
    resolution and max_range_px, so Spielberg (0.05796 m/px) and
    basement_fixed (0.0504 m/px) cannot share a fleet; the 1300 x 1300
    basement map is joined by its 180-degree rotation instead: two
    occupancy fields (two compact LUT blocks and row maps) of config #4's
    scale. At the 60-beam stride an indoor giant map compacts to ~0.99 of
    dense (nearly every free cell is within 12 m of a wall), so the two
    blocks take ~10 GB."""
    base = _load_real_map(CONFIG_MAPS[4], device)
    occ = base.occupancy.cpu().numpy()
    origin = (float(base.origin_x), float(base.origin_y), 0.0)
    rot = map_from_occupancy(
        np.ascontiguousarray(occ[::-1, ::-1]), base.resolution, origin,
        max_range_meters=base.max_range_meters, name="basement_rot180",
        device=device,
    )
    return [base, rot]


def run_fleet_giant(quick=False, method="lut_pallas", device=DEFAULT_DEVICE):
    """Heterogeneous fleet over GIANT maps: 16 cars x 4000 particles over
    two 1300x1300 circuits via per-member row-compacted LUT blocks
    (``GridMap.with_member_compact_luts``: composed row_map_bases +
    lut_bases addressing in the kernel, the blocks built on the card into
    one buffer)."""
    maps = _giant_fleet_maps(device)
    fleet, particles, beams_n = 16, 4000, 60
    ups, chained, info = bench_fleet(
        fleet, particles, beams_n, maps, method=method, quick=quick,
    )
    v = ups["median"]
    return dict(
        metric="fleet_steps_per_sec[giant-hetero: 16 cars x 4000p over 2 "
               "basement-class 1300x1300 maps, per-member compact LUTs]"
               + ("[quick]" if quick else ""),
        value=round(v, 2),
        unit="fleet-steps/s",
        vs_baseline=round(v * fleet / NORTH_STAR_UPDATES_PER_SEC, 4),
        value_min=round(ups["min"], 2),
        value_max=round(ups["max"], 2),
        rounds=ups["rounds"],
        member_updates_per_sec=round(v * fleet, 2),
        chained_fleet_steps_per_sec=round(chained["median"], 2),
        rays_per_sec=round(v * fleet * particles * beams_n),
        **info,
        method=method,
    )


CONFIGS = {
    # BASELINE.json workload configs 1-5 on the real reference maps
    1: dict(kind="single", particles=4000, beams=60, method="lut_pallas",
            note="config#1: 4000p x 60 beams, recorded SLAM map "
                 "(levine.pgm missing upstream)"),
    2: dict(kind="single", particles=4000, beams=60, method="lut_pallas",
            note="config#2: sibal1 circuit, 4000p fast inner loop"),
    3: dict(kind="single", particles=4000, beams=1080, method="lut_pallas",
            note="config#3: Spielberg 2000x2000, full 1080-beam scans"),
    4: dict(kind="single", particles=100_000, beams=60, method="lut_pallas", chain=10,
            note="config#4: basement_fixed, 100k-particle global localization"),
    5: dict(kind="fleet", fleet=64, particles=4000, beams=60, method="lut_pallas",
            note="config#5: 64-car fleet x 4000 particles over 4 maps "
                 "(map_1753950572/icra_2_clean/first_map/new_map1)"),
}


def run_config(n, quick=False, method=None, device=DEFAULT_DEVICE):
    c = CONFIGS[n]
    spec = CONFIG_MAPS[n]
    gm = (
        [_load_real_map(y, device) for y in spec]
        if isinstance(spec, list)
        else _load_real_map(spec, device)
    )
    m = method or c.get("method", "lut_pallas")
    if c["kind"] == "single":
        chained, dispatch = bench_updates(
            c["particles"], c["beams"], gm, method=m,
            chain=c.get("chain", 50), quick=quick,
        )
        v = chained["median"]
        return dict(
            metric=f"mcl_updates_per_sec[{c['note']}]"
                   + ("[quick]" if quick else ""),
            value=round(v, 2),
            unit="updates/s",
            vs_baseline=round(v / NORTH_STAR_UPDATES_PER_SEC, 4),
            value_min=round(chained["min"], 2),
            value_max=round(chained["max"], 2),
            rounds=chained["rounds"],
            dispatch_updates_per_sec=round(dispatch["median"], 2),
            dispatch_min=round(dispatch["min"], 2),
            dispatch_max=round(dispatch["max"], 2),
            rays_per_sec=round(v * c["particles"] * c["beams"]),
            method=m,
        )
    ups, chained, info = bench_fleet(
        c["fleet"], c["particles"], c["beams"], gm, method=m, quick=quick,
    )
    v = ups["median"]
    return dict(
        metric=f"fleet_steps_per_sec[{c['note']}]"
               + ("[quick]" if quick else ""),
        value=round(v, 2),
        unit="fleet-steps/s",
        vs_baseline=round(v * c["fleet"] / NORTH_STAR_UPDATES_PER_SEC, 4),
        value_min=round(ups["min"], 2),
        value_max=round(ups["max"], 2),
        rounds=ups["rounds"],
        chained_fleet_steps_per_sec=round(chained["median"], 2),
        chained_min=round(chained["min"], 2),
        chained_max=round(chained["max"], 2),
        rays_per_sec=round(v * c["fleet"] * c["particles"] * c["beams"]),
        **info,
        method=m,
    )


def converge_line(tag: str, quick: bool, method: str, result) -> dict:
    """The line of a :func:`bench_convergence` ``result``. ``vs_baseline``
    carries the SUCCESS RATE: the reference publishes no convergence
    number to normalize against."""
    rate, med_u, med_s, per_trial = result
    return dict(
        metric=f"time_to_converge[{tag}]" + ("[quick]" if quick else ""),
        value=med_s if med_s is not None else -1.0,
        unit="s",
        vs_baseline=rate,
        success_rate=rate,
        median_updates=med_u,
        trials=per_trial,
        method=method,
    )


def run_converge(quick=False, method="lut_pallas", device=DEFAULT_DEVICE):
    """Kidnapped-robot convergence on basement_fixed (config #4's "until
    convergence" semantics)."""
    gm = _load_real_map(CONFIG_MAPS[4], device)
    result = bench_convergence(
        100_000, 60, gm, method=method, trials=20, quick=quick,
    )
    return converge_line("config#4: 100k uniform seed, basement_fixed", quick, method, result)


def million_lines(n, quick, method, updates, convergence) -> list[dict]:
    """The two lines of :func:`run_million` from its ``updates``
    (:func:`bench_updates`) and ``convergence`` (:func:`bench_convergence`)
    results at ``n`` particles."""
    chained, dispatch = updates
    return [
        dict(
            metric=f"updates_per_sec[{n // 1000}k particles x 60 beams, "
                   f"basement_fixed, chained]" + ("[quick]" if quick else ""),
            value=chained["median"],
            unit="updates/s",
            # against the JAX engine's linear extrapolation: 63 ns a
            # particle (its TPU issue floor measured at 100k)
            vs_baseline=round(chained["median"] * n * 63e-9, 3),
            spread=chained,
            dispatch=dispatch,
            ns_per_particle=round(1e9 / (chained["median"] * n), 1),
            method=method,
        ),
        converge_line(f"{n // 1000}k uniform seed, basement_fixed", quick, method, convergence),
    ]


def run_million(quick=False, method="lut_pallas", device=DEFAULT_DEVICE):
    """One decade past config #4: 1M particles on basement_fixed. Emits
    TWO lines: chained tracking throughput at 1M, and global-localization
    convergence at 1M."""
    gm = _load_real_map(CONFIG_MAPS[4], device)
    n = 200_000 if quick else 1_000_000
    updates = bench_updates(
        n, 60, gm, method=method, chain=10, reps=2, quick=quick,
    )
    convergence = bench_convergence(
        n, 60, gm, method=method, trials=3 if quick else 5,
        max_updates=60, chunk=5, quick=quick,
    )
    return million_lines(n, quick, method, updates, convergence)


def run_kidnap(quick=False, method="lut_pallas", monitor=True,
               arms=("inject", "reinit", "off"), device=DEFAULT_DEVICE):
    """Kidnapped-robot CLOSED LOOP on basement_fixed: converge -> teleport
    -> recover, as a THREE-ARM comparison: ``inject`` (Augmented-MCL
    partial injection), ``reinit`` (full global re-init on sustained
    collapse), ``off`` (the reference's behavior: recovery only through a
    human's /clicked_point). Each arm runs until >= 20 phase-1-eligible
    trials; trial indices share pose pairs across arms. ``vs_baseline``
    carries the recovery rate. ``monitor=False`` (``--kidnap-off``) runs
    only the off arm. A generator: each finished arm yields its line."""
    gm = _load_real_map(CONFIG_MAPS[4], device)
    if not monitor:
        arms = ("off",)
    target = 2 if quick else 20
    for arm in arms:
        print(f"# kidnap arm={arm} starting", file=sys.stderr, flush=True)
        rate, med_u, per_trial = bench_kidnap(
            100_000, 60, gm, method=method,
            trials=(2 if quick else 40),
            auto_reinit=arm != "off",
            reinit_mode=arm if arm != "off" else "reinit",
            quick=quick,
            eligible_target=None if quick else target,
        )
        tag = {
            "inject": "augmented-MCL injection",
            "reinit": "full re-init",
            "off": "monitor OFF (reference behavior)",
        }[arm]
        yield dict(
            metric=f"kidnap_recovery[basement_fixed, 100k particles, {tag}]"
                   + ("[quick]" if quick else ""),
            value=med_u if med_u is not None else -1.0,
            unit="updates-to-recover",
            vs_baseline=rate,
            recovery_rate=rate,
            arm=arm,
            eligible=sum(
                1 for tr in per_trial if tr["converged"] is not None
            ),
            trials=per_trial,
            method=method,
        )


def run_live(quick=False, method="lut_pallas", device=DEFAULT_DEVICE):
    """The live loop: corrections/s a real robot tick loop gets, plain
    async pipeline vs micro-chunked dispatch, on the config #1 map. Each
    line carries the measured pose staleness, the latency price of the
    extra throughput."""
    gm = _load_real_map(CONFIG_MAPS[1], device)
    out = []
    for k in (1, 8, 32):
        spread, stale = bench_live(
            4000, 60, gm, method=method, live_chunk=k, quick=quick,
        )
        out.append(dict(
            metric=f"live_corrections_per_sec[config#1 map, async depth 4, "
                   f"live_chunk={k}]" + ("[quick]" if quick else ""),
            value=round(spread["median"], 2),
            unit="corrections/s",
            vs_baseline=round(
                spread["median"] / NORTH_STAR_UPDATES_PER_SEC, 4
            ),
            spread=spread,
            median_pose_staleness_ms=round(stale, 1),
            method=method,
        ))
    return out


def run_headline(quick=False, method="lut_pallas", synthetic=False, device=DEFAULT_DEVICE):
    """The 4000 x 1080 north-star workload (BASELINE.md) on the config #3
    map, Spielberg (2000 x 2000, row-compacted LUT); ``synthetic`` runs it
    on the 768^2 synthetic world instead."""
    if synthetic:
        gm = _synthetic_map(768, device=device)
        map_tag = "synthetic768"
    else:
        gm = _load_real_map(CONFIG_MAPS[3], device)
        map_tag = "Spielberg"
    chained, dispatch = bench_updates(
        4000, 1080, gm, method=method, chain=50, reps=2 if quick else 10,
        quick=quick,
    )
    v = chained["median"]
    return dict(
        metric=f"mcl_updates_per_sec@4000x1080[{map_tag}]"
               + ("[quick]" if quick else ""),
        value=round(v, 2),
        unit="updates/s",
        vs_baseline=round(v / NORTH_STAR_UPDATES_PER_SEC, 4),
        value_min=round(chained["min"], 2),
        value_max=round(chained["max"], 2),
        rounds=chained["rounds"],
        dispatch_updates_per_sec=round(dispatch["median"], 2),
        dispatch_min=round(dispatch["min"], 2),
        dispatch_max=round(dispatch["max"], 2),
        rays_per_sec=round(v * 4000 * 1080),
        method=method,
    )


@functools.lru_cache(maxsize=None)
def _card(device: torch.device) -> tuple[str, float]:
    """The card's name and power limit in watts (``nvidia-smi``)."""
    index = torch.cuda.current_device() if device.index is None else device.index
    limit = subprocess.run(
        ["nvidia-smi", f"--id={index}", "--query-gpu=power.limit",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    return torch.cuda.get_device_name(index), float(limit)


def labelled(res: dict, device) -> dict:
    """``res`` as this harness prints it: with the ``device`` that ran it
    and its ``power_limit_w``; on the CPU both read ``"cpu"``, the method
    carries ``+cpu`` and a note says the line is not the accelerator's."""
    device = torch.device(device)
    if device.type != "cuda":
        return dict(res, method=str(res["method"]) + "+cpu",
                    note="CPU run, NOT the accelerator metric",
                    device="cpu", power_limit_w="cpu")
    name, limit = _card(device)
    return dict(res, device=name, power_limit_w=limit)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="monte_carlo_localization_tpu_torch.bench")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--config", type=int, default=None, choices=sorted(CONFIGS))
    ap.add_argument("--all", action="store_true")
    ap.add_argument(
        "--method", choices=["lut_pallas", "lut", "sphere", "dda"],
        default="lut_pallas",
    )
    ap.add_argument("--device", default=DEFAULT_DEVICE,
                    help="torch device to run on (default cuda; cpu labels every "
                    "line as NOT the accelerator metric)")
    ap.add_argument("--converge", action="store_true",
                    help="config #4 'until convergence' semantics: 100k "
                         "uniform seed on basement_fixed, measure "
                         "time/updates to converge + success rate")
    ap.add_argument("--kidnap", action="store_true",
                    help="closed-loop kidnapped-robot recovery through "
                         "MCLNode, THREE arms (Augmented-MCL injection / "
                         "full re-init / monitor off), >=20 eligible "
                         "trials per arm")
    ap.add_argument("--kidnap-off", action="store_true",
                    help="the same kidnap protocol with the monitor "
                         "DISABLED (reference behavior: no recovery)")
    ap.add_argument("--million", action="store_true",
                    help="the 1M-particle scale line on basement_fixed: "
                         "chained throughput + global convergence at 1M")
    ap.add_argument("--fleet-giant", action="store_true",
                    help="heterogeneous fleet over GIANT maps: 16 cars x "
                         "4000p over two 1300x1300 basement-class "
                         "circuits via per-member compact LUT blocks")
    ap.add_argument("--fleet-live", action="store_true",
                    help="config #5 workload through the fleet robot "
                         "loop (FleetNode, per-member trackers, async "
                         "pipeline): fleet corrections/s on the wall "
                         "clock")
    ap.add_argument("--synthetic", action="store_true",
                    help="headline on the 768^2 synthetic world "
                         "instead of the Spielberg reference map")
    ap.add_argument("--live", action="store_true",
                    help="live-loop corrections/s through MCLNode's async "
                         "pipeline: plain (live_chunk=1) vs micro-chunked "
                         "(8, 32) dispatch, with measured pose staleness")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)  # raises for a card that is not there
    run = dict(quick=args.quick, method=args.method, device=device)

    def emit(res):
        print(json.dumps(labelled(res, device)), flush=True)

    if args.all:
        for n in sorted(CONFIGS):
            emit(run_config(n, **run))
        return 0
    if args.converge:
        emit(run_converge(**run))
        return 0
    if args.kidnap or args.kidnap_off:
        for line in run_kidnap(monitor=not args.kidnap_off, **run):
            emit(line)
        return 0
    if args.million:
        for line in run_million(**run):
            emit(line)
        return 0
    if args.fleet_giant:
        emit(run_fleet_giant(**run))
        return 0
    if args.fleet_live:
        emit(run_fleet_live(**run))
        return 0
    if args.live:
        for line in run_live(**run):
            emit(line)
        return 0
    if args.config is not None:
        emit(run_config(args.config, **run))
        return 0
    emit(run_headline(synthetic=args.synthetic, **run))
    return 0


if __name__ == "__main__":
    sys.exit(main())
