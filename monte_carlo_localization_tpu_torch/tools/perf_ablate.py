"""Marginal cost of each phase inside the chained MCL step: the port of
the JAX package's ``tools/perf_ablate.py``.

``ParticleFilter.profile_phases`` times each phase as a separate call.
This tool measures what each phase costs INSIDE the chained step
instead: it runs ``step_many``-style chains of variants with one phase
replaced by a shape-preserving surrogate and reports the marginal time
per update. The differences bound what fusing or removing that phase
could save. The variants are the JAX tool's six:

  full         resample, motion, the LUT likelihood kernel, pose
  no_pose      the pose and the log-quality replaced by particle 0
  no_resample  the particles carried over unresampled
  no_motion    no motion model
  kernel_only  the likelihood alone
  no_kernel    a surrogate log weight with a data dependency on the cloud

over the port's own step functions (``resample_indices``,
``motion_model``, the fused ``LUTQuery``, ``expected_pose``). On a card
each variant's chain is one replay of a CUDA graph (``utils/graphs.py``,
as the JAX tool ``jax.jit``-s a ``lax.scan``), so a marginal is device
time and not the host's launch work; on the CPU the chain runs eagerly.

The JAX tool's ``--unroll U`` swept the ``lax.scan`` unroll factor of the
full step. A graph is fully unrolled, so the port's counterpart sweeps
the corrections per replay instead: u = 1, 2, 4, ... up to U, each chain
run as chain / u replays of a u-correction graph, one line per u.

Usage:
    python -m monte_carlo_localization_tpu_torch.tools.perf_ablate [--particles 4000]
        [--beams 1080] [--chain 50] [--reps 5] [--map Spielberg_map.yaml] [--device cpu]
        [--unroll U]
"""

from __future__ import annotations

import argparse
import math
import sys
import time

import numpy as np
import torch

from monte_carlo_localization_tpu_torch import bench
from monte_carlo_localization_tpu_torch.config import MCLConfig
from monte_carlo_localization_tpu_torch.filter import (
    MCLState,
    build_lut_likelihood,
    expected_pose,
    initialize_pose,
)
from monte_carlo_localization_tpu_torch.models.motion import motion_model
from monte_carlo_localization_tpu_torch.models.sensor import SensorModel
from monte_carlo_localization_tpu_torch.ops.resample import resample_indices
from monte_carlo_localization_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device, upload
from monte_carlo_localization_tpu_torch.utils.graphs import Programs

# (resample, motion, likelihood, pose) of each variant
VARIANTS = {
    "full": (True, True, True, True),
    "no_pose": (True, True, True, False),
    "no_resample": (False, True, True, True),
    "no_motion": (True, False, True, True),
    "kernel_only": (False, False, True, False),
    "no_kernel": (True, True, False, True),
}
DISPERSION = (0.05, 0.025, 0.25)
ROUNDS = 3


def unroll_variants(unroll: int) -> dict:
    """The ``--unroll`` sweep: the full step at u = 1, 2, 4, ... <= U
    corrections per replay (the JAX tool's ``full_unroll{u}``)."""
    return {f"full_unroll{1 << i}": (True, True, True, True, 1 << i)
            for i in range(unroll.bit_length())}


def make_steps(gm, query, sensor, do_resample, do_motion, do_likelihood, do_pose,
               per_replay: int = 0):
    """K chained corrections of one variant: (state, actions (K, 3),
    scans (K, R)) -> (state, poses (K, 3)), run as replays of a program
    of ``per_replay`` corrections (0: the whole chain in one); the
    function's ``programs`` hold its graphs."""
    programs = Programs(gm.device)

    def step(state: MCLState, action, obs):
        gen = state.generator
        idx, proposal = None, state.particles
        if do_resample:
            idx = resample_indices(state.log_weights, method="systematic", generator=gen)
        if do_motion:
            # the rows' gather is motion's, as in the filter's correction
            proposal = motion_model(
                proposal, action, dispersion_x=DISPERSION[0], dispersion_y=DISPERSION[1],
                dispersion_theta=DISPERSION[2], exact_dt_heuristic=True, generator=gen,
                indices=idx,
            )
        elif idx is not None:
            proposal = proposal[idx]
        if do_likelihood:
            obs_px = sensor.to_pixel_index(obs).to(torch.float32)
            log_w = query(gm.range_lut, proposal, obs_px, row_map=gm.lut_row_map)
        else:
            # shape-preserving surrogate keeping a data dependency
            log_w = state.log_weights * 0.999 + proposal[:, 0] * 1e-6
        if do_pose:
            log_q = torch.logsumexp(log_w, dim=-1) - math.log(log_w.shape[0])
            log_w = log_w - torch.amax(log_w)
            pose = expected_pose(proposal, log_w)
        else:
            log_q = log_w[0]
            pose = proposal[0]
        return MCLState(particles=proposal, log_weights=log_w, generator=gen,
                        log_quality=log_q.to(torch.float32)), pose

    def chunk(b, gen):
        state, poses = MCLState(particles=b["particles"], log_weights=b["log_weights"],
                                generator=gen), []
        for i in range(b["actions"].shape[0]):
            state, pose = step(state, b["actions"][i], b["scans"][i])
            poses.append(pose)
        return dict(particles=state.particles, log_weights=state.log_weights,
                    log_quality=state.log_quality, poses=torch.stack(poses))

    def steps(state, actions, scans):
        u, poses = per_replay or actions.shape[0], []
        for j in range(0, actions.shape[0], u):
            out = programs(("perf_ablate",), chunk,
                           dict(particles=state.particles, log_weights=state.log_weights,
                                actions=actions[j:j + u], scans=scans[j:j + u]),
                           state.generator, keep=(gm, sensor, query))
            state = MCLState(particles=out["particles"], log_weights=out["log_weights"],
                             generator=state.generator, log_quality=out["log_quality"])
            poses.append(out["poses"])
        return state, torch.cat(poses)

    steps.programs = programs
    return steps


def run(particles=4000, beams=1080, chain=50, reps=5, map_name="Spielberg_map.yaml",
        device=DEFAULT_DEVICE, unroll: int = 0) -> dict:
    """Every variant's updates/s over ROUNDS rounds of ``reps`` chains.
    Returns ``rates`` (variant -> per-round rates), ``median`` (variant ->
    updates/s), ``marginal_ms`` (phase -> ms per update inside the full
    step; None for the ``unroll`` sweep), the query (its launch counts),
    the corrections that ran it and ``capture`` (variant -> graph
    warm-up and capture ms and pool bytes; empty on the CPU).
    ``unroll`` U > 0 runs :func:`unroll_variants` instead of the six."""
    device = resolve_device(device)
    n, r = particles, beams
    gm = bench._load_real_map(map_name, device)
    cfg = MCLConfig(max_particles=n, raycast_method="lut_pallas")
    beam_angles = bench._beams(r)
    gm, query = build_lut_likelihood(gm, beam_angles, cfg)
    sensor = SensorModel.create(max_range_px=gm.max_range_px, resolution=gm.resolution,
                                squash_factor=cfg.squash_factor, device=device)
    pose0 = bench._start_pose(gm)
    scan = bench._synth_scan(gm, beam_angles, pose0)
    actions = upload(np.tile(np.array([0.05, 0.0, 0.01], np.float32), (chain, 1)), device)
    scans = upload(np.tile(scan, (chain, 1)), device)

    variants = unroll_variants(unroll) if unroll > 0 else VARIANTS
    rates, kernel_corrections, capture = {}, 0, {}
    for name, flags in variants.items():
        steps = make_steps(gm, query, sensor, *flags)
        gen = torch.Generator(device=device)
        gen.manual_seed(0)
        particles0, logw = initialize_pose(gen, pose0, n, device=device)
        state = MCLState(particles=particles0, log_weights=logw, generator=gen)
        state, poses = steps(state, actions, scans)  # first launches + warm
        bench._block(poses)
        rates[name] = []
        for _ in range(ROUNDS):
            t0 = time.perf_counter()
            for _ in range(reps):
                state, poses = steps(state, actions, scans)
            bench._block(poses)
            rates[name].append(reps * chain / (time.perf_counter() - t0))
        if not torch.isfinite(poses).all():
            raise RuntimeError(f"{name}: non-finite poses")
        if flags[2]:
            kernel_corrections += chain * (1 + ROUNDS * reps)
        capture[name] = steps.programs.stats()
    median = {name: float(np.median(v)) for name, v in rates.items()}
    full_ms = 1e3 / median[next(iter(variants))]
    marginal = None if unroll > 0 else {
        name[3:]: full_ms - 1e3 / median[name]
        for name in ("no_pose", "no_resample", "no_motion", "no_kernel")}
    return dict(rates=rates, median=median, marginal_ms=marginal, full_ms=full_ms,
                query=query, kernel_corrections=kernel_corrections, map=gm.name,
                particles=n, beams=r, capture=capture)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="monte_carlo_localization_tpu_torch.tools.perf_ablate")
    ap.add_argument("--particles", type=int, default=4000)
    ap.add_argument("--beams", type=int, default=1080)
    ap.add_argument("--chain", type=int, default=50)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--map", default="Spielberg_map.yaml")
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    ap.add_argument("--unroll", type=int, default=0, metavar="U",
                    help="sweep the full step at 1, 2, 4, ... <= U corrections per graph "
                         "replay (the JAX tool's lax.scan unroll sweep)")
    args = ap.parse_args(argv)
    out = run(args.particles, args.beams, args.chain, args.reps, args.map, args.device,
              unroll=args.unroll)
    for name, med in out["median"].items():
        rs = out["rates"][name]
        print(f"{name:12s} {med:9.2f} updates/s   {1e3 / med:7.4f} ms/update   "
              f"(min {min(rs):.1f}, max {max(rs):.1f})")
    if out["marginal_ms"] is None:
        return 0
    print("\nmarginal costs inside the chained step:")
    for phase, d in out["marginal_ms"].items():
        print(f"  {phase:10s} {d:7.4f} ms/update ({100 * d / out['full_ms']:5.1f}% of the step)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
