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
``motion_model``, the fused ``LUTQuery``, ``expected_pose``).

The JAX tool's ``--unroll U`` swept the ``lax.scan`` unroll factor of the
chained step. The port's ``step_many`` is a Python loop of launches,
with no unroll to sweep until it becomes one CUDA graph (ROADMAP.md
queue 1, item 2); the option exits saying so.

Usage:
    python -m monte_carlo_localization_tpu_torch.tools.perf_ablate [--particles 4000]
        [--beams 1080] [--chain 50] [--reps 5] [--map Spielberg_map.yaml] [--device cpu]
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
UNROLL_EXIT = ("--unroll sweeps the lax.scan unroll factor of the JAX step; the port's "
               "step_many is a Python loop with nothing to unroll until it becomes one CUDA "
               "graph (ROADMAP.md queue 1, item 2)")


def make_steps(gm, query, sensor, do_resample, do_motion, do_likelihood, do_pose):
    """K chained corrections of one variant: (state, actions (K, 3),
    scans (K, R)) -> (state, poses (K, 3))."""

    def step(state: MCLState, action, obs):
        gen = state.generator
        if do_resample:
            idx = resample_indices(state.log_weights, method="systematic", generator=gen)
            proposal = state.particles[idx]
        else:
            proposal = state.particles
        if do_motion:
            proposal = motion_model(
                proposal, action, dispersion_x=DISPERSION[0], dispersion_y=DISPERSION[1],
                dispersion_theta=DISPERSION[2], exact_dt_heuristic=True, generator=gen,
            )
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

    def steps(state, actions, scans):
        poses = []
        for i in range(actions.shape[0]):
            state, pose = step(state, actions[i], scans[i])
            poses.append(pose)
        return state, torch.stack(poses)

    return steps


def run(particles=4000, beams=1080, chain=50, reps=5, map_name="Spielberg_map.yaml",
        device=DEFAULT_DEVICE) -> dict:
    """Every variant's updates/s over ROUNDS rounds of ``reps`` chains.
    Returns ``rates`` (variant -> per-round rates), ``median`` (variant ->
    updates/s), ``marginal_ms`` (phase -> ms per update inside the full
    step), the query (its launch counts) and the corrections that ran it."""
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

    rates, kernel_corrections = {}, 0
    for name, flags in VARIANTS.items():
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
    median = {name: float(np.median(v)) for name, v in rates.items()}
    full_ms = 1e3 / median["full"]
    marginal = {name[3:]: full_ms - 1e3 / median[name]
                for name in ("no_pose", "no_resample", "no_motion", "no_kernel")}
    return dict(rates=rates, median=median, marginal_ms=marginal, full_ms=full_ms,
                query=query, kernel_corrections=kernel_corrections, map=gm.name,
                particles=n, beams=r)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="monte_carlo_localization_tpu_torch.tools.perf_ablate")
    ap.add_argument("--particles", type=int, default=4000)
    ap.add_argument("--beams", type=int, default=1080)
    ap.add_argument("--chain", type=int, default=50)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--map", default="Spielberg_map.yaml")
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    ap.add_argument("--unroll", type=int, default=0, metavar="U",
                    help="the JAX tool's lax.scan unroll sweep: not ported (exits)")
    args = ap.parse_args(argv)
    if args.unroll:
        raise SystemExit(UNROLL_EXIT)
    out = run(args.particles, args.beams, args.chain, args.reps, args.map, args.device)
    for name, med in out["median"].items():
        rs = out["rates"][name]
        print(f"{name:12s} {med:9.2f} updates/s   {1e3 / med:7.4f} ms/update   "
              f"(min {min(rs):.1f}, max {max(rs):.1f})")
    print("\nmarginal costs inside the chained step:")
    for phase, d in out["marginal_ms"].items():
        print(f"  {phase:10s} {d:7.4f} ms/update ({100 * d / out['full_ms']:5.1f}% of the step)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
