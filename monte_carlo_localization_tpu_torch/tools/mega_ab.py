"""Interleaved same-process A/B of the classic chained step and the mega
step (one launch of ``csrc/mega_step.cu`` a correction): the port of the
JAX package's ``tools/mega_ab.py``.

Two A/Bs in two processes, or in two calls of the card machine, can land
on cards with other power limits and other neighbours; this tool runs the
two arms in turns inside ONE process, so drift hits both alike, and
reports the median of R rounds with min and max, and a tracking check on
each arm (its last pose within 1.5 m of the start after the rounds).

Both arms share ONE map object and ONE dense LUT buffer: the mega step
reads dense LUTs only, so ``MCL_LUT_DENSE_MAX`` is raised to 14 GiB while
the arms are built (unless the caller set it), and even Spielberg builds
dense (12.3 GB at 1080 beams); the classic arm reads the SAME dense LUT,
so the difference is the fusion alone.

Not ported: the JAX tool's ``--mega-blocks``, extra mega arms at
``pallas_block`` caps. That cap sized TPU blocks; the port's launcher
sizes its grid from the work (``MegaStep.plan``), and ``pick_block`` was
left out on purpose (ROADMAP.md queue 2).

Usage:
    python -m monte_carlo_localization_tpu_torch.tools.mega_ab [--particles 4000]
        [--beams 1080] [--chain 50] [--reps 5] [--rounds 3]
        [--map Spielberg_map.yaml | --synthetic] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from monte_carlo_localization_tpu_torch import bench
from monte_carlo_localization_tpu_torch.config import MCLConfig
from monte_carlo_localization_tpu_torch.filter import ParticleFilter
from monte_carlo_localization_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device

DENSE_MAX = 14 << 30  # bytes of dense LUT allowed while the arms are built
TRACK_M = 1.5  # each arm's pose must stay within this of the start


def _build(gm, n: int, beams: np.ndarray) -> dict:
    """The classic and mega filters on one dense LUT."""
    old = os.environ.get("MCL_LUT_DENSE_MAX")
    os.environ["MCL_LUT_DENSE_MAX"] = old or str(DENSE_MAX)
    try:
        classic = ParticleFilter(gm, MCLConfig(max_particles=n, raycast_method="lut_pallas"),
                                 beam_angles=beams)
        if classic.grid_map.lut_row_map is not None:
            raise ValueError(f"map {gm.name!r} built COMPACT at MCL_LUT_DENSE_MAX="
                             f"{os.environ['MCL_LUT_DENSE_MAX']}; the mega step needs dense")
        mega = ParticleFilter(
            classic.grid_map,  # shares the attached LUT buffer
            MCLConfig(max_particles=n, raycast_method="lut_pallas", pallas_mega=True),
            beam_angles=beams,
        )
    finally:
        if old is None:
            del os.environ["MCL_LUT_DENSE_MAX"]
        else:
            os.environ["MCL_LUT_DENSE_MAX"] = old
    return {"classic": classic, "mega": mega}


def _track_err(poses: torch.Tensor, pose0: np.ndarray, name: str) -> float:
    err = float(np.linalg.norm(poses[-1, :2].cpu().numpy() - pose0[:2]))
    if not (np.isfinite(err) and err < TRACK_M):
        raise RuntimeError(f"{name}: pose {err} m from the start (tracking gate {TRACK_M} m)")
    return err


def run(particles=4000, beams=1080, chain=50, reps=5, rounds=3,
        map_name="Spielberg_map.yaml", synthetic=False, device=DEFAULT_DEVICE) -> dict:
    """The A/B. Returns the arms (``filter``, ``state``, per-round
    ``rates``, their ``spread``, ``corrections`` and ``err_m``), the LUT's
    bytes and seconds, the start pose and the scan."""
    device = resolve_device(device)
    n, r = particles, beams
    gm = (bench._synthetic_map(768, device=device) if synthetic
          else bench._load_real_map(map_name, device))
    beam_angles = bench._beams(r)
    t_build0 = time.perf_counter()
    filters = _build(gm, n, beam_angles)
    lut = filters["classic"].grid_map.range_lut
    build_s = time.perf_counter() - t_build0
    print(f"# arms built (dense LUT, {lut.numel() * lut.element_size()} B) in {build_s:.1f}s",
          file=sys.stderr, flush=True)

    pose0 = bench._start_pose(gm)
    scan = bench._synth_scan(filters["classic"].grid_map, beam_angles, pose0)
    actions = np.tile(np.array([0.05, 0.0, 0.01], np.float32), (chain, 1))
    scans = np.tile(scan, (chain, 1))

    arms = {}
    for name, pf in filters.items():
        st = pf.init_pose(pose0, seed=0)
        t0 = time.perf_counter()
        st, poses = pf.step_many(st, actions, scans)  # first launches + warm
        err = _track_err(poses, pose0, name)
        print(f"# {name}: first chain {time.perf_counter() - t0:.1f}s, err {err:.3f} m",
              file=sys.stderr, flush=True)
        arms[name] = dict(filter=pf, state=st, rates=[], corrections=chain)

    # interleave: classic, mega, classic, mega, ... per round
    for rd in range(rounds):
        for name, arm in arms.items():
            pf, st = arm["filter"], arm["state"]
            t0 = time.perf_counter()
            for _ in range(reps):
                st, poses = pf.step_many(st, actions, scans)
            bench._block(poses)
            arm["state"] = st
            arm["corrections"] += reps * chain
            arm["rates"].append(reps * chain / (time.perf_counter() - t0))
            print(f"round {rd} {name:8s} {arm['rates'][-1]:9.2f} updates/s",
                  file=sys.stderr, flush=True)
    for name, arm in arms.items():
        arm["state"], poses = arm["filter"].step_many(arm["state"], actions[:1], scans[:1])
        arm["corrections"] += 1
        arm["err_m"] = _track_err(poses, pose0, name)
        arm["spread"] = bench._spread(arm["rates"])
    return dict(arms=arms, lut_bytes=lut.numel() * lut.element_size(), build_s=build_s,
                pose0=pose0, scan=scan, map=gm.name, particles=n, beams=r)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="monte_carlo_localization_tpu_torch.tools.mega_ab")
    ap.add_argument("--particles", type=int, default=4000)
    ap.add_argument("--beams", type=int, default=1080)
    ap.add_argument("--chain", type=int, default=50)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--map", default="Spielberg_map.yaml")
    ap.add_argument("--synthetic", action="store_true",
                    help="768^2 synthetic world instead of the real map")
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    args = ap.parse_args(argv)
    out = run(args.particles, args.beams, args.chain, args.reps, args.rounds, args.map,
              args.synthetic, args.device)
    meds = {}
    for name, arm in out["arms"].items():
        s = arm["spread"]
        meds[name] = s["median"]
        print(f"{name:8s} median {s['median']:9.2f} updates/s "
              f"(min {s['min']:.1f}, max {s['max']:.1f}, n={s['rounds']})")
        print(f"{name:8s} still tracking: err {arm['err_m']:.3f} m")
    print(f"mega / classic = {meds['mega'] / meds['classic']:.3f}x")
    return 0


if __name__ == "__main__":
    sys.exit(main())
