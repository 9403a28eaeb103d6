"""Fleet localization example: 16 cars on the sibal1 circuit at once.

The reference is one ROS node per car; here a whole fleet is ONE batched
MCL step, and on the ``lut_pallas`` path the fleet likelihood is one
launch of the LUT kernel over the flattened particle batch, each member's
particles reading their own member's scan. From the repo root:

    python -m monte_carlo_localization_tpu_torch.examples.fleet_racing
    python -m monte_carlo_localization_tpu_torch.examples.fleet_racing --device cpu
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

from monte_carlo_localization_tpu_torch import MCLConfig
from monte_carlo_localization_tpu_torch.mapping import load_map
from monte_carlo_localization_tpu_torch.ops.raycast import cast_rays_dda
from monte_carlo_localization_tpu_torch.parallel import FleetFilter
from monte_carlo_localization_tpu_torch.utils.device import DEFAULT_DEVICE

REPO = Path(__file__).resolve().parents[2]
LOCALIZED_M = 0.3


def run(fleet=16, beams=60, particles=1000, iters=15, device=DEFAULT_DEVICE, log=print) -> dict:
    """``fleet`` cars, each from a loose cloud around a noisy guess, over
    ``iters`` corrections; raises unless every car ends within
    LOCALIZED_M of its truth. Returns the errors and the filter."""
    gm = load_map(REPO / "maps" / "sibal1.yaml", device=device)
    log(f"map {gm.name}: {gm.height}x{gm.width} @ {gm.resolution} m/px")

    beam_angles = np.linspace(-2.35, 2.35, beams).astype(np.float32)
    ff = FleetFilter(
        gm,
        fleet_size=fleet,
        config=MCLConfig(max_particles=particles, raycast_method="lut_pallas"),
        beam_angles=beam_angles,
    )

    # spread the cars over the fleet's most-cleared free cells (grid stride)
    free = gm.free_cells[: int(gm.num_free)].cpu().numpy()
    clear = gm.clearance.cpu().numpy()[free[:, 0], free[:, 1]]
    order = np.argsort(clear)[::-1]
    cells = free[order[:: max(1, len(order) // fleet)][:fleet]]
    true_poses = np.stack(
        [
            cells[:, 1] * gm.resolution + float(gm.origin_x),
            cells[:, 0] * gm.resolution + float(gm.origin_y),
            np.linspace(0, 2 * np.pi, fleet, endpoint=False),
        ],
        axis=1,
    ).astype(np.float32)

    # each car sees its own perfect scan at its own pose (DDA oracle)
    queries = np.concatenate(
        [
            np.stack([np.full(beams, p[0]), np.full(beams, p[1]), p[2] + beam_angles], axis=1)
            for p in true_poses
        ]
    ).astype(np.float32)
    scans = cast_rays_dda(gm, torch.as_tensor(queries, device=gm.device))
    scans = scans.cpu().numpy().reshape(fleet, beams)

    # every car starts with a loose cloud around a noisy guess
    rng = np.random.default_rng(0)
    guesses = true_poses + rng.normal(0, [0.3, 0.3, 0.2], true_poses.shape).astype(np.float32)
    state = ff.init_pose(guesses, seed=1)

    actions = np.zeros((fleet, 3), np.float32)
    for _ in range(iters):
        state, poses = ff.step(state, actions, scans)

    poses = poses.cpu().numpy()
    err = np.linalg.norm(poses[:, :2] - true_poses[:, :2], axis=1)
    log(f"after {iters} corrections: mean err {err.mean():.3f} m, "
        f"max {err.max():.3f} m over {fleet} cars")
    if not err.max() < LOCALIZED_M:
        raise RuntimeError(f"a car failed to localize: errors {err}")
    log("fleet OK")
    return dict(err_m=err, poses=poses, true_poses=true_poses, filter=ff)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="monte_carlo_localization_tpu_torch.examples.fleet_racing")
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    run(device=ap.parse_args(argv).device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
