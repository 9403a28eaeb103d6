"""Minimal end-to-end example: global localization on a real reference map.

Loads the recorded real-sensor SLAM map the reference ships, synthesizes a
perfect 60-beam scan at a known pose with the DDA oracle, seeds 4000
particles uniformly over free space, and runs MCL corrections until the
cloud converges on the true pose. From the repo root:

    python -m monte_carlo_localization_tpu_torch.examples.localize_on_map
    python -m monte_carlo_localization_tpu_torch.examples.localize_on_map --device cpu
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

from monte_carlo_localization_tpu_torch import MCLConfig, ParticleFilter
from monte_carlo_localization_tpu_torch.mapping import load_map
from monte_carlo_localization_tpu_torch.ops.raycast import cast_rays_dda
from monte_carlo_localization_tpu_torch.utils.device import DEFAULT_DEVICE

REPO = Path(__file__).resolve().parents[2]
CONVERGED_M = 0.15


def run(particles=4000, beams=60, iters=30, device=DEFAULT_DEVICE, log=print) -> dict:
    """Global localization with ``particles`` over ``iters`` corrections;
    raises unless the pose ends within CONVERGED_M of the truth. Returns
    the error, the pose and the filter."""
    gm = load_map(REPO / "maps" / "map_1753950572.yaml", device=device)
    log(f"map {gm.name}: {gm.height}x{gm.width} @ {gm.resolution} m/px")

    pf = ParticleFilter(gm, MCLConfig(max_particles=particles, raycast_method="lut"))
    beam_angles = np.linspace(-2.35, 2.35, beams).astype(np.float32)
    pf.set_beam_angles(beam_angles)

    # pick a well-cleared free cell as the true pose
    free = gm.free_cells[: int(gm.num_free)].cpu().numpy()
    clear = gm.clearance.cpu().numpy()[free[:, 0], free[:, 1]]
    cell = free[np.argmax(clear)]
    true_pose = np.array(
        [
            cell[1] * gm.resolution + float(gm.origin_x),
            cell[0] * gm.resolution + float(gm.origin_y),
            0.3,
        ],
        np.float32,
    )
    q = np.stack(
        [np.full(beams, true_pose[0]), np.full(beams, true_pose[1]), true_pose[2] + beam_angles],
        axis=1,
    ).astype(np.float32)
    scan = cast_rays_dda(gm, torch.as_tensor(q, device=gm.device)).cpu().numpy()

    state = pf.init_global(seed=0)
    for i in range(iters):
        state, pose = pf.step(state, np.zeros(3), scan)
        if i % 5 == 4:
            p = pose.cpu().numpy()
            err = np.linalg.norm(p[:2] - true_pose[:2])
            log(f"iter {i + 1:2d}: pose=({p[0]:.3f}, {p[1]:.3f}, {p[2]:.3f}) "
                f"err={err * 100:.1f} cm")

    pose = pose.cpu().numpy()
    err = float(np.linalg.norm(pose[:2] - true_pose[:2]))
    if not err < CONVERGED_M:
        raise RuntimeError(f"did not converge: {err} m")
    log("converged OK")
    return dict(err_m=err, pose=pose, true_pose=true_pose, filter=pf)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="monte_carlo_localization_tpu_torch.examples.localize_on_map")
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    run(device=ap.parse_args(argv).device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
