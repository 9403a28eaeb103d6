"""Fleet ROBOT-LOOP example: 8 cars with per-member dual-rate tracking.

``examples/fleet_racing.py`` drives the raw ``FleetFilter`` step API;
this example runs the whole robot loop instead: ``runtime.FleetNode``
carries one odometry tracker per member (the reference's 100-200 Hz
anchor + delta dead reckoner, per car), per-member scan ingest and one
fleet correction per tick, all scheduled by ``LiveRunner``'s wall timer.
An odometry pump thread feeds every member at a high rate while the loop
ticks, the dual-rate split a deployment runs. From the repo root:

    python -m monte_carlo_localization_tpu_torch.examples.fleet_live_loop
    python -m monte_carlo_localization_tpu_torch.examples.fleet_live_loop --device cpu
"""

from __future__ import annotations

import argparse
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

from monte_carlo_localization_tpu_torch import MCLConfig
from monte_carlo_localization_tpu_torch.mapping import load_map
from monte_carlo_localization_tpu_torch.ops.raycast import cast_rays_dda
from monte_carlo_localization_tpu_torch.runtime import CallbackSink, FleetNode, LiveRunner
from monte_carlo_localization_tpu_torch.utils.device import DEFAULT_DEVICE

REPO = Path(__file__).resolve().parents[2]
LOCKED_M = 0.5
WARM_S_MAX = 600.0


def run(fleet=8, beams=60, particles=1024, seconds=3.0, device=DEFAULT_DEVICE,
        log=print) -> dict:
    """``fleet`` cars standing at their true poses under a ``LiveRunner``
    for ``seconds``; raises unless every member's tracked pose stays
    within LOCKED_M of its truth. Returns the runner's counts, the rate,
    the errors and the node."""
    gm = load_map(REPO / "maps" / "sibal1.yaml", device=device)
    beam_angles = np.linspace(-2.35, 2.35, beams).astype(np.float32)
    rng = np.random.default_rng(0)

    # true poses: spread the cars around the circuit's free space
    free = gm.free_cells[: int(gm.num_free)].cpu().numpy()
    picks = free[rng.choice(len(free), fleet, replace=False)]
    poses = np.stack(
        [
            (picks[:, 1] + 0.5) * gm.resolution + float(gm.origin_x),
            (picks[:, 0] + 0.5) * gm.resolution + float(gm.origin_y),
            rng.uniform(-np.pi, np.pi, fleet),
        ],
        axis=1,
    ).astype(np.float32)

    node = FleetNode(
        gm,
        fleet_size=fleet,
        config=MCLConfig(
            max_particles=particles,
            raycast_method="lut",
            angle_step=1,
            timer_frequency=50.0,
            async_correction=True,
        ),
        rng_seed=0,
    )

    # synthesize each car's scan at its true pose and feed the node
    for m in range(fleet):
        p = poses[m]
        q = np.stack(
            [np.full(beams, p[0]), np.full(beams, p[1]), p[2] + beam_angles], 1
        ).astype(np.float32)
        scan = cast_rays_dda(gm, torch.as_tensor(q, device=gm.device)).cpu().numpy()
        node.on_scan(m, scan, beam_angles=beam_angles)
        node.on_odometry(m, *p, 0.0, 0.0, stamp=0.0)
    node.initialize_pose(poses)

    corrections = [0]
    node.add_sink(CallbackSink(
        lambda top, t, pay: corrections.__setitem__(0, corrections[0] + 1),
        topics=("fleet_pose",),
    ))

    # warm up: tick until the first harvest lands, so the timed live
    # window below measures the steady loop
    t_warm = time.perf_counter()
    while node.update() is None:
        if time.perf_counter() - t_warm > WARM_S_MAX:
            raise RuntimeError("warmup never harvested")

    stop = threading.Event()

    def odom_pump():  # 200 Hz odometry per member, from another thread
        while not stop.is_set():
            for m in range(fleet):
                node.on_odometry(m, *poses[m], 0.0, 0.0)
            time.sleep(0.005)

    pump = threading.Thread(target=odom_pump, daemon=True)
    pump.start()
    t0 = time.perf_counter()
    try:
        with LiveRunner(node) as runner:
            time.sleep(seconds)
    finally:
        stop.set()
        pump.join(timeout=2.0)
    if pump.is_alive():
        raise RuntimeError("the odometry pump did not stop")
    dt = time.perf_counter() - t0

    cur = node.current_poses()
    err = np.linalg.norm(cur[:, :2] - poses[:, :2], axis=1)
    rate = runner.corrections / dt
    log(
        f"{fleet}-car fleet live loop: {runner.corrections} fleet "
        f"corrections in {dt:.1f}s ({rate:.1f}/s = "
        f"{rate * fleet:.0f} member-corrections/s), "
        f"{runner.skipped} ticks skipped"
    )
    log(f"per-member tracked pose error (m): {np.round(err, 3)}")
    if not err.max() < LOCKED_M:
        raise RuntimeError(f"a member lost its lock: errors {err}")
    log("OK")
    return dict(corrections=runner.corrections, ticks=runner.ticks, skipped=runner.skipped,
                seconds=dt, fleet_corrections_per_s=rate, err_m=err, node=node)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="monte_carlo_localization_tpu_torch.examples.fleet_live_loop")
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    run(device=ap.parse_args(argv).device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
