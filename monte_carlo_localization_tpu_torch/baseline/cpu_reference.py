"""Reference-faithful CPU MCL — the measured baseline harness.

BASELINE.md requires the CPU baseline be MEASURED, not cited: the upstream
repo publishes no numbers and its ROS node can't run here. This module is
a behaviorally faithful CPU reimplementation of the reference's MCL step
(reference src/particle_filter.cpp:652-694) built from the same pieces the
C++ node uses, so its TimingStats are an honest stand-in for the
reference's own self-reported profile (reference src/utils.cpp:93-125,
printed at src/particle_filter.cpp:814-827):

* multinomial resampling (``std::discrete_distribution``, reference
  :657-665) -> ``rng.choice`` with replacement on the weight vector,
* per-particle arc/straight motion with the dt-reconstruction heuristic
  and iid Gaussian noise (reference :449-503), vectorized numpy,
* beam sensor model: N*R query build (reference :526-535), batch DDA ray
  cast via the native C++/OpenMP caster — the exact reference stepping
  loop (reference :611-650 == native/mcl_native.cpp:93-125) — pixel
  conversion, LUT product in double, ``weight^(1/squash)``
  (reference :545-579),
* weight normalization + weighted/circular-mean pose (reference :679-716).

Phase timings use the same six accumulators as the reference's
TimingStats. This runs on the host CPU by design (it is the measured CPU
baseline): numpy and the port's own native DDA caster, no torch tensor
on the card. With the same seed it draws, casts and weighs as the JAX
package's ``baseline/cpu_reference.py`` does, bit for bit.
"""

from __future__ import annotations

import numpy as np

from monte_carlo_localization_tpu_torch.config import MCLConfig
from monte_carlo_localization_tpu_torch.mapping.grid_map import GridMap
from monte_carlo_localization_tpu_torch.models.sensor import build_sensor_table
from monte_carlo_localization_tpu_torch.runtime.trace import HostRaycaster, Trace
from monte_carlo_localization_tpu_torch.utils.geometry import trajectory_rmse  # noqa: F401 - re-exported API
from monte_carlo_localization_tpu_torch.utils.timing import Stopwatch, TimingStats


class CPUReferenceFilter:
    """The reference MCL step on the host CPU (numpy + native DDA)."""

    def __init__(
        self,
        grid_map: GridMap,
        config: MCLConfig | None = None,
        seed: int = 0,
    ):
        self.config = config or MCLConfig()
        self.map = grid_map.to("cpu")
        self.rng = np.random.default_rng(seed)
        self.caster = HostRaycaster(self.map)
        self.table = build_sensor_table(
            grid_map.max_range_px,
            z_hit=self.config.z_hit,
            z_short=self.config.z_short,
            z_max=self.config.z_max,
            z_rand=self.config.z_rand,
            sigma_hit=self.config.sigma_hit,
        ).astype(np.float64)
        self.stats = TimingStats()
        self.beam_angles: np.ndarray | None = None
        n = self.config.max_particles
        self.particles = np.zeros((n, 3), np.float64)
        self.weights = np.full(n, 1.0 / n, np.float64)

    # ----- initialization (reference :382-446) -----
    def init_pose(self, pose) -> None:
        n = self.config.max_particles
        self.particles = np.stack(
            [
                pose[0] + self.rng.normal(0, 0.5, n),
                pose[1] + self.rng.normal(0, 0.5, n),
                pose[2] + self.rng.normal(0, 0.4, n),
            ],
            axis=1,
        )
        self.weights = np.full(n, 1.0 / n, np.float64)

    def init_global(self) -> None:
        n = self.config.max_particles
        free = self.map.free_cells[: int(self.map.num_free)].numpy()
        idx = self.rng.integers(0, len(free), n)
        cells = free[idx]
        self.particles = np.stack(
            [
                cells[:, 1] * self.map.resolution + float(self.map.origin_x),
                cells[:, 0] * self.map.resolution + float(self.map.origin_y),
                self.rng.uniform(0.0, 2 * np.pi, n),
            ],
            axis=1,
        )
        self.weights = np.full(n, 1.0 / n, np.float64)

    def set_beam_angles(self, beams: np.ndarray) -> None:
        self.beam_angles = np.asarray(beams, np.float64)

    # ----- one MCL step (reference MCL() :652-694) -----
    def step(self, action: np.ndarray, observed_m: np.ndarray) -> np.ndarray:
        assert self.beam_angles is not None
        n = len(self.particles)
        r = len(self.beam_angles)
        with Stopwatch(self.stats, "total_mcl_time"):
            # resample: multinomial draw from the old weights (:657-665)
            with Stopwatch(self.stats, "resampling_time"):
                idx = self.rng.choice(n, size=n, replace=True, p=self.weights)
                proposal = self.particles[idx].copy()

            # motion (:449-503), dt-reconstruction heuristic included
            with Stopwatch(self.stats, "motion_model_time"):
                self._motion(proposal, action)

            # sensor (:506-583)
            with Stopwatch(self.stats, "query_prep_time"):
                queries = np.empty((n * r, 3), np.float32)
                queries[:, 0] = np.repeat(proposal[:, 0], r)
                queries[:, 1] = np.repeat(proposal[:, 1], r)
                queries[:, 2] = (
                    proposal[:, 2:3] + self.beam_angles[None, :]
                ).reshape(-1)
            with Stopwatch(self.stats, "ray_casting_time"):
                expected_m = self.caster(queries)
            with Stopwatch(self.stats, "sensor_model_time"):
                res = self.map.resolution
                mrp = self.map.max_range_px
                obs_px = np.rint(
                    np.clip(np.nan_to_num(observed_m / res, nan=mrp), 0, mrp)
                ).astype(np.int64)
                exp_px = np.rint(
                    np.clip(expected_m.reshape(n, r) / res, 0, mrp)
                ).astype(np.int64)
                # product over beams in double, then squash (:564-579)
                p = self.table[obs_px[None, :], exp_px]  # (n, r)
                w = np.prod(p, axis=1)
                w = np.power(np.maximum(w, 1e-300), 1.0 / self.config.squash_factor)

            # normalize + commit (:679-689)
            s = w.sum()
            self.weights = w / s if s > 0 else np.full(n, 1.0 / n)
            self.particles = proposal
        self.stats.measurement_count += 1
        return self.expected_pose()

    def _motion(self, particles: np.ndarray, action) -> None:
        fwd, dth = float(action[0]), float(action[2])
        afwd = abs(fwd)
        if afwd > 0.001:  # dt heuristic (:452-471)
            dt = afwd / 1.0 if afwd < 0.1 else afwd / 5.0
            dt = min(max(dt, 0.001), 0.1)
            v = fwd / dt
        else:
            dt, v = 0.01, 0.0
        omega = dth / dt if abs(dth) > 0.001 else 0.0
        ds, dtheta = v * dt, omega * dt

        theta = particles[:, 2]
        if abs(omega) < 1e-6:  # straight (:477-481)
            particles[:, 0] += ds * np.cos(theta)
            particles[:, 1] += ds * np.sin(theta)
        else:  # arc (:483-490)
            radius = ds / dtheta
            particles[:, 0] += radius * (np.sin(theta + dtheta) - np.sin(theta))
            particles[:, 1] -= radius * (np.cos(theta + dtheta) - np.cos(theta))
            particles[:, 2] += dtheta
        cfg = self.config
        noise = self.rng.normal(size=(len(particles), 3))
        particles[:, 0] += noise[:, 0] * cfg.motion_dispersion_x
        particles[:, 1] += noise[:, 1] * cfg.motion_dispersion_y
        particles[:, 2] = np.mod(
            particles[:, 2] + noise[:, 2] * cfg.motion_dispersion_theta + np.pi,
            2 * np.pi,
        ) - np.pi

    def expected_pose(self) -> np.ndarray:
        """Weighted mean + circular mean heading (reference :696-716)."""
        w = self.weights
        return np.array(
            [
                (w * self.particles[:, 0]).sum(),
                (w * self.particles[:, 1]).sum(),
                np.arctan2(
                    (w * np.sin(self.particles[:, 2])).sum(),
                    (w * np.cos(self.particles[:, 2])).sum(),
                ),
            ]
        )


def replay_cpu_reference(
    grid_map: GridMap,
    trace: Trace,
    config: MCLConfig | None = None,
    seed: int = 0,
    start_pose: np.ndarray | None = None,
    max_corrections: int | None = None,
):
    """Replay a trace through the CPU reference filter.

    One correction per scan event, action integrated from the odometry
    twists between scans (the steady-state behavior of the reference
    node). Returns (times, poses, stats, updates_per_sec).
    """
    import time as _time

    cfg = config or MCLConfig()
    f = CPUReferenceFilter(grid_map, cfg, seed=seed)
    beams = trace.beam_angles[:: cfg.angle_step]
    f.set_beam_angles(beams)
    if start_pose is not None:
        f.init_pose(np.asarray(start_pose, np.float64))
    elif trace.truth_pose is not None:
        f.init_pose(trace.truth_pose[0])
    else:
        f.init_global()

    times, poses = [], []
    oi = 0
    last_v = last_om = 0.0
    wall0 = _time.perf_counter()
    for si, t in enumerate(trace.scan_t):
        if max_corrections is not None and si >= max_corrections:
            break
        # integrate twists up to this scan time
        ds = dth = 0.0
        while oi < len(trace.odom_t) and trace.odom_t[oi] <= t:
            dt_o = trace.odom_t[oi] - (
                trace.odom_t[oi - 1] if oi > 0 else trace.odom_t[oi]
            )
            last_v, last_om = trace.odom_twist[oi]
            ds += last_v * dt_o
            dth += last_om * dt_o
            oi += 1
        scan = trace.scan_ranges[si][:: cfg.angle_step]
        pose = f.step(np.array([ds, 0.0, dth]), scan)
        times.append(float(t))
        poses.append(pose)
    wall = _time.perf_counter() - wall0
    ups = len(times) / wall if wall > 0 else 0.0
    return np.asarray(times), np.asarray(poses), f.stats, ups
