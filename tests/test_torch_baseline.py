"""The port's CPU reference harness (``baseline/cpu_reference.py``)
against the JAX package's, on config #1's golden trace
(``traces/config1_map_1753950572.npz``, its recorded SLAM map).

Both are numpy ``default_rng`` draws and the same native DDA source
(``tests/test_torch_raycast.py`` pins the port's copy byte-equal), so at
one seed they must agree bit for bit: every pose of a replay, the
initial clouds, the stats' correction count. Then the port's engine is
held to the harness as JAX ``tests/test_baseline_parity.py:36-80`` holds
the JAX engine: both track the truth, and each other."""

from pathlib import Path

import numpy as np
import pytest
import torch

from monte_carlo_localization_tpu.baseline import CPUReferenceFilter as JCPUReferenceFilter
from monte_carlo_localization_tpu.baseline import replay_cpu_reference as j_replay
from monte_carlo_localization_tpu.config import MCLConfig as JMCLConfig
from monte_carlo_localization_tpu.mapping import load_map as j_load_map
from monte_carlo_localization_tpu.runtime.trace import Trace as JTrace
from monte_carlo_localization_tpu_torch import MCLConfig, load_map
from monte_carlo_localization_tpu_torch.baseline import (
    CPUReferenceFilter,
    replay_cpu_reference,
    trajectory_rmse,
)
from monte_carlo_localization_tpu_torch.runtime import MCLNode, Trace

REPO = Path(__file__).resolve().parents[1]
TRACE = REPO / "traces" / "config1_map_1753950572.npz"
MAP = REPO / "maps" / "map_1753950572.yaml"


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def golden():
    return load_map(MAP, device="cpu"), Trace.load(TRACE)


@pytest.mark.parametrize("seed", [0, 3])
def test_replay_bit_equal_to_jax(golden, seed):
    gm, tr = golden
    cfg = dict(max_particles=200, angle_step=18)
    times, poses, stats, ups = replay_cpu_reference(gm, tr, MCLConfig(**cfg), seed=seed,
                                                    max_corrections=15)
    j_times, j_poses, j_stats, _ = j_replay(j_load_map(MAP), JTrace.load(TRACE),
                                            JMCLConfig(**cfg), seed=seed, max_corrections=15)
    np.testing.assert_array_equal(times, j_times)
    np.testing.assert_array_equal(poses, j_poses)
    assert stats.measurement_count == j_stats.measurement_count == 15 and ups > 0


def test_filters_draw_and_weigh_bit_equal_to_jax(golden):
    gm, tr = golden
    cfg = dict(max_particles=150, angle_step=36)
    port, jax_f = (CPUReferenceFilter(gm, MCLConfig(**cfg), seed=9),
                   JCPUReferenceFilter(j_load_map(MAP), JMCLConfig(**cfg), seed=9))
    port.init_global()
    jax_f.init_global()
    np.testing.assert_array_equal(port.particles, jax_f.particles)
    beams = tr.beam_angles[::36]
    port.set_beam_angles(beams)
    jax_f.set_beam_angles(beams)
    for i in range(3):
        action = np.array([0.03 * i, 0.0, 0.01])
        np.testing.assert_array_equal(port.step(action, tr.scan_ranges[i][::36]),
                                      jax_f.step(action, tr.scan_ranges[i][::36]))
    np.testing.assert_array_equal(port.weights, jax_f.weights)
    assert port.stats.ray_casting_time > 0  # phases instrumented


def test_engine_tracks_the_cpu_reference_on_trace(golden):
    gm, tr = golden
    times_c, poses_c, stats, _ = replay_cpu_reference(
        gm, tr, MCLConfig(max_particles=800, angle_step=18), seed=1, max_corrections=80)
    rx, rt = trajectory_rmse(times_c, poses_c, tr.truth_t, tr.truth_pose)
    assert rx < 0.10 and rt < 0.10, (rx, rt)

    node = MCLNode(gm, MCLConfig(max_particles=800, angle_step=18, raycast_method="lut"),
                   rng_seed=0)
    node.initialize_pose(tr.truth_pose[0])
    short = Trace(odom_t=tr.odom_t, odom_pose=tr.odom_pose, odom_twist=tr.odom_twist,
                  scan_t=tr.scan_t[:80], scan_ranges=tr.scan_ranges[:80],
                  beam_angles=tr.beam_angles, truth_t=tr.truth_t, truth_pose=tr.truth_pose)
    res = node.replay(short)
    assert res.rmse_xy is not None and res.rmse_xy < 0.12, res.rmse_xy
    assert res.rmse_theta < 0.10, res.rmse_theta
    k = min(len(times_c), len(res.times))
    cross = np.sqrt(((poses_c[:k, :2] - res.poses[-k:, :2]) ** 2).sum(axis=1).mean())
    assert cross < 0.2, f"cross-implementation trajectory RMSE {cross}"
