"""The traffic a seed makes, the open-loop schedule and the window
arithmetic of the end-to-end metrics, on the CPU."""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest

from mcl_bench import spec
from mcl_bench.card import lut_bound
from mcl_bench.check import episode_seeds
from mcl_bench.generator import Reservoir
from mcl_bench.reference.mapio import latest_scan, load_trace, scan_actions, tick_action

TRACE = load_trace(spec.data_path("traces/config1_map_1753950572.npz"))


def test_a_seed_draws_the_same_sample_and_episode_seeds():
    picks = []
    for _ in range(2):
        r = Reservoir(6, np.random.default_rng([2**31 + 77, 1]))
        slots = [r.slot() for _ in range(400)]
        picks.append(slots)
    assert picks[0] == picks[1]
    assert episode_seeds(2**31 + 77, 5) == episode_seeds(2**31 + 77, 5)
    assert episode_seeds(2**31 + 77, 5) != episode_seeds(2**31 + 78, 5)


def test_the_reservoir_keeps_k_of_a_long_stream_spread_over_it():
    r = Reservoir(6, np.random.default_rng(3))
    kept = {}
    for i in range(10_000):
        s = r.slot()
        if s is not None:
            kept[s] = i
    assert len(kept) == 6 and max(kept.values()) > 1000


def test_scan_actions_integrate_every_twist_up_to_each_scan():
    acts = scan_actions(TRACE)
    assert acts.shape == (500, 3) and acts.dtype == np.float32
    assert np.all(acts[:, 1] == 0)
    # the whole drive: the sum of the twists times their left intervals
    dt = np.diff(TRACE.odom_t, prepend=TRACE.odom_t[:1])
    last = np.searchsorted(TRACE.odom_t, TRACE.scan_t[-1], side="right")
    want = np.sum(TRACE.odom_twist[:last, 0] * dt[:last])
    assert acts[:, 0].astype(np.float64).sum() == pytest.approx(want, rel=1e-5)


def test_the_program_derives_the_same_actions():
    from monte_carlo_localization_tpu_torch.runtime.trace import trace_actions

    got = trace_actions(TRACE.odom_t, TRACE.odom_twist, TRACE.scan_t)
    assert np.array_equal(got, scan_actions(TRACE))


def test_a_tick_reads_the_latest_twist_and_scan():
    t = 0.105  # odometry every 10 ms, scans every 40 ms
    i = int(np.searchsorted(TRACE.odom_t, t, side="right")) - 1
    v, w = TRACE.odom_twist[i]
    assert np.allclose(tick_action(TRACE, t, 1 / 1100), [v / 1100, 0.0, w / 1100])
    assert latest_scan(TRACE, t) == 2 and latest_scan(TRACE, 0.08) == 2
    assert np.all(tick_action(TRACE, t, 5e-5) == 0)


def test_the_open_loop_schedule_and_the_window_arithmetic():
    hz, n = 1100.0, 2200
    due = np.arange(n) / hz
    assert due[-1] == pytest.approx(2.0 - 1 / hz)
    lat = np.linspace(0.5e-3, 1.5e-3, n)
    run = SimpleNamespace(window=dict(latency_s=lat, update_s=lat / 2, updates_per_s=None))
    assert spec.reader("correction_p95_ms")(run) == pytest.approx(
        1e3 * np.percentile(lat, 95))
    assert spec.reader("update_wall_ms.live")(run) == pytest.approx(0.5)
    assert spec.reader("updates_per_s")(run) is None
    run = SimpleNamespace(window=dict(updates_per_s=1234.5))
    assert spec.reader("updates_per_s")(run) == 1234.5
    assert spec.reader("correction_p95_ms")(run) is None


def test_the_likelihood_kernel_bound_counts_from_shapes():
    b = lut_bound(4000, 4000, 60, 1, False)
    assert b["bytes"] == 12 * 4000 + 4 * 4000 + 8 * 60 + 4000 * 60
    assert b["f32_ops"] == 4000 * 12 + 4000 * 60 * 23 and b["f64_ops"] == 4000 * 60
    assert b["bound_ms"] == pytest.approx(max(b["bytes"] / 3.35e12,
                                              b["f32_ops"] / 67e12 + b["f64_ops"] / 34e12) * 1e3)
    compact = lut_bound(100_000, 90_000, 60, 1, True)
    assert compact["bytes"] == 16 * 100_000 + 480 + 90_000 * 64


def test_the_roofline_reader_is_silent_on_a_short_profile():
    read = spec.reader("lut_loglik_kernel_roofline")
    shapes = dict(n=4000, n_on=4000, beams=60, itemsize=1, row_map=False)
    prof = dict(complete=True, lut_rows=500, lut_us=500 * 3.9)
    pct = read(SimpleNamespace(profile=prof, shapes=shapes))
    assert pct == pytest.approx(100 * lut_bound(4000, 4000, 60, 1, False)["bound_ms"] / 3.9e-3)
    assert read(SimpleNamespace(profile=dict(prof, complete=False), shapes=shapes)) is None
