"""The port's benchmark harness (``monte_carlo_localization_tpu_torch/bench.py``)
against the JAX package's root ``bench.py``, on the CPU.

- Its constants and pose helpers are the JAX harness's, on the real maps.
- Its workloads draw the same truth poses: the JAX harness's draws are
  read off its own runs, by spying on the sphere caster that synthesizes
  each scan, with its filter and node stubbed out. The port's sphere-cast
  scans at those poses agree with the JAX caster's within the raycast
  parity tests' tolerance (tests/test_torch_raycast.py).
- The JAX harness tests of ``tests/test_convergence.py`` run on the port:
  the ``bench_convergence`` surface at the box world, and the three
  kidnap arms at the JAX test's sizes.
- ``python -m monte_carlo_localization_tpu_torch.bench --device cpu``
  prints the JAX line's keys (``BENCH_r05.json``) plus the device's.
"""

import json
import sys
from pathlib import Path
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import bench as jbench  # noqa: E402  (the JAX package's harness)

from monte_carlo_localization_tpu.mapping import box_world as jbox_world  # noqa: E402
from monte_carlo_localization_tpu.mapping import load_map as jload_map  # noqa: E402
from monte_carlo_localization_tpu_torch import bench as tbench  # noqa: E402
from monte_carlo_localization_tpu_torch.mapping import box_world, load_map  # noqa: E402

torch.set_num_threads(1)


def test_constants_are_the_jax_harness_s():
    assert tbench.NORTH_STAR_UPDATES_PER_SEC == jbench.NORTH_STAR_UPDATES_PER_SEC
    assert tbench.CONFIG_MAPS == jbench.CONFIG_MAPS
    assert tbench.MAPS_DIR == jbench.MAPS_DIR
    # each JAX config's timeout sized its watchdog, which is not ported
    assert tbench.CONFIGS == {n: {k: v for k, v in c.items() if k != "timeout"}
                              for n, c in jbench.CONFIGS.items()}


@pytest.mark.parametrize("n", [1, 2, 24, 60, 1080])
def test_beams_are_the_jax_harness_s(n):
    got, want = tbench._beams(n), jbench._beams(n)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_drift_threshold_and_spread_are_the_jax_harness_s():
    for s in (0, 1, 40, 100, 160, 4001):
        assert tbench._drift_threshold(s) == jbench._drift_threshold(s)
        assert tbench._drift_threshold(s, 0.1) == jbench._drift_threshold(s, 0.1)
    rates = [3.0, 1.0, 2.5, 7.25]
    assert tbench._spread(rates) == jbench._spread(rates)


@pytest.fixture(scope="module")
def config1_maps():
    path = REPO / "maps" / jbench.CONFIG_MAPS[1]
    return jload_map(path), load_map(path, device="cpu")


@pytest.fixture(scope="module")
def basement_maps():
    path = REPO / "maps" / jbench.CONFIG_MAPS[4]
    return jload_map(path), load_map(path, device="cpu")


def test_pose_helpers_are_the_jax_harness_s(config1_maps):
    jm, tm = config1_maps
    center = tbench._center_pose(tm)
    assert center.dtype == np.float32 and np.array_equal(center, jbench._center_pose(jm))
    rng = np.random.default_rng(3)
    lo = np.array([float(jm.origin_x), float(jm.origin_y), -np.pi])
    hi = lo + np.array([jm.width * jm.resolution, jm.height * jm.resolution, 2 * np.pi])
    for pose in [center, *rng.uniform(lo, hi, (20, 3)).astype(np.float32)]:
        got, want = tbench._nearest_free_pose(tm, pose), jbench._nearest_free_pose(jm, pose)
        assert got.dtype == np.float32 and np.array_equal(got, want)


def test_start_pose_leaves_the_jax_corner_only_where_its_scan_is_all_zero(basement_maps):
    """On basement_fixed the JAX harness's start pose, the corner of the
    free cell nearest the centroid, truncates into the occupied neighbour:
    its scan reads 0 m on every beam in both packages. There the tracking
    workloads start at that cell's centre, whose scan sees the walls."""
    import monte_carlo_localization_tpu.ops.raycast as jray

    beams = tbench._beams(60)
    jm, tm = basement_maps
    corner = jbench._nearest_free_pose(jm, jbench._center_pose(jm))
    jscan = np.asarray(jray.cast_rays_sphere(jm, jnp.asarray(_query(corner, beams)), num_iters=64))
    assert not jscan.any() and not tbench._synth_scan(tm, beams, corner).any()
    start = tbench._start_pose(tm)
    assert np.allclose(start - corner, [tm.resolution / 2, tm.resolution / 2, 0], atol=1e-5)
    col, row = int((start[0] - tm.origin_x) / tm.resolution), int(
        (start[1] - tm.origin_y) / tm.resolution)
    assert tm.occupancy[row, col] == 0 and tm.clearance[row, col] >= 1
    scan = tbench._synth_scan(tm, beams, start)
    assert (scan > 0).sum() >= 15 and scan.max() > 1.0  # beams away from the wall see the room


@pytest.mark.parametrize("name", sorted(
    {m for v in jbench.CONFIG_MAPS.values() for m in ([v] if isinstance(v, str) else v)}
    - {jbench.CONFIG_MAPS[4]}) + ["basement_rot180"])
def test_start_pose_is_the_jax_corner_on_every_other_map(name):
    """Every other map of the harness's workloads (the giant fleet's
    rotated basement too) starts where the JAX harness starts."""
    if name == "basement_rot180":
        tm = tbench._giant_fleet_maps(device="cpu")[1]
    else:
        tm = load_map(REPO / "maps" / name, device="cpu")
    corner = tbench._nearest_free_pose(tm, tbench._center_pose(tm))
    assert np.array_equal(tbench._start_pose(tm), corner)
    assert tbench._synth_scan(tm, tbench._beams(60), corner).any()


class _SteppedFilter:
    """A filter whose steps count one LUT-kernel launch a correction."""

    def __init__(self):
        self.likelihood = SimpleNamespace(launch_count=0, fleet_launch_count=0,
                                          dedup_launch_count=0)

    def step(self, state, action, scan):
        self.likelihood.launch_count += 1
        return state, None

    def step_many(self, state, actions, scans):
        self.likelihood.launch_count += len(actions)
        return state, None


def test_counted_adds_what_the_steps_ran_and_no_other_launch(monkeypatch):
    monkeypatch.setattr(tbench, "LAUNCHES", tbench.collections.Counter())
    filt = tbench._counted(_SteppedFilter())
    filt.step(None, np.zeros(3), None)
    filt.step_many(None, np.zeros((5, 3)), None)
    filt.likelihood.launch_count += 1  # a caller's own comparison
    assert tbench.LAUNCHES == {"corrections": 6, "lut_loglik": 6}


def test_giant_fleet_maps_are_the_jax_harness_s():
    """Basement and its 180-degree rotation, without LUTs: the same
    occupancy, free cells, clearance and geometry."""
    want = jbench._giant_fleet_maps()
    got = tbench._giant_fleet_maps(device="cpu")
    assert [m.name for m in got] == [m.name for m in want] == ["basement_fixed.map",
                                                               "basement_rot180"]
    for t, j in zip(got, want):
        assert np.array_equal(t.occupancy.numpy(), np.asarray(j.occupancy))
        assert np.array_equal(t.clearance.numpy(), np.asarray(j.clearance))
        assert int(t.num_free) == int(j.num_free)
        assert np.array_equal(t.free_cells[: int(t.num_free)].numpy(),
                              np.asarray(j.free_cells[: int(j.num_free)]))
        assert (t.resolution, t.max_range_px, t.max_range_meters) == (
            j.resolution, j.max_range_px, j.max_range_meters)
        assert (t.origin_x, t.origin_y) == (float(j.origin_x), float(j.origin_y))
        assert t.range_lut is None and j.range_lut is None
    assert not np.array_equal(got[0].occupancy.numpy(), got[1].occupancy.numpy())


def test_sibal1_max_range_px_truncates_to_239():
    """sibal1 stores the f32-fuzzed 0.05000000074505806 m: 12 m over it is
    239.99999..., which both packages truncate to 239 (why config #5's
    stacked maps leave it out)."""
    path = REPO / "maps" / jbench.CONFIG_MAPS[2]
    jm, tm = jload_map(path), load_map(path, device="cpu")
    assert tm.resolution == jm.resolution == 0.05000000074505806
    assert tm.max_range_px == jm.max_range_px == 239


class _Caster:
    """A spy on the JAX ``cast_rays_sphere``: records each query and the
    scan it returns (zeros without ``real``: the stubs read no scan)."""

    def __init__(self, real):
        self.real, self.queries, self.scans = real, [], []

    def __call__(self, gm, q, num_iters=48):
        assert num_iters == 64
        out = jnp.zeros(q.shape[0]) if self.real is None else self.real(gm, q, num_iters=num_iters)
        self.queries.append(np.asarray(q))
        self.scans.append(np.asarray(out))
        return out


def _query(pose, beams) -> np.ndarray:
    """The harness's query of a pose's scan."""
    return np.stack([np.full(len(beams), pose[0]), np.full(len(beams), pose[1]),
                     pose[2] + beams], 1).astype(np.float32)


def _spy(monkeypatch, cast: bool = True):
    import monte_carlo_localization_tpu.ops.raycast as jray

    caster = _Caster(jray.cast_rays_sphere if cast else None)
    monkeypatch.setattr(jray, "cast_rays_sphere", caster)
    return caster


def _scans_agree(got: np.ndarray, want: np.ndarray, res: float) -> None:
    """The raycast parity tests' tolerance: >= 99% of rays within 1e-5 m,
    every ray within one cell."""
    assert got.dtype == np.float32 and got.shape == want.shape
    close = np.abs(got - want) <= 1e-5
    assert close.mean() >= 0.99, close.mean()
    assert np.abs(got - want).max() <= res + 1e-5


class _StubFilter:
    """Stands in for the JAX ParticleFilter: no correction runs, no trial
    converges, and bench_convergence draws every trial's truth."""

    def __init__(self, gm, cfg):
        pass

    def set_beam_angles(self, beams):
        pass

    def init_global(self, seed):
        return None

    def step_many(self, state, actions, scans):
        return state, jnp.full((len(actions), 3), 1e6, jnp.float32)


def test_convergence_truths_and_scans_are_the_jax_harness_s(monkeypatch, basement_maps):
    jm, tm = basement_maps
    caster = _spy(monkeypatch)
    monkeypatch.setattr("monte_carlo_localization_tpu.filter.ParticleFilter", _StubFilter)
    trials = 5
    rate, *_ = jbench.bench_convergence(64, 60, jm, trials=trials, max_updates=5)
    assert rate == 0.0 and len(caster.queries) == 1 + trials  # the warm scan, then each trial's
    beams = tbench._beams(60)
    truths = tbench._convergence_truths(tm, trials)
    assert len(truths) == trials
    warm = tbench._nearest_free_pose(tm, tbench._center_pose(tm))
    for pose, q, scan in zip([warm, *truths], caster.queries, caster.scans):
        assert pose.dtype == np.float32 and np.array_equal(_query(pose, beams), q)
        _scans_agree(tbench._synth_scan(tm, beams, pose), scan, tm.resolution)


class _StubNode:
    """Stands in for the JAX MCLNode: no correction runs and no trial
    converges, so bench_kidnap draws each trial's pose pair and scans."""

    def __init__(self, gm, cfg, rng_seed=None):
        self.filter = SimpleNamespace(init_global=lambda seed: None)
        self.tracker = SimpleNamespace(deactivate=lambda: None)
        self.auto_reinits = self.inject_steps = 0

    def _flush_inflight(self):
        pass

    def on_scan(self, scan, beam_angles=None):
        pass

    def on_odometry(self, *args, **kwargs):
        pass

    def update(self, now=None):
        return None


@pytest.mark.parametrize("where, trials", [("basement", 40), ("box", 24)])
def test_kidnap_pose_pairs_are_the_jax_harness_s(monkeypatch, basement_maps, where, trials):
    """The pairs of run_kidnap's 40 trials on basement_fixed, and on a
    10 x 15 m box, where B often falls within 2 m of A and is redrawn."""
    jm, tm = basement_maps if where == "basement" else (jbox_world(), box_world(device="cpu"))
    caster = _spy(monkeypatch, cast=False)
    monkeypatch.setattr("monte_carlo_localization_tpu.runtime.MCLNode", _StubNode)
    jbench.bench_kidnap(64, 12, jm, trials=trials, converge_updates=1)
    assert len(caster.queries) == 2 * trials
    beams = tbench._beams(12)
    pairs = tbench._kidnap_pose_pairs(tm, trials, 0.5)
    assert len(pairs) == trials
    for i, (a, b) in enumerate(pairs):
        assert np.array_equal(_query(a, beams), caster.queries[2 * i])
        assert np.array_equal(_query(b, beams), caster.queries[2 * i + 1])
        assert np.hypot(*(b[:2] - a[:2])) >= 2.0 or where == "box"
    if where == "box":  # the guard redrew some B: the stream ran past 2 draws a trial
        rng = np.random.default_rng(7)
        free = tbench._free_cells(tm)
        naive = [tbench._random_free_pose(tm, free, rng) for _ in range(2 * trials)]
        assert any(not np.array_equal(b, naive[2 * i + 1]) for i, (_, b) in enumerate(pairs))


def test_converge_bench_surface():
    """bench_convergence's success accounting and per-trial records at
    toy scale on the box world (tests/test_convergence.py), and its
    corrections in LAUNCHES."""
    tbench.LAUNCHES.clear()
    rate, med_u, med_s, per_trial = tbench.bench_convergence(
        512, 24, box_world(device="cpu"), method="lut", trials=2, max_updates=30,
        chunk=5, tol_m=0.6,
    )
    assert len(per_trial) == 2
    assert 0.0 <= rate <= 1.0
    updates = 0
    for t in per_trial:
        if t is not None:
            assert t["updates"] % 5 == 0
            assert t["seconds"] > 0
        updates += 30 if t is None else t["updates"]
    if rate > 0:
        assert med_u is not None and med_s is not None
    # the warm chunk and every trial's chunks; the lut method has no kernel
    assert tbench.LAUNCHES["corrections"] == 5 + updates
    assert tbench.LAUNCHES["lut_loglik"] == 0


def test_fleet_bench_counts_every_fleet_correction(monkeypatch):
    """bench_fleet's quick run counts, where the fleet steps, a warm chain
    of 5, 2 rounds of one chain of 5, a warm step and 2 rounds of 5 steps:
    26 fleet corrections (the lut method has no kernel)."""
    monkeypatch.setattr(tbench, "LAUNCHES", tbench.collections.Counter())
    dispatch, chained, _ = tbench.bench_fleet(4, 64, 12, [box_world(device="cpu")], method="lut",
                                              quick=True)
    assert dispatch["rounds"] == chained["rounds"] == 2
    assert tbench.LAUNCHES == {"fleet_corrections": 26}


def test_kidnap_monitor_recovers_where_plain_filter_stays_locked():
    """The three kidnap arms at the JAX test's sizes
    (tests/test_convergence.py): after the scan stream teleports, the
    re-init arm's monitor triggers a global re-init and reconverges at the
    new pose, the injection arm recovers without one, and the monitor-off
    filter (the reference's behavior) stays locked at the old pose."""
    gm = tbench._synthetic_map(128, seed=2, device="cpu")
    rate_on, med_on, per_on = tbench.bench_kidnap(
        6000, 60, gm, method="lut", trials=1, auto_reinit=True,
        recover_updates=200,
    )
    assert rate_on == 1.0, per_on
    assert per_on[0]["auto_reinits"] >= 1
    assert med_on is not None and med_on <= 100

    rate_off, _, per_off = tbench.bench_kidnap(
        6000, 60, gm, method="lut", trials=1, auto_reinit=False,
        recover_updates=60,
    )
    assert rate_off == 0.0, per_off
    assert per_off[0]["auto_reinits"] == 0

    rate_inj, med_inj, per_inj = tbench.bench_kidnap(
        6000, 60, gm, method="lut", trials=1, auto_reinit=True,
        reinit_mode="inject", recover_updates=200,
    )
    assert rate_inj == 1.0, per_inj
    assert per_inj[0]["auto_reinits"] == 0
    assert per_inj[0]["inject_steps"] >= 1
    assert med_inj is not None and med_inj <= 100


def test_config1_line_has_the_jax_keys(capsys):
    """``--device cpu --config 1 --quick`` prints one line with every key
    of BENCH_r05.json's parsed line, the device's, and the +cpu label;
    LAUNCHES counts its corrections (chained: a warm chain of 50 and 2
    rounds of 2; per step: 1 warm and 2 rounds of 5)."""
    tbench.LAUNCHES.clear()
    assert tbench.main(["--device", "cpu", "--config", "1", "--quick"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    jax_keys = set(json.loads((REPO / "BENCH_r05.json").read_text())["parsed"])
    assert jax_keys | {"device", "power_limit_w", "note"} == set(line)
    assert line["device"] == line["power_limit_w"] == "cpu"
    assert line["method"] == "lut_pallas+cpu" and "NOT the accelerator" in line["note"]
    assert line["metric"] == f"mcl_updates_per_sec[{jbench.CONFIGS[1]['note']}][quick]"
    assert line["rounds"] == 2 and line["value_min"] <= line["value"] <= line["value_max"]
    assert line["value"] > 0 and line["dispatch_updates_per_sec"] > 0
    assert tbench.LAUNCHES["corrections"] == 50 * (1 + 2 * 2) + 1 + 2 * 5


def test_without_a_card_the_default_device_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        tbench.main(["--config", "1", "--quick"])
