"""The Spielberg headline deployment (``mcl_bench`` configuration
``spielberg_headline_4000x1080``, cell ``headline_replay``) on the CPU,
at a size the CPU takes: a 256 x 256 crop of ``maps/Spielberg_map.yaml``
around the trace's first true pose, its row-compacted LUT, every beam of
the 1080-beam scan (``angle_step: 1``) and 512 particles.

- The port's ``step_many`` on given draws against the benchmark's plain
  reference (``mcl_bench.reference.Reference.correct``), correction by
  correction from the program's own state; and a short slice of
  ``traces/spielberg_1080.npz`` through ``MCLNode.replay_chained`` under
  the benchmark's own comparison and the cell's limits.
- The reference's beam geometry against ``LUTQuery``'s.
- The configuration, its limits, the cell and the trace as
  ``mcl_bench.spec`` loads them.
- ``lut_loglik_kernel``'s launches by form (``LUTQuery.form``, the count
  each launch adds to): a 1080-beam query is the warp form, a tabled
  60-beam one the 16-lane form; ``TRACER.summary()`` carries both.
- ``likelihood_device_us.replay``'s reader of the counter
  ``device.likelihood``.
- The compact LUT through ``GridMap.with_compact_range_lut`` computes its
  row map once, with the same bytes as a build that makes its own.
"""

import dataclasses
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from mcl_bench import spec
from mcl_bench.check import NUMBERS, Comparison, verdict
from mcl_bench.generator import Session
from mcl_bench.reference.lut import beam_offsets, theta_bins
from mcl_bench.reference.mapio import load_map as ref_load_map
from mcl_bench.reference.mapio import load_trace, scan_actions
from mcl_bench.reference.model import Params, Reference, angle_gap
from monte_carlo_localization_tpu_torch import MCLConfig, ParticleFilter, load_map
from monte_carlo_localization_tpu_torch.filter.core import MCLState
from monte_carlo_localization_tpu_torch.mapping import clearance_field, map_from_occupancy
from monte_carlo_localization_tpu_torch.mapping import grid_map as grid_map_module
from monte_carlo_localization_tpu_torch.mapping import range_lut_device
from monte_carlo_localization_tpu_torch.mapping.range_lut_device import (
    FAR_ROW_MARGIN,
    build_compact_range_lut_device,
)
from monte_carlo_localization_tpu_torch.ops.lut_query import (
    SMALL_GROUP,
    WARP,
    LUTQuery,
    required_row_stride,
    suggest_theta_bins,
)
from monte_carlo_localization_tpu_torch.utils.timing import COUNTS, TRACER

CONFIG = "spielberg_headline_4000x1080"
CELL = "headline_replay"
CROP = 256  # cells a side
PARTICLES = 512
SEED = 2**31 + 21
# Tolerances, each the reason it holds:
# - particles: float32 motion of the same formula from the same sources;
#   check.py's SAME_SOURCE (1e-4 m, rad) is float32 rounding at 100 m
PARTICLE_TOL = 1e-4
# - log weights: the plain likelihood's float32 terms summed in float64
#   against the reference's float64 terms; 1080 terms read ~1.5e-4 nats
#   here, the bfloat16 control ~0.3
LOGLIK_TOL = 1e-3
# - poses: the weighted mean of float32 particles under those weights;
#   the cell's first_pose_gap limit on the 60-beam track (1e-4 m, rad)
POSE_TOL = 1e-4
REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _one_thread_compact_lut(monkeypatch):
    torch.set_num_threads(1)
    monkeypatch.setenv("MCL_LUT_DENSE_MAX", "1")  # the crop takes the compact LUT, as the cell
    TRACER.reset()


def _config() -> dict:
    return spec.config(spec.cell(spec.benchmark(), CELL)["config"])


def _mcl() -> dict:
    return dict(_config()["mcl"], max_particles=PARTICLES)


@pytest.fixture(scope="module")
def crop(tmp_path_factory) -> SimpleNamespace:
    """The crop as a map file pair, and a 24-scan slice of the trace."""
    out = tmp_path_factory.mktemp("headline")
    cfg = _config()
    yaml_path = REPO / cfg["map"]
    meta = yaml.safe_load(yaml_path.read_text())
    with Image.open(yaml_path.parent / meta["image"]) as im:
        img = np.asarray(im.convert("L"))
    trace = dict(np.load(REPO / cfg["trace"]))
    res, (ox, oy) = float(meta["resolution"]), meta["origin"][:2]
    x0, y0 = trace["truth_pose"][0][:2]
    r0 = int((y0 - oy) / res) - CROP // 2  # grid row 0 is the image's last
    c0 = int((x0 - ox) / res) - CROP // 2
    h = img.shape[0]
    Image.fromarray(img[h - r0 - CROP:h - r0, c0:c0 + CROP]).save(out / "crop.png")
    (out / "crop.yaml").write_text(yaml.safe_dump(
        dict(meta, image="crop.png", origin=[ox + c0 * res, oy + r0 * res, 0.0])))
    scans = 24
    last = trace["scan_t"][scans - 1]
    part = dict(trace, scan_t=trace["scan_t"][:scans], scan_ranges=trace["scan_ranges"][:scans])
    for time_key, keys in (("odom_t", ("odom_t", "odom_pose", "odom_twist")),
                           ("truth_t", ("truth_t", "truth_pose"))):
        keep = trace[time_key] <= last
        part.update({k: trace[k][keep] for k in keys})
    np.savez(out / "slice.npz", **part)
    return SimpleNamespace(map=out / "crop.yaml", trace=out / "slice.npz")


@pytest.fixture(scope="module")
def crop_filter(crop):
    """The port's filter and the reference on the crop, at 1080 beams."""
    with pytest.MonkeyPatch.context() as m:
        m.setenv("MCL_LUT_DENSE_MAX", "1")
        mcl = _mcl()
        fields = {f.name for f in dataclasses.fields(MCLConfig)}
        config = MCLConfig(**{k: v for k, v in mcl.items() if k in fields})
        beams = load_trace(crop.trace).beam_angles
        gm = load_map(crop.map, max_range_meters=float(mcl["max_range"]), device="cpu")
        pf = ParticleFilter(gm, config, beam_angles=beams, device="cpu")
    ref = Reference(ref_load_map(crop.map, float(mcl["max_range"])), beams, Params.of(mcl), "cpu")
    return pf, ref


def test_the_crop_reads_a_compact_lut_through_the_warp_form(crop_filter):
    pf, ref = crop_filter
    assert pf.grid_map.lut_row_map is not None  # row-compacted, as the cell's LUT
    assert pf.likelihood.num_beams == 1080 and pf.likelihood.group_lanes == WARP
    assert pf.likelihood.lut_dtype == np.uint8 and pf.likelihood.table_entries > 0


def test_step_many_on_given_draws_matches_the_reference(crop_filter):
    """Each of K = 4 chained corrections against ``Reference.correct`` of
    the state the program left before it: particles, log weights, pose;
    the chain's poses equal the prefixes' (the draws of one correction do
    not leak into the next)."""
    pf, ref = crop_filter
    trace = load_trace(REPO / _config()["trace"])
    g = ref.generator(SEED)
    start = ref.init_cloud("pose", g, trace.truth_pose[0])
    k = 4
    draws = [ref.step_draws(g) for _ in range(k)]
    u0 = torch.stack([d[0] for d in draws])
    noise = torch.stack([d[1] for d in draws])
    actions = torch.as_tensor(scan_actions(trace)[1:k + 1])
    scans = torch.as_tensor(trace.scan_ranges[1:k + 1])
    lw_in = torch.zeros(PARTICLES)
    p_in = start
    runs = [pf.step_many(MCLState(start.clone(), torch.zeros(PARTICLES), torch.Generator()),
                         actions[:j], scans[:j], u0=u0[:j], noise=noise[:j])
            for j in range(1, k + 1)]
    chain_poses = runs[-1][1]
    for j, (state, poses) in enumerate(runs):
        want_p, want_lw, want_pose = ref.correct(p_in, lw_in, actions[j],
                                                 ref.obs_px(trace.scan_ranges[j + 1]),
                                                 u0[j], noise[j])
        gap_xy = float(torch.max(torch.abs(state.particles[:, :2] - want_p[:, :2])))
        assert gap_xy <= PARTICLE_TOL
        assert float(torch.max(angle_gap(state.particles[:, 2], want_p[:, 2]))) <= PARTICLE_TOL
        assert float(torch.max(torch.abs(state.log_weights.double() - want_lw))) <= LOGLIK_TOL
        assert float(torch.max(torch.abs(poses[j, :2].double() - want_pose[:2]))) <= POSE_TOL
        assert float(angle_gap(poses[j, 2], want_pose[2])) <= POSE_TOL
        assert torch.equal(poses[j], chain_poses[j])
        p_in, lw_in = state.particles, state.log_weights


def test_a_trace_slice_through_replay_chained_passes_the_cells_comparison(crop):
    """``MCLNode.replay_chained`` (chunks of 8) as the cell drives it, held
    to the plain reference by the benchmark's comparison under the cell's
    limits."""
    cfg = dict(_config(), map=str(crop.map), trace=str(crop.trace), mcl=_mcl())
    traffic = dict(spec.traffic(spec.cell(spec.benchmark(), CELL)["traffic"]), chunk=8)
    session = Session(cfg, traffic, SEED, "cpu", spec.data_path)
    session.warm()
    window = session.run(0.01)
    records, starts = session.samples()
    assert window == dict(attempted=24, failed=0, updates_per_s=window["updates_per_s"])
    assert [r.steps for r in records] == [8, 8, 8] and len(starts) == 1
    numbers = Comparison(cfg, "replay", SEED, "cpu", spec.data_path).numbers(records, starts)
    ok, lines = verdict(numbers, spec.limits(CELL)["limits"])
    assert ok, lines


@pytest.mark.parametrize("angle_step", [1, 18])
def test_the_references_beam_geometry_is_the_querys(angle_step):
    beams = load_trace(REPO / _config()["trace"]).beam_angles[::angle_step]
    t = theta_bins(beams)
    q = LUTQuery(suggest_theta_bins(beams), beams, height=8, width=8, resolution=0.05796,
                 origin_x=0.0, origin_y=0.0, max_range_px=207,
                 row_stride=required_row_stride(t, beams), z_hit=0.8, z_short=0.01, z_max=0.07,
                 z_rand=0.12, sigma_hit=8.0, inv_squash=1 / 2.2, device="cpu")
    base, offsets = beam_offsets(beams, t)
    assert q.t_bins == t and q.base == base
    assert np.array_equal(q.beam_offsets.numpy(), offsets)


def test_the_configuration_limits_and_cell_load_through_spec():
    bench = spec.benchmark()
    cell = spec.cell(bench, CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == (CONFIG, "replay", 1)
    cfg = spec.config(CONFIG)
    assert cfg["reduced"] == [] and cfg["start"] == "pose"
    assert cfg["mcl"]["angle_step"] == 1 and cfg["mcl"]["max_particles"] == 4000
    assert cfg["mcl"]["raycast_method"] == "lut_pallas"
    assert any("make-trace" in a and "--seed 0" in a for a in cfg["assumed"])
    track = spec.config("f1tenth_track_4000x60")["mcl"]
    assert {k: v for k, v in cfg["mcl"].items() if track[k] != v} == {"angle_step": 1}
    [entry] = [c for c in bench["configs"] if c["name"] == CONFIG]
    assert entry["file"] == f"mcl_bench/configs/{CONFIG}.json" and entry["reduced"] == []
    limits = spec.limits(CELL)
    assert set(limits["limits"]) == set(NUMBERS) - {"particle_gap"}
    assert set(limits["readings"]) == set(limits["limits"])
    for name, limit in limits["limits"].items():
        reading = limits["readings"][name]
        assert reading["lower"] <= limit, name  # the program's readings under every limit
        assert reading["upper"] is None or reading["upper"] > limit, name  # the control's over
    assert limits["readings"]["loglik_gap"]["upper"] > 10 * limits["limits"]["loglik_gap"]
    measured = {m["name"] for m in bench["end_to_end"] + bench["per_layer"]
                if CELL in m.get("workloads", [CELL])}
    assert {"updates_per_s", "setup_s", "likelihood_device_us.replay"} <= measured


def test_the_trace_is_500_full_scans_with_truth_on_free_cells():
    cfg = _config()
    trace = load_trace(REPO / cfg["trace"])
    assert trace.scan_ranges.shape == (500, 1080) and trace.beam_angles.shape == (1080,)
    assert len(trace.odom_t) == 2000 and len(trace.truth_pose) == 2000
    assert np.all(np.isfinite(trace.scan_ranges))
    m = ref_load_map(REPO / cfg["map"], float(cfg["mcl"]["max_range"]))
    free = np.zeros(m.shape, bool)
    free[m.free_cells[:, 0], m.free_cells[:, 1]] = True
    p = trace.truth_pose
    col = np.floor((p[:, 0] - m.origin_x) / m.resolution).astype(np.int64)
    row = np.floor((p[:, 1] - m.origin_y) / m.resolution).astype(np.int64)
    assert np.all((row >= 0) & (row < m.shape[0]) & (col >= 0) & (col < m.shape[1]))
    assert np.all(free[row, col])


def _query(num_beams: int, max_range_px: int = 207, subbin: bool = False) -> LUTQuery:
    beams = np.linspace(-2.356, 2.356, num_beams).astype(np.float32)
    t = suggest_theta_bins(beams)
    itemsize = 1 if max_range_px <= 254 else 2
    return LUTQuery(t, beams, height=8, width=8, resolution=0.05, origin_x=0.0, origin_y=0.0,
                    max_range_px=max_range_px, row_stride=required_row_stride(t, beams, itemsize),
                    z_hit=0.8, z_short=0.01, z_max=0.07, z_rand=0.12, sigma_hit=8.0,
                    inv_squash=1 / 2.2, lut_dtype=np.uint8 if itemsize == 1 else np.uint16,
                    subbin=subbin, device="cpu")


@pytest.mark.parametrize("num_beams, max_range_px, subbin, lanes", [
    (1080, 207, False, WARP),  # the headline: K1's warp a particle
    (60, 207, False, SMALL_GROUP),  # the 60-beam cells: K2's 16 lanes
    (64, 207, True, SMALL_GROUP),  # K3 with its sub-bin table
    (65, 207, False, WARP),  # past kSmallBeams
    (60, 1100, False, WARP),  # the analytic normaliser (past the table's cap)
])
def test_launches_count_by_form(num_beams, max_range_px, subbin, lanes):
    q = _query(num_beams, max_range_px, subbin)
    assert q.group_lanes == lanes
    warp, small = COUNTS.name("lut_loglik.warp"), COUNTS.name("lut_loglik.small_group")
    with COUNTS.recording() as rec:  # three launches' counts, as a capture records them
        for _ in range(3):
            COUNTS.add(COUNTS.name(q.form))
    got = rec.increments
    assert (got.get(warp, 0), got.get(small, 0)) == ((3, 0) if lanes == WARP else (0, 3))


def test_graph_replays_and_the_tracer_carry_the_forms(crop_filter, monkeypatch):
    pf, _ = crop_filter
    assert pf.likelihood.form == "lut_loglik.warp"
    monkeypatch.setattr(COUNTS.name("lut_loglik.warp"), "n", 7)
    monkeypatch.setattr(COUNTS.name("lut_loglik.small_group"), "n", 0)
    summary = TRACER.summary()
    assert summary["lut_loglik.warp"] == {"count": 7}
    assert "lut_loglik.small_group" not in summary  # a count of 0 is left out


def test_the_likelihood_reader_reads_the_device_counter():
    read = spec.reader("likelihood_device_us.replay")
    assert read(SimpleNamespace(mode="replay")) is None  # no sample: nothing to read
    series = TRACER.name("device.likelihood")
    for us in (17, 16, 90, 18, 17):
        TRACER.value(series, us * 1_000)
    assert read(SimpleNamespace(mode="replay")) == pytest.approx(17.0)
    assert read(SimpleNamespace(mode="live")) is None


def test_the_compact_lut_computes_its_row_map_once(crop, monkeypatch):
    """``with_compact_range_lut`` hands the row map it made to
    ``build_compact_range_lut_device`` (the sweep's plain version here: no
    native library), with the bytes of a build that makes its own."""
    from monte_carlo_localization_tpu_torch import native

    monkeypatch.setattr(native, "available", lambda: False)
    calls = []
    made = range_lut_device.compact_row_map

    def counted(*args, **kwargs):
        calls.append(1)
        return made(*args, **kwargs)

    monkeypatch.setattr(range_lut_device, "compact_row_map", counted)
    monkeypatch.setattr(grid_map_module, "compact_row_map", counted)
    gm = load_map(crop.map, device="cpu")
    small = map_from_occupancy(gm.occupancy[:96, :96].numpy(), gm.resolution,
                               max_range_meters=1.5, device="cpu")
    occ = small.occupied.numpy()
    t, stride = 90, 512
    got = small.with_compact_range_lut(t, stride)
    assert got.lut_route == "plain" and len(calls) == 1
    clr = clearance_field(occ, small.max_range_px + FAR_ROW_MARGIN + 2)
    want, row_map = build_compact_range_lut_device(torch.from_numpy(occ), clr, t,
                                                   small.max_range_px, stride)
    assert len(calls) == 2  # the build's own
    assert torch.equal(got.range_lut, want)
    assert np.array_equal(got.lut_row_map.numpy(), row_map)
    assert 0 < row_map.max() < occ.size  # some cells share the far row, some do not
