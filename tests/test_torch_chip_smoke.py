"""``chip_smoke.py`` on a machine without a card: it refuses to run,
prints no result and imports nothing of JAX; its bounds count the
operations the kernels' beam term needs and the bytes a LUT build
moves; a path's LUT must come from the sweep kernel (the long-line
corridor's and hall's too), and the oracle of the card
builds rebuilds every kind of LUT; ``fleet_live`` runs bench.py's fleet
live workload; ``runtime_io``'s bag gate passes a real round trip and
catches a changed one."""

import dataclasses
import inspect
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402


def test_chip_smoke_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the script would run in full")
    probe = ("import runpy, sys\n"
             "try:\n"
             "    runpy.run_path('chip_smoke.py', run_name='__main__')\n"
             "except SystemExit as e:\n"
             "    assert 'jax' not in sys.modules, 'chip_smoke.py imported jax'\n"
             "    sys.exit(e.code)\n")
    res = subprocess.run([sys.executable, "-c", probe], cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 2, res.stderr
    assert res.stdout == "" and "no CUDA device" in res.stderr


@pytest.mark.parametrize("subbin, ops_beam", [(False, chip_smoke.OPS_PER_BEAM_TABLED),
                                              (True, chip_smoke.OPS_PER_BEAM_SUBBIN + chip_smoke.OPS_PER_LERP)])
def test_lut_bound_counts_the_term_the_kernel_evaluates(subbin, ops_beam):
    """A tabled term is one exp, one log and a table read; the sub-bin
    lerp reads its table's cubic segment and computes the reciprocal, and
    only a range past the tables' cap pays the analytic normaliser's two
    erf."""
    n, n_on, r = 4000, 3000, 60
    b = chip_smoke.lut_bound(n, n_on, r, 1, False, subbin=subbin, sectors=1000)
    assert b["f32_ops"] == n * chip_smoke.OPS_PER_PARTICLE_K1 + n_on * r * ops_beam
    assert b["f64_ops"] == n_on * r
    assert b["bytes"] == 16 * n + 8 * r + n_on * r * (2 if subbin else 1)
    assert b["sector_bytes"] == 1000 * chip_smoke.SECTOR_BYTES
    assert (chip_smoke.OPS_PER_BEAM_TABLED < chip_smoke.OPS_PER_BEAM_SUBBIN
            < chip_smoke.OPS_PER_BEAM_ANALYTIC)


def test_bound_is_the_larger_of_bytes_and_operations():
    by_bytes = chip_smoke.bound(3.35e9, 1.0, 0.0)
    assert by_bytes["bound_by"] == "bytes" and by_bytes["bound_ms"] == pytest.approx(1.0)
    by_ops = chip_smoke.bound(1.0, 67e9, 34e9)
    assert by_ops["bound_by"] == "operations" and by_ops["bound_ms"] == pytest.approx(2.0)
    mega = chip_smoke.mega_bound(4000, 4000, 60, 1)
    assert mega["f32_ops"] > 4000 * 60 * chip_smoke.OPS_PER_BEAM_TABLED
    assert mega["f64_ops"] == 4000 * 60 + 7 * 4000


def test_knife_edge_ranges_hold_every_half_pixel_and_its_neighbours():
    r = chip_smoke.knife_edge_ranges(0.05, 240, 10_000, seed=1)
    assert r.dtype == np.float32 and r.shape == (10_000,)
    half = ((np.arange(241) + 0.5) * 0.05).astype(np.float32)
    up1 = np.nextafter(half, np.float32(np.inf))
    down2 = np.nextafter(np.nextafter(half, np.float32(0)), np.float32(0))
    for edge in (half, up1, down2):
        assert np.isin(edge, r).all()
    assert r.min() >= 0 and r.max() <= 1.05 * 240 * 0.05


@pytest.mark.parametrize("phase, constant, value", [
    ("phase_cli_replay", "CLI_RMSE_MAX", 0.075),
    ("phase_u16_basement", "U16_RMSE_MAX", 0.064),
    ("phase_live", "LIVE_POSE_TOL", 0.15),
    ("phase_inject", "INJECT_RMSE_MAX", 0.075),
    ("phase_methods", "METHODS_RMSE_MAX", 0.075),
    ("phase_runtime_io", "CLI_RMSE_MAX", 0.075),
])
def test_runtime_phases_gate_on_their_constants(phase, constant, value):
    """The runtime phases' gates read their thresholds from the module's
    constants, not from literals in the phase."""
    assert getattr(chip_smoke, constant) == value
    src = inspect.getsource(getattr(chip_smoke, phase))
    assert f"<= {constant}" in src
    assert str(value) not in src


@pytest.mark.parametrize("compact", [False, True], ids=["dense", "compact"])
def test_sweep_bound_counts_each_input_once_and_the_stored_rows(compact):
    cells, stride, rel, rows = 2000 * 2000, 3072, 3_000_000, 3_000_000
    b = chip_smoke.sweep_bound(cells, stride, rel, rows, 1, compact)
    written = rows * stride
    assert b["write_bytes"] == written
    assert b["bytes"] == cells * (5 if compact else 1) + rel + 8 * stride + written
    assert b["f32_ops"] == cells * stride * chip_smoke.OPS_PER_SWEEP_ENTRY
    assert b["write_bound_ms"] == pytest.approx(written / chip_smoke.HBM_BYTES_PER_S * 1e3)
    assert b["bound_by"] == "bytes" and b["bound_ms"] >= b["write_bound_ms"]
    # a map of mostly far cells sweeps every cell but stores few rows
    assert chip_smoke.sweep_bound(cells, stride, rel, 1000, 1, compact)["bound_by"] == "operations"


def test_a_path_lut_must_come_from_the_sweep_kernel(monkeypatch):
    from types import SimpleNamespace

    from monte_carlo_localization_tpu_torch.ops.range_lut_sweep import sweep

    monkeypatch.setattr(chip_smoke, "SWEEP_LAUNCHES", {})
    lut = torch.zeros(8, dtype=torch.uint8)
    chip_smoke.sweep_reset()
    with pytest.raises(RuntimeError, match="want the kernel"):
        chip_smoke.lut_built_on_card("x", SimpleNamespace(lut_route="native", lut_build_s=1.0,
                                                          range_lut=lut))
    monkeypatch.setattr(sweep, "launch_count", 4)
    got = chip_smoke.lut_built_on_card("y", SimpleNamespace(lut_route="kernel", lut_build_s=0.5,
                                                            range_lut=lut))
    assert got == dict(lut_route="kernel", lut_build_s=0.5, sweep_launches=4, lut_bytes=8)
    assert chip_smoke.SWEEP_LAUNCHES == {"y": 4}


def test_native_oracle_rebuilds_every_lut_kind(monkeypatch):
    """``native_lut``, the oracle of the card builds, gives back the LUT a
    map carries when that LUT came from the sweep (here its plain version):
    dense and compact, one map and tight member blocks; a member block at
    a wrong base is caught."""
    from monte_carlo_localization_tpu_torch import native
    from monte_carlo_localization_tpu_torch.mapping import map_from_occupancy
    from monte_carlo_localization_tpu_torch.parallel import stack_maps

    rng = np.random.default_rng(3)
    occ = np.where(rng.random((48, 64)) < 0.05, 100, 0).astype(np.int8)
    occ[[0, -1]], occ[:, [0, -1]] = 100, 100
    gm = map_from_occupancy(occ, resolution=0.05, max_range_meters=0.9, device="cpu")
    fleet = stack_maps([gm, map_from_occupancy(occ[:40, :50], resolution=0.05,
                                               max_range_meters=0.9, device="cpu")])
    monkeypatch.setattr(native, "available", lambda: False)
    built = [gm.with_range_lut(90, row_stride=1024, use_cache=False),
             gm.with_compact_range_lut(90, 1024),
             fleet.with_member_luts(90, 1024, 512, use_cache=False),
             fleet.with_member_compact_luts(90, 1024, 512)]
    monkeypatch.undo()
    for m in built:
        assert m.lut_route == "plain"
        np.testing.assert_array_equal(chip_smoke.native_lut(m), m.range_lut.numpy())
    shifted = built[3].lut_member_base.clone()
    shifted[1] += 1
    with pytest.raises(RuntimeError, match="member LUT bases"):
        chip_smoke.native_lut(dataclasses.replace(built[3], lut_member_base=shifted))


@pytest.mark.parametrize("route", ["native", "plain", ""])
def test_card_vs_native_checks_the_route(route):
    from types import SimpleNamespace

    with pytest.raises(RuntimeError, match="want 'kernel'"):
        chip_smoke.card_vs_native("x", SimpleNamespace(lut_route=route))


@pytest.mark.parametrize("name", ["LONG_LINE_MAP", "LONG_LINE_HALL"])
def test_long_line_maps_pass_the_shared_line_limit_on_one_side(name):
    """The corridor and the hall have rows past MAX_LINE_CELLS (the
    kernel keeps their D in global memory) and columns within it."""
    from monte_carlo_localization_tpu_torch.ops.range_lut_sweep import (
        MAX_LINE_CELLS,
        line_layout,
    )

    h, w = getattr(chip_smoke, name)["height"], getattr(chip_smoke, name)["width"]
    assert w == 15_000 and h in (64, 2048) and h <= MAX_LINE_CELLS < w
    assert line_layout(w)[1] and not line_layout(h)[1]


def test_fleet_live_runs_bench_fleet_live_workload():
    """The phase runs bench.py ``bench_fleet_live``'s defaults (async depth
    4, an 8 s window) on config #5's maps, and its source holds the gates:
    drift over harvested + depth corrections, twice config #1's RMSE gate
    for the standing cars, one fleet launch per dispatch and no
    single-filter launch."""
    import re

    bench = (REPO / "bench.py").read_text()
    sig = re.search(r"def bench_fleet_live\(([^)]*)\)", bench).group(1)
    assert "async_depth=4" in sig and "duration_s=8.0" in sig
    assert (chip_smoke.FLEET_LIVE_DEPTH, chip_smoke.FLEET_LIVE_SECONDS) == (4, 8.0)
    assert chip_smoke.CONFIG5_FLEET == 64 and len(chip_smoke.CONFIG5_MAPS) == 4
    src = inspect.getsource(chip_smoke.phase_fleet_live)
    assert "harvested + FLEET_LIVE_DEPTH" in src
    assert chip_smoke.FLEET_STATIONARY_ERR_M == 2 * chip_smoke.CONFIG1_RMSE_MAX == 0.15
    assert "err.max() < FLEET_STATIONARY_ERR_M" in src
    assert "q.fleet_launch_count == node.dispatched and q.launch_count == 0" in src


def test_bag_roundtrip_gate(tmp_path):
    """``runtime_io``'s gate passes config #1's real round trip and fails
    a trace whose scans changed."""
    import dataclasses as dc

    from monte_carlo_localization_tpu_torch.runtime.rosbag import export_bag, import_bag
    from monte_carlo_localization_tpu_torch.runtime.trace import Trace

    orig = Trace.load(REPO / chip_smoke.CONFIG1_TRACE)
    back = import_bag(export_bag(orig, tmp_path / "bag"), map_name=orig.map_name)
    errs = chip_smoke.bag_roundtrip_errors(orig, back)
    assert errs["time_s"] <= chip_smoke.BAG_TIME_TOL and errs["yaw_rad"] <= chip_smoke.BAG_YAW_TOL
    assert 0 < errs["beam_angle_rad"] <= chip_smoke.BAG_BEAM_TOL
    scans = back.scan_ranges.copy()
    scans[3, 7] = np.nextafter(scans[3, 7], np.float32(np.inf))
    with pytest.raises(RuntimeError, match="changed scan_ranges"):
        chip_smoke.bag_roundtrip_errors(orig, dc.replace(back, scan_ranges=scans))


def test_result_line_is_rank_zero_s_one_result():
    assert chip_smoke.result_line(["noise\nRESULT {\"a\": 1}\n", "RESULT {}"]) == {"a": 1}
    for outs in (["no result"], ["RESULT {}\nRESULT {}"]):
        with pytest.raises(RuntimeError, match="result lines"):
            chip_smoke.result_line(outs)


def test_host_cpu_names_its_cores():
    assert chip_smoke.host_cpu().endswith("logical cores")


def _jax_line_keys(fn: str, which: int = 0) -> set[str]:
    """The keywords of the ``which``-th ``dict(metric=...)`` line that
    ``fn`` of the JAX harness (bench.py) builds."""
    import ast

    tree = ast.parse((REPO / "bench.py").read_text())
    body = next(n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef) and n.name == fn)
    calls = sorted((n for n in ast.walk(body)
                    if isinstance(n, ast.Call) and getattr(n.func, "id", None) == "dict"
                    and any(k.arg == "metric" for k in n.keywords)), key=lambda n: n.lineno)
    return {k.arg for k in calls[which].keywords if k.arg}


@pytest.mark.parametrize("kind, fn, which, extra", [
    ("updates", "run_config", 0, set()), ("updates", "run_headline", 0, set()),
    ("million", "run_million", 0, set()), ("converge", "run_million", 1, set()),
    ("converge", "run_converge", 0, set()), ("fleet", "run_fleet_giant", 0, {"lut_bytes"}),
    ("kidnap", "run_kidnap", 0, set()), ("live", "run_live", 0, set()),
])
def test_bench_phase_gates_on_the_jax_harness_keys(kind, fn, which, extra):
    """The ``bench`` phase holds each line to the keys of the JAX
    harness's line of the same workload (``lut_bytes`` comes through
    bench_fleet's ``info``)."""
    assert chip_smoke.BENCH_LINES[kind][0] == _jax_line_keys(fn, which) | extra
    assert set(chip_smoke.BENCH_LINES[kind][1]) <= chip_smoke.BENCH_LINES[kind][0]


def test_bench_phase_runs_the_million_workload_at_full_width():
    """1,000,000 particles, as bench.py ``run_million`` (chain 10, reps 2),
    cut in depth only: 2 rounds and 2 convergence trials of at most 60
    updates; the other workloads at their own widths."""
    src = inspect.getsource(chip_smoke.phase_bench)
    jax_src = inspect.getsource(__import__("bench").run_million)
    assert chip_smoke.BENCH_MILLION == 1_000_000 and "1_000_000" in jax_src
    assert "chain=10, reps=2" in jax_src
    assert ("bench.bench_updates(BENCH_MILLION, 60, gm, chain=10, reps=2,\n"
            "                                  rounds=BENCH_MILLION_ROUNDS, setup=setup)") in src
    assert "setup = bench._build_single(BENCH_MILLION, 60, gm)" in src
    assert 'k2_compare(pf, moved.particles, scan, "1M")' in src
    assert "bench.bench_convergence(BENCH_MILLION, 60, gm, trials=BENCH_MILLION_TRIALS," in src
    assert chip_smoke.BENCH_MILLION_ROUNDS == chip_smoke.BENCH_MILLION_TRIALS == 2
    assert chip_smoke.BENCH_MEGA_AB == dict(particles=4000, beams=1080, chain=50, reps=2, rounds=2)
    assert chip_smoke.BENCH_MEGA_LUT_BYTES == 2000 * 2000 * 3072
    for call in ("bench.run_config(2, quick=True", "bench.run_fleet_giant(quick=True",
                 "bench.run_kidnap(quick=True", "bench.run_live(quick=True",
                 "bench.run_headline(quick=True, synthetic=True"):
        assert call in src


def test_bench_launches_hold_kernels_to_corrections(monkeypatch):
    from monte_carlo_localization_tpu_torch import bench

    monkeypatch.setattr(bench, "LAUNCHES", bench.collections.Counter())
    bench.LAUNCHES.update(lut_loglik=12, corrections=12, lut_loglik_fleet=0)
    assert chip_smoke.bench_launches("ok")["lut_loglik"] == 12
    for bad in (dict(lut_loglik=11, corrections=12), dict(lut_loglik=12, corrections=12,
                                                          mega_step=1),
                dict(lut_loglik=0, corrections=0)):
        bench.LAUNCHES.clear()
        bench.LAUNCHES.update(bad)
        with pytest.raises(RuntimeError, match="chip_smoke"):
            chip_smoke.bench_launches("bad")
    bench.LAUNCHES.clear()
    bench.LAUNCHES.update(lut_loglik_fleet=7, fleet_corrections=7)
    assert chip_smoke.bench_launches("fleet", single=False)["fleet_corrections"] == 7


def test_bench_phase_holds_each_kernel_at_its_workload_s_shape():
    """K2 is held to its plain version on a config #2 filter (sibal1 at
    max_range_px 239, as both packages load it) and on the 1M filter's
    particles; the giant fleet's kernel on all of its members' particles."""
    from monte_carlo_localization_tpu.mapping import load_map as jload_map
    from monte_carlo_localization_tpu_torch import bench

    path = REPO / "maps" / bench.CONFIG_MAPS[2]
    assert (chip_smoke.BENCH_SIBAL1_RANGE_PX == bench._load_real_map(
        bench.CONFIG_MAPS[2], device="cpu").max_range_px == jload_map(path).max_range_px == 239)
    src = inspect.getsource(chip_smoke.phase_bench)
    assert 'k2_compare(pf, state.particles, scan, "config #2 (sibal1)")' in src
    assert "parts = state.particles.reshape(-1, 3).contiguous()" in src
    assert 'k2_max_abs_err=max(k2_config2["max_abs_err"], k2_1m["max_abs_err"])' in src
    assert 'bench_run["k2_max_abs_err"]' in inspect.getsource(chip_smoke.main)


def _held(equal=True, step=None):
    return dict(equal=equal, replay_equal=True, no_aliasing=True, first_differing_step=step,
                max_abs_pose_diff=0.0, launches=dict(eager=3, graph=3, replay=3, corrections=3))


def test_the_graphs_phase_runs_and_gates_graph_against_eager(monkeypatch):
    """``main`` runs the graphs phase, which refuses a program whose
    graph is not ``torch.equal`` to its eager run, names the first
    differing step, and gates launches against corrections."""
    assert "phase_graphs(device)" in inspect.getsource(chip_smoke.main)
    assert "torch.equal" in inspect.getsource(chip_smoke.hold_graph_to_eager)
    monkeypatch.setattr(chip_smoke, "emit", lambda *a, **k: None)
    monkeypatch.setattr(chip_smoke, "graph_cells", lambda device: {})
    programs = {"classic_K2": dict(given_draws=_held(), generator_draws=_held(False, 4)),
                "mega_cooperative": dict(given_draws=_held(), generator_draws=_held(), graphs=2),
                "inject_step": dict(given_draws=_held(), generator_draws=_held(), programs=2)}
    monkeypatch.setattr(chip_smoke, "graph_programs", lambda device: programs)
    with pytest.raises(RuntimeError, match=r"classic_K2 \(generator_draws\) differs from eager "
                                           r"from step 4"):
        chip_smoke.phase_graphs("cpu")
    programs["classic_K2"]["generator_draws"] = _held()
    assert chip_smoke.phase_graphs("cpu")["programs"] is programs
    programs["classic_K2"]["given_draws"]["launches"]["graph"] = 2
    with pytest.raises(RuntimeError, match="launches"):
        chip_smoke.phase_graphs("cpu")
    programs["classic_K2"]["given_draws"]["launches"]["graph"] = 3
    # a sharded program must call the collectives eager calls, and be a graph
    held = dict(given_draws=_held(), generator_draws=_held(), graphs=2)
    held["given_draws"]["collectives"] = dict(eager=[96, 12816], graph=[96, 12816],
                                              replay=[96, 12816])
    programs["sharded_nccl_step_many"] = held
    assert chip_smoke.phase_graphs("cpu")["programs"] is programs
    held["given_draws"]["collectives"]["replay"] = [95, 12816]
    with pytest.raises(RuntimeError, match="collective calls and bytes"):
        chip_smoke.phase_graphs("cpu")
    held["given_draws"]["collectives"]["replay"] = [96, 12816]
    held["graphs"] = 0
    with pytest.raises(RuntimeError, match="captured 0 graphs"):
        chip_smoke.phase_graphs("cpu")


def test_holding_a_program_to_eager_compares_every_output(monkeypatch):
    """On the CPU both runs are eager, so they agree; the comparison
    covers poses, particles, weights, quality and the generator."""
    from monte_carlo_localization_tpu_torch import MCLConfig, ParticleFilter
    from monte_carlo_localization_tpu_torch.mapping.synthetic import random_obstacle_world

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    torch.set_num_threads(1)
    pf = ParticleFilter(random_obstacle_world(seed=3, device="cpu"), MCLConfig(max_particles=32),
                        beam_angles=np.linspace(-2.3, 2.3, 60).astype(np.float32))
    acts, scans = np.zeros((3, 3), np.float32), np.full((3, 60), 2.0, np.float32)
    rng = np.random.default_rng(0)
    draws = dict(u0=rng.random(3, dtype=np.float32),
                 noise=rng.standard_normal((3, 32, 3), dtype=np.float32))
    res = chip_smoke.hold_graph_to_eager(
        lambda: pf.init_pose(np.float32([10, 10, 0.5]), seed=1),
        lambda s, d: pf.step_many(s, acts, scans, **d), draws, [pf.likelihood], 3)
    for kind in ("given_draws", "generator_draws"):
        r = res[kind]
        assert r["equal"] and r["replay_equal"] and r["no_aliasing"]
        assert r["first_differing_step"] is None and r["max_abs_pose_diff"] == 0.0
        assert r["launches"] == dict(eager=0, graph=0, replay=0, corrections=3)  # plain on the CPU


def test_holding_a_sharded_program_to_eager_compares_both_generators(monkeypatch):
    """A sharded state has two generators: a run that leaves the motion
    generator elsewhere than eager did is refused; the collectives' calls
    and bytes of each call are counted (none in a one-shard world)."""
    from monte_carlo_localization_tpu_torch import MCLConfig
    from monte_carlo_localization_tpu_torch.mapping.synthetic import random_obstacle_world
    from monte_carlo_localization_tpu_torch.parallel import ShardedParticleFilter

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    torch.set_num_threads(1)
    spf = ShardedParticleFilter(random_obstacle_world(seed=3, device="cpu"),
                                MCLConfig(max_particles=32),
                                beam_angles=np.linspace(-2.3, 2.3, 60).astype(np.float32))
    acts, scans = np.zeros((3, 3), np.float32), np.full((3, 60), 2.0, np.float32)
    calls = []

    def run(s, d):
        calls.append(d)
        s, p = spf.step_many(s, acts, scans, **d)
        if len(calls) == 2:  # the first graphed call of the given draws: one draw more
            torch.rand((), generator=s.motion_generator)
        return s, p

    rng = np.random.default_rng(0)
    draws = dict(u0=rng.random(3, dtype=np.float32),
                 noise=rng.standard_normal((3, 32, 3), dtype=np.float32))
    res = chip_smoke.hold_graph_to_eager(lambda: spf.init_global(seed=1), run, draws,
                                         [spf.likelihood], 3, [spf.comm])
    assert not res["given_draws"]["equal"] and not res["given_draws"]["replay_equal"]
    assert res["given_draws"]["max_abs_pose_diff"] == 0.0  # only the motion generator moved
    assert res["generator_draws"]["equal"] and res["generator_draws"]["replay_equal"]
    assert res["generator_draws"]["collectives"] == dict(eager=[0, 0], graph=[0, 0],
                                                         replay=[0, 0])


SASS = """
	code for sm_90a
		Function : _ZN12_GLOBAL__N_127probe_philox_normals_kernelENS_10PhiloxKeysElPfP5uint4
	.headerflags	@"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                 /* 0x00000a00ff017b82 */
                                                                          /* 0x000fe40000000800 */
        /*0010*/                   IMAD.WIDE.U32 R2, R8, -0x2daee0ad, RZ ; /* 0x000000000000 */
        /*0020*/               @P0 MUFU.COS R3, R4 ;                      /* 0x000000000000 */
        /*0030*/              @!P1 BRA 0xb00 ;                            /* 0x000000000000 */
		Function : _ZN12_GLOBAL__N_126probe_staged_writes_kernelEiiffffPf
        /*0000*/                   EXIT ;                                 /* 0x000000000000 */
		Function : _ZN12_GLOBAL__N_124probe_gather_rows_kernelILb1EEEvPK6float4iiPKiiPS1_
        /*0000*/                   LDG.E.128.CONSTANT R4, desc[UR6][R2.64] ; /* 0x0000 */
        /*0010*/                   STG.E.128 desc[UR6][R6.64], R4 ;       /* 0x000000000000 */
        /*0020*/                   NOP;                                   /* 0x000000000000 */
"""


def test_sass_counts_reads_each_named_kernel(monkeypatch):
    """The probes phase's instruction counts: every instruction of each
    named kernel once (a predicate does not hide its opcode), the
    encoding's second word not at all, other kernels left out."""
    import monte_carlo_localization_tpu_torch.ops._cuda_build as build

    seen = []

    def run(cmd, **kw):
        seen.append(cmd)
        return subprocess.CompletedProcess(cmd, 0, SASS, "")

    monkeypatch.setattr(build, "nvcc_path", lambda: "/opt/cuda/bin/nvcc")
    monkeypatch.setattr(chip_smoke.subprocess, "run", run)
    counts = chip_smoke.sass_counts(Path("libprobes.so"))
    assert seen == [["/opt/cuda/bin/cuobjdump", "-sass", "libprobes.so"]]
    normals, gather = sorted(counts, key=lambda k: "gather" in k)
    assert "probe_philox_normals_kernel" in normals and "gather_rows" in gather
    assert counts[normals] == {"total": 4, "IMAD.WIDE.U32": 1, "MUFU": 1, "BRA": 1}
    assert counts[gather] == {"total": 3, "LDG": 1, "STG": 1}


@pytest.mark.parametrize("f, n, m, adds", [(1, 4000, 4000, 43_905), (64, 4000, 4000, 64 * 43_905),
                                           (1, 1, 1, 0), (1, 2, 3, 1), (3, 33, 16, 3 * 135)])
def test_resample_bound_counts_each_byte_once_and_the_doubling_s_adds(f, n, m, adds):
    """Weights and offsets read, indices written; n - s double adds in
    each round s = 1, 2, 4, ... < n of the doubling (n = 33: 32 + 31 +
    29 + 25 + 17 + 1 = 135 over s = 1..32)."""
    b = chip_smoke.resample_bound(f, n, m)
    assert b["bytes"] == 4 * f * n + 4 * f + 4 * f * m
    assert b["f64_ops"] == adds
    assert b["f32_ops"] == 2 * f * n


@pytest.mark.parametrize("f, n", [(1, 4000), (64, 4000), (1, 14_528), (1, 1)])
def test_motion_bound_counts_each_byte_once_and_the_operations(f, n):
    """Particles, indices and noise read once a particle, the actions once
    a row, the proposal written once; the kernel's operations a particle."""
    b = chip_smoke.motion_bound(f, n)
    assert b["bytes"] == 40 * f * n + 12 * f
    assert b["f32_ops"] == chip_smoke.OPS_PER_PARTICLE_MOTION * f * n
    assert b["f64_ops"] == 0
    assert b["bound_by"] == "bytes"


@pytest.mark.parametrize("f, n", [(1, 4000), (64, 4000), (1, 1_000_000), (1, 1)])
def test_normalize_pose_bound_counts_each_byte_once_and_the_operations(f, n):
    """Log weights and particles read once, the shifted weights written
    once, the log quality and the pose once a row; the kernel's float32
    and float64 operations an element."""
    b = chip_smoke.normalize_pose_bound(f, n)
    assert b["bytes"] == 20 * f * n + 16 * f
    assert b["f32_ops"] == chip_smoke.OPS_PER_ELEMENT_NORMALIZE_F32 * f * n
    assert b["f64_ops"] == chip_smoke.OPS_PER_ELEMENT_NORMALIZE_F64 * f * n
    assert b["bound_by"] == "bytes"


@pytest.mark.parametrize("launches, plain, ok", [(500, 0, True), (499, 0, False),
                                                 (500, 1, False)])
def test_normalize_launches_gate_one_kernel_launch_a_correction(launches, plain, ok):
    from monte_carlo_localization_tpu_torch.ops.normalize_pose import NORMALIZE_POSE_KERNEL

    chip_smoke.zero_motion()
    NORMALIZE_POSE_KERNEL.launch_count, NORMALIZE_POSE_KERNEL.plain_launch_count = launches, plain
    try:
        if ok:
            assert chip_smoke.normalize_launches(500, "config #1") == 500
        else:
            with pytest.raises(RuntimeError, match="normalize_pose launches"):
                chip_smoke.normalize_launches(500, "config #1")
    finally:
        chip_smoke.zero_motion()
