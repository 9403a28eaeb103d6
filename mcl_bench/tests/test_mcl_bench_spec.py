"""BENCHMARK.json against the benchmark's contract, and the harness's
lookup of each cell's files by name."""

from __future__ import annotations

import re
import shutil
import statistics
import subprocess
import sys

import pytest

from mcl_bench import spec
from mcl_bench.run import forbidden_modules

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = spec.benchmark()


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_the_file_has_the_contract_keys_and_nothing_else():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["mcl_bench"]
    assert BENCH["command"][:3] == ["python3", "-m", "mcl_bench.run"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len(spec.ROOT.joinpath("BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_lines_keep_to_the_contract():
    entries = BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"] + BENCH["per_layer"]
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
    for kind in ("end_to_end", "per_layer"):
        names = [m["name"] for m in BENCH[kind]]
        assert len(names) == len(set(names))
        for m in BENCH[kind]:
            assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["traffic"]) and _line(w["why"]) and w["chips"] in (1, 4)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"]) and len(c["reduced"]) <= 16
        assert c["file"].startswith("mcl_bench/")


@pytest.mark.parametrize("metric", BENCH["end_to_end"], ids=lambda m: m["name"])
def test_end_to_end_metrics_carry_a_bound_and_a_host_or_device_source(metric):
    assert set(metric) <= {"name", "unit", "better", "bound", "source", "workloads"}
    assert 0.01 <= metric["bound"] <= 0.25
    assert metric["source"] in ("host_clock", "device_trace")


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_per_layer_metrics_move_a_metric_their_cells_report(metric):
    assert set(metric) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
    assert _line(metric["layer"])
    for cell in metric["workloads"]:
        reported = [m["name"] for m in spec.metrics_of(BENCH, cell, "end_to_end")]
        assert metric["moves"] in reported, (metric["name"], cell)


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_every_cell_finds_its_files_and_reports_setup_another_metric_and_a_layer(cell):
    e2e = [m["name"] for m in spec.metrics_of(BENCH, cell["name"], "end_to_end")]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert spec.metrics_of(BENCH, cell["name"], "per_layer")
    cfg, traffic = spec.config(cell["config"]), spec.traffic(cell["traffic"])
    assert spec.data_path(cfg["map"]).exists() and spec.data_path(cfg["trace"]).exists()
    assert traffic["mode"] in ("replay", "live")
    drv = spec.driver(traffic)
    assert callable(drv.Session) and callable(drv.Comparison)
    limits = spec.limits(cell["name"])["limits"]
    assert limits and all(v >= 0 for v in limits.values())
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert callable(spec.reader(m["name"]))


def test_configs_are_used_and_pairs_appear_once():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(pairs) // 4)


def test_a_new_metric_file_is_found_without_an_edit(tmp_path, monkeypatch):
    copy = tmp_path / "mcl_bench"
    shutil.copytree(spec.HERE, copy, ignore=shutil.ignore_patterns("__pycache__"))
    (copy / "metrics" / "episodes.replay.py").write_text(
        "def read(run):\n    return run.window.get('episodes')\n")
    monkeypatch.setattr(spec, "HERE", copy)
    read = spec.reader("episodes.replay")

    class Run:
        window = {"episodes": 7}

    assert read(Run) == 7
    assert spec.traffic("replay")["mode"] == "replay"


def test_a_mix_finds_its_driver_by_name_without_an_edit(tmp_path, monkeypatch):
    copy = tmp_path / "mcl_bench"
    shutil.copytree(spec.HERE, copy, ignore=shutil.ignore_patterns("__pycache__"))
    (copy / "drivers" / "fleet.py").write_text(
        "class Session:\n    kind = 'fleet'\n\n\nclass Comparison:\n    pass\n")
    (copy / "traffic" / "fleet_mix.json").write_text('{"mode": "replay", "driver": "fleet"}')
    monkeypatch.setattr(spec, "HERE", copy)
    assert spec.driver(spec.traffic("fleet_mix")).Session.kind == "fleet"
    from mcl_bench.generator import Session

    assert spec.driver(spec.traffic("replay")).Session is Session


def test_the_check_for_jax_compares_whole_top_level_names():
    assert forbidden_modules(["monte_carlo_localization_tpu_torch", "numpy", "torch.cuda",
                              "monte_carlo_localization_tpu_torch.filter.core"]) == []
    assert forbidden_modules(["jax.numpy", "jaxlib", "flax.linen"]) == ["flax", "jax", "jaxlib"]
    assert forbidden_modules(["monte_carlo_localization_tpu.filter"]) == [
        "monte_carlo_localization_tpu"]


def test_the_harness_loads_no_jax_and_the_reference_nothing_of_the_program():
    code = (
        "import sys\n"
        "import mcl_bench.reference.model, mcl_bench.check\n"
        "assert not any(m.split('.')[0].startswith('monte_carlo') for m in sys.modules), 'ref'\n"
        "import mcl_bench.run, mcl_bench.generator, mcl_bench.calibrate\n"
        "import monte_carlo_localization_tpu_torch.runtime.node\n"
        "from mcl_bench.run import forbidden_modules\n"
        "assert forbidden_modules() == [], forbidden_modules()\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr


def test_bounds_follow_the_quartile_spread_rule():
    # statistics.quantiles(n=4) is the spread the bounds are read with
    q1, _, q3 = statistics.quantiles([10.0, 11.0, 12.0, 13.0, 14.0, 15.0], n=4)
    assert (q1, q3) == (10.75, 14.25)
