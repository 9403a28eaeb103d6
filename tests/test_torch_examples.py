"""The port's tools ``tools/mega_ab.py`` and ``tools/perf_ablate.py`` and
its three examples at tiny sizes on the CPU: each runs to its own gate
(tracking, convergence, lock), reports what its JAX counterpart prints,
and takes ``--device``; the options with no counterpart on the port exit
or are absent, saying why."""

import os

import pytest
import torch

from monte_carlo_localization_tpu_torch.examples import fleet_live_loop, fleet_racing, localize_on_map
from monte_carlo_localization_tpu_torch.tools import mega_ab, perf_ablate

MAP1 = "map_1753950572.yaml"


@pytest.fixture(autouse=True)
def _one_thread_private_lut_cache(monkeypatch, tmp_path):
    torch.set_num_threads(1)
    monkeypatch.setenv("MCL_LUT_CACHE", str(tmp_path / "lut_cache"))


def test_mega_ab_runs_both_arms_on_one_dense_lut(capsys):
    before = os.environ.get("MCL_LUT_DENSE_MAX")
    out = mega_ab.run(particles=64, beams=60, chain=3, reps=1, rounds=2, map_name=MAP1,
                      device="cpu")
    assert os.environ.get("MCL_LUT_DENSE_MAX") == before  # restored after the build
    arms = out["arms"]
    assert list(arms) == ["classic", "mega"]
    assert arms["classic"]["filter"].grid_map is arms["mega"]["filter"].grid_map
    assert arms["mega"]["filter"].mega is not None and arms["classic"]["filter"].mega is None
    lut = arms["classic"]["filter"].grid_map.range_lut
    assert out["lut_bytes"] == lut.numel() * lut.element_size()
    for arm in arms.values():
        assert len(arm["rates"]) == 2 and arm["spread"]["rounds"] == 2
        assert arm["corrections"] == 3 + 2 * 3 + 1
        assert arm["err_m"] < mega_ab.TRACK_M
    assert mega_ab.main(["--device", "cpu", "--map", MAP1, "--particles", "64", "--beams", "60",
                         "--chain", "2", "--reps", "1", "--rounds", "1"]) == 0
    printed = capsys.readouterr().out
    assert "still tracking" in printed and "mega / classic" in printed


def test_mega_ab_refuses_a_compact_lut(monkeypatch):
    """The mega step reads dense LUTs only: a caller's MCL_LUT_DENSE_MAX
    that makes the map compact stops the A/B before any arm runs."""
    monkeypatch.setenv("MCL_LUT_DENSE_MAX", "1")
    with pytest.raises(ValueError, match="COMPACT"):
        mega_ab.run(particles=16, beams=60, chain=1, reps=1, rounds=1, map_name=MAP1,
                    device="cpu")
    assert os.environ["MCL_LUT_DENSE_MAX"] == "1"


def test_mega_ab_has_no_mega_blocks():
    """``--mega-blocks`` capped TPU blocks; the port's launcher sizes its
    grid from the work, so the option is not there."""
    with pytest.raises(SystemExit) as e:
        mega_ab.main(["--mega-blocks", "0", "--device", "cpu"])
    assert e.value.code == 2
    assert "pick_block" in mega_ab.__doc__


def test_perf_ablate_runs_the_six_variants(capsys):
    out = perf_ablate.run(particles=64, beams=60, chain=3, reps=1, map_name=MAP1, device="cpu")
    assert list(out["median"]) == list(perf_ablate.VARIANTS) == [
        "full", "no_pose", "no_resample", "no_motion", "kernel_only", "no_kernel"]
    assert all(len(r) == perf_ablate.ROUNDS and min(r) > 0 for r in out["rates"].values())
    assert set(out["marginal_ms"]) == {"pose", "resample", "motion", "kernel"}
    assert out["kernel_corrections"] == 5 * 3 * (1 + perf_ablate.ROUNDS)
    assert out["query"].launch_count == 0  # the plain version on the CPU
    assert out["capture"] == {name: {} for name in perf_ablate.VARIANTS}  # eager on the CPU
    # --unroll U: the corrections-per-replay sweep, one line per u
    assert perf_ablate.main(["--unroll", "4", "--device", "cpu", "--particles", "64",
                             "--beams", "60", "--chain", "4", "--reps", "1",
                             "--map", MAP1]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split()[0] for ln in lines] == ["full_unroll1", "full_unroll2", "full_unroll4"]
    assert all("updates/s" in ln for ln in lines)


def test_localize_on_map_converges():
    out = localize_on_map.run(particles=1000, device="cpu", log=lambda s: None)
    assert out["err_m"] < localize_on_map.CONVERGED_M
    assert out["filter"].config.raycast_method == "lut"


def test_fleet_racing_localizes_every_car():
    lines = []
    out = fleet_racing.run(fleet=4, device="cpu", log=lines.append)
    assert out["err_m"].shape == (4,) and out["err_m"].max() < fleet_racing.LOCALIZED_M
    assert lines[-1] == "fleet OK" and "sibal1" in lines[0]


def test_fleet_live_loop_keeps_every_lock():
    out = fleet_live_loop.run(fleet=2, particles=128, seconds=1.0, device="cpu",
                              log=lambda s: None)
    assert out["corrections"] >= 1 and out["ticks"] >= out["corrections"]
    assert out["err_m"].max() < fleet_live_loop.LOCKED_M


@pytest.mark.parametrize("module", [localize_on_map, fleet_racing, fleet_live_loop])
def test_examples_default_to_the_card(module):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        module.main([])
