"""The port's command line against the JAX package's on a tiny map: the
same subcommands print the same JSON keys (``info`` and ``make-trace``
the same values), the port's checkpoint round trip runs through the CLI,
``--raycast lut|sphere|dda`` replays as the JAX CLI does, ``info --lut``
names the LUT's route, ``replay --viz-out`` writes the JAX CLI's frames,
``live --serve`` answers while the loop runs (the bag commands are held in
``tests/test_torch_rosbag.py``), ``bench`` runs the port's harness
(``tests/test_torch_bench.py`` holds it against the JAX harness), and the
default device is the card."""

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from monte_carlo_localization_tpu import cli as jcli
from monte_carlo_localization_tpu_torch import cli
from monte_carlo_localization_tpu_torch.runtime import Trace

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _one_thread_private_lut_cache(monkeypatch, tmp_path):
    torch.set_num_threads(1)
    monkeypatch.setenv("MCL_LUT_CACHE", str(tmp_path / "lut_cache"))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """A small boxed world as PNG+YAML and a 1 s trace of it (from the JAX CLI)."""
    d = tmp_path_factory.mktemp("cli_world")
    img = np.full((70, 90), 254, np.uint8)
    img[:3, :] = img[-3:, :] = img[:, :3] = img[:, -3:] = 0
    img[30:40, 40:52] = 0
    Image.fromarray(img).save(d / "world.png")
    (d / "world.yaml").write_text(yaml.dump(dict(
        image="world.png", resolution=0.05, origin=[-0.5, 0.25, 0.0], negate=0,
        occupied_thresh=0.65, free_thresh=0.196)))
    trace = d / "jax.npz"
    assert jcli.main(["make-trace", "--map", str(d / "world.yaml"), "--out", str(trace),
                      "--duration", "1", "--beams", "60"]) == 0
    return dict(map=str(d / "world.yaml"), trace=str(trace), dir=d)


def _json(capsys, main, argv) -> dict:
    capsys.readouterr()
    assert main(argv) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_make_trace_and_info_match_jax(world, capsys, tmp_path):
    out = tmp_path / "port"
    capsys.readouterr()
    assert cli.main(["make-trace", "--device", "cpu", "--map", world["map"], "--out", str(out),
                     "--duration", "1", "--beams", "60"]) == 0
    line = capsys.readouterr().out
    assert line.startswith(f"wrote {out}.npz: 25 scans x 60 beams, 100 odom msgs")
    a, b = Trace.load(f"{out}.npz"), Trace.load(world["trace"])
    np.testing.assert_array_equal(a.scan_ranges, b.scan_ranges)
    np.testing.assert_array_equal(a.truth_pose, b.truth_pose)
    for path in (world["map"], world["trace"]):
        assert _json(capsys, cli.main, ["info", "--device", "cpu", path]) == \
            _json(capsys, jcli.main, ["info", path])


def test_replay_and_live_print_the_jax_keys(world, capsys, tmp_path):
    common = ["--map", world["map"], "--trace", world["trace"], "--particles", "64",
              "--angle-step", "2"]
    rec, ck = str(tmp_path / "run.jsonl"), str(tmp_path / "ck.npz")
    port = _json(capsys, cli.main, ["replay", "--device", "cpu", *common, "--record-out", rec,
                                    "--checkpoint-out", ck])
    jax_out = _json(capsys, jcli.main, ["replay", *common, "--raycast", "lut",
                                        "--record-out", str(tmp_path / "jax.jsonl")])
    assert sorted(port) == sorted(jax_out)
    assert port["corrections"] == jax_out["corrections"] == 24
    assert port["beams"] == jax_out["beams"] == 30 and port["map"] == jax_out["map"] == "world"
    topics = {json.loads(ln)["topic"] for ln in Path(rec).read_text().splitlines()}
    assert topics == {"tf", "odom", "pose", "particles"}

    chained = _json(capsys, cli.main, ["replay", "--device", "cpu", *common, "--chained",
                                       "--resume-from", ck, "--profile-dir",
                                       str(tmp_path / "prof")])
    assert sorted(chained) == sorted(set(jax_out) - {"record_out"})
    assert chained["corrections"] == 25 and np.isfinite(chained["rmse_xy_m"])
    assert (tmp_path / "prof" / "trace.json").exists()

    live = ["live", *common, "--duration", "0.3", "--async-correction", "--live-chunk", "2"]
    port_live = _json(capsys, cli.main, [live[0], "--device", "cpu", *live[1:]])
    jax_live = _json(capsys, jcli.main, [*live, "--raycast", "lut"])
    assert sorted(port_live) == sorted(jax_live)


@pytest.mark.parametrize("method", ["lut", "sphere", "dda"])
def test_replay_runs_every_raycast_method(world, capsys, method):
    common = ["--map", world["map"], "--trace", world["trace"], "--particles", "64",
              "--angle-step", "4", "--raycast", method, "--chained"]
    port = _json(capsys, cli.main, ["replay", "--device", "cpu", *common])
    jax_out = _json(capsys, jcli.main, ["replay", *common])
    assert sorted(port) == sorted(jax_out)
    assert port["corrections"] == jax_out["corrections"] == 25
    assert np.isfinite(port["rmse_xy_m"]) and port["rmse_xy_m"] < 0.15


def test_info_lut_names_its_route(world, capsys):
    out = _json(capsys, cli.main, ["info", "--device", "cpu", world["map"], "--lut",
                                   "--lut-theta-bins", "90"])
    assert out["lut_route"] in ("native", "plain") and out["lut_build_s"] >= 0
    assert out["lut_bytes"] == out["height"] * out["width"] * 90 and out["lut_theta_bins"] == 90


def test_baseline_json_matches_jax(world, capsys):
    """``baseline`` prints the JAX CLI's keys, and the same numbers: both
    harnesses draw from numpy ``default_rng(0)`` and cast with one native
    source. Its phase times are the host's."""
    args = ["baseline", "--map", world["map"], "--trace", world["trace"], "--particles", "64",
            "--angle-step", "6", "--corrections", "8"]
    port = _json(capsys, cli.main, args)
    jax_out = _json(capsys, jcli.main, args)
    assert sorted(port) == sorted(jax_out) and sorted(port["phase_ms"]) == sorted(jax_out["phase_ms"])
    assert port["engine"] == "cpu_reference" and port["corrections"] == 8
    assert (port["rmse_xy_m"], port["rmse_theta_rad"]) == (jax_out["rmse_xy_m"],
                                                           jax_out["rmse_theta_rad"])
    with pytest.raises(SystemExit):
        cli.main([*args, "--device", "cpu"])  # a host harness: it takes no --device


def test_bench_prints_one_line_with_the_jax_keys(capsys):
    """``bench --device cpu --config 1 --quick`` runs the port's harness:
    one JSON line with every key of the JAX harness's line
    (BENCH_r05.json), the device's keys, and nothing left unported."""
    assert cli.main(["bench", "--device", "cpu", "--config", "1", "--quick"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    jax_keys = set(json.loads((REPO / "BENCH_r05.json").read_text())["parsed"])
    assert jax_keys <= set(line) and line["device"] == line["power_limit_w"] == "cpu"
    assert line["method"] == "lut_pallas+cpu" and line["value"] > 0
    assert not hasattr(cli, "UNPORTED") and not hasattr(cli, "cmd_unported")


def test_bench_without_a_card_exits_non_zero_naming_the_device():
    """The default device is the card: with none and no ``--device cpu``
    both entry points exit non-zero naming it, with no fallback line."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    for module in ("monte_carlo_localization_tpu_torch.cli bench",
                   "monte_carlo_localization_tpu_torch.bench"):
        res = subprocess.run([sys.executable, "-m", *module.split(), "--config", "1", "--quick"],
                             cwd=REPO, capture_output=True, text=True, timeout=300)
        assert res.returncode != 0 and res.stdout == "", module
        assert "device cuda requested" in res.stderr and "is_available() is False" in res.stderr


def test_replay_viz_out_renders_as_the_jax_cli_does(world, capsys, tmp_path):
    """``replay --viz-out DIR --viz-every N`` writes the JAX CLI's frame
    files: every Nth correction and the trajectory overview."""
    common = ["--map", world["map"], "--trace", world["trace"], "--particles", "64",
              "--angle-step", "4", "--viz-every", "10"]
    port = _json(capsys, cli.main, ["replay", "--device", "cpu", *common,
                                    "--viz-out", str(tmp_path / "port")])
    jax_out = _json(capsys, jcli.main, ["replay", *common, "--raycast", "lut",
                                        "--viz-out", str(tmp_path / "jax")])
    assert sorted(port) == sorted(jax_out) and port["corrections"] == 24
    names = sorted(p.name for p in (tmp_path / "port").glob("*.png"))
    assert names == ["frame_00001.png", "frame_00011.png", "frame_00021.png", "trajectory.png"]
    assert names == sorted(p.name for p in (tmp_path / "jax").glob("*.png"))


def test_live_serve_answers_while_the_loop_runs(world, capsys, monkeypatch):
    """``live --serve 0``: the viewer answers /state.json and /frame.png
    from a second thread while the LiveRunner steps the node, and closes
    with the run."""
    import threading
    import urllib.request

    polls, frames = [], []

    class Polled(cli.WebViz):
        def start(self):
            super().start()

            def poll():
                for _ in range(3):
                    with urllib.request.urlopen(self.url + "state.json", timeout=10) as r:
                        polls.append(json.loads(r.read()))
                    with urllib.request.urlopen(self.url + "frame.png", timeout=10) as r:
                        frames.append(r.read()[:4])
                    time.sleep(0.1)

            self.poller = threading.Thread(target=poll)
            self.poller.start()
            return self

        def close(self):
            self.poller.join(timeout=30)
            super().close()

    monkeypatch.setattr(cli, "WebViz", Polled)
    capsys.readouterr()
    assert cli.main(["live", "--device", "cpu", "--map", world["map"], "--trace", world["trace"],
                     "--particles", "64", "--angle-step", "2", "--duration", "1",
                     "--serve", "0"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("# live viewer at http://127.0.0.1:")
    out = json.loads(lines[-1])
    assert out["corrections"] > 0
    assert len(polls) == 3 and all(np.isfinite(p["pose"]).all() for p in polls)
    assert frames == [b"\x89PNG"] * 3


def test_default_device_is_the_card(world):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        cli.main(["info", world["map"]])
    res = subprocess.run(
        [sys.executable, "-m", "monte_carlo_localization_tpu_torch.cli", "replay", "--map",
         world["map"], "--trace", world["trace"]],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert res.returncode != 0 and "device='cpu'" in res.stderr
