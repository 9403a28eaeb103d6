"""The port's rosbag2 interchange (``runtime/rosbag.py``) against the JAX
package's, case for case with ``tests/test_rosbag.py``: every CDR message
is byte for byte the JAX encoder's, a bag written by either package
imports in the other to the same trace, the golden config #1 trace
survives the round trip with its scans bit for bit, and the port's CLI
exports and imports as the JAX CLI does."""

import json
import sqlite3
from pathlib import Path

import numpy as np
import pytest

from monte_carlo_localization_tpu.runtime import rosbag as jbag
from monte_carlo_localization_tpu.runtime.trace import Trace as JTrace
from monte_carlo_localization_tpu_torch.runtime import rosbag
from monte_carlo_localization_tpu_torch.runtime.trace import Trace

GOLDEN = Path(__file__).resolve().parents[1] / "traces" / "config1_map_1753950572.npz"
FIELDS = ("odom_t", "odom_pose", "odom_twist", "scan_t", "scan_ranges", "beam_angles", "truth_t",
          "truth_pose")


def _tiny_fields(with_truth=True):
    rng = np.random.default_rng(0)
    n_o, n_s = 40, 10
    return dict(
        odom_t=np.arange(n_o) * 0.01,
        odom_pose=rng.normal(size=(n_o, 3)),
        odom_twist=rng.normal(size=(n_o, 2)),
        scan_t=np.arange(n_s) * 0.04,
        scan_ranges=rng.uniform(0.1, 11.0, (n_s, 16)).astype(np.float32),
        beam_angles=np.linspace(-2.0, 2.0, 16).astype(np.float32),
        truth_t=np.arange(n_o) * 0.01 if with_truth else None,
        truth_pose=rng.normal(size=(n_o, 3)) if with_truth else None,
        map_name="tiny",
    )


def assert_same_trace(a, b):
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        if x is not None:
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=f)
    assert a.map_name == b.map_name


@pytest.mark.parametrize("args", [
    (3.5, np.array([1.5, 2.25, 11.75], np.float32), -1.0, 0.25, 12.0),
    (1e9 + 0.123456789, np.linspace(0.1, 30, 1081).astype(np.float32), -2.35, 0.0043, 30.0),
    (0.0, np.zeros(0, np.float32), 0.0, 0.0, 10.0),
])
def test_laserscan_bytes_equal_jax(args):
    kw = dict(frame_id="laser", scan_time=0.04)
    msg = rosbag.encode_laserscan(*args, **kw)
    assert msg == jbag.encode_laserscan(*args, **kw)
    out, want = rosbag.decode_laserscan(msg), jbag.decode_laserscan(msg)
    assert out.keys() == want.keys()
    for k in out:
        np.testing.assert_array_equal(out[k], want[k])


@pytest.mark.parametrize("args, kw", [
    ((10.125, np.array([1.25, -3.5, 0.7]), 1.5, -0.25), {}),
    ((2.0, np.array([-4.0, 2.5, -3.1]), 0.0, 0.0), dict(frame_id="map", child_frame_id="car")),
])
def test_odometry_bytes_equal_jax(args, kw):
    msg = rosbag.encode_odometry(*args, **kw)
    assert msg == jbag.encode_odometry(*args, **kw)
    out, want = rosbag.decode_odometry(msg), jbag.decode_odometry(msg)
    assert out.keys() == want.keys()
    for k in out:
        np.testing.assert_array_equal(out[k], want[k])
    np.testing.assert_allclose(out["pose"], args[1], atol=1e-12)


def test_big_endian_rejected():
    with pytest.raises(ValueError, match="little-endian"):
        rosbag.decode_laserscan(b"\x00\x00\x00\x00" + b"\x00" * 32)


@pytest.mark.parametrize("with_truth", [True, False], ids=["truth", "no_truth"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_bags_cross_import(tmp_path, writer, with_truth):
    """A bag written by either package imports in both to the same trace."""
    fields = _tiny_fields(with_truth)
    if writer == "jax":
        bag = jbag.export_bag(JTrace(**fields), tmp_path / "bag")
    else:
        bag = rosbag.export_bag(Trace(**fields), tmp_path / "bag")
    got, want = rosbag.import_bag(bag, map_name="tiny"), jbag.import_bag(bag, map_name="tiny")
    assert_same_trace(got, want)
    assert (got.truth_t is None) == (not with_truth)
    np.testing.assert_array_equal(got.scan_ranges, fields["scan_ranges"])
    np.testing.assert_allclose(got.scan_t, fields["scan_t"], atol=2e-9)
    np.testing.assert_allclose(got.odom_twist, fields["odom_twist"], atol=1e-12)


def test_both_packages_write_the_same_bag(tmp_path):
    fields = _tiny_fields()
    a = rosbag.export_bag(Trace(**fields), tmp_path / "a" / "bag")
    b = jbag.export_bag(JTrace(**fields), tmp_path / "b" / "bag")
    assert (a / "metadata.yaml").read_text() == (b / "metadata.yaml").read_text()
    rows = []
    for d in (a, b):
        con = sqlite3.connect(next(d.glob("*.db3")))
        try:
            rows.append([list(con.execute(f"SELECT * FROM {t} ORDER BY 1"))
                         for t in ("schema", "topics", "messages")])
        finally:
            con.close()
    assert rows[0] == rows[1]
    (ver, distro), = rows[0][0]
    assert ver == 3 and distro == "humble"
    assert len(rows[0][2]) == 10 + 40 + 40


def test_golden_trace_roundtrip(tmp_path):
    """The committed config #1 trace survives export and import with its
    scans, twists and truth as the JAX round trip gives them."""
    tr = Trace.load(GOLDEN)
    bag = rosbag.export_bag(tr, tmp_path / "golden_bag")
    got = rosbag.import_bag(bag, map_name=tr.map_name)
    assert_same_trace(got, jbag.import_bag(jbag.export_bag(JTrace.load(GOLDEN),
                                                           tmp_path / "jax_bag"),
                                           map_name=tr.map_name))
    np.testing.assert_array_equal(got.scan_ranges, tr.scan_ranges)
    np.testing.assert_allclose(got.scan_t, tr.scan_t, atol=2e-9)
    np.testing.assert_allclose(got.odom_twist, tr.odom_twist, atol=1e-12)
    assert got.num_beams == tr.num_beams


def test_cli_export_and_import(tmp_path, capsys):
    from monte_carlo_localization_tpu import cli as jcli
    from monte_carlo_localization_tpu_torch import cli

    Trace(**_tiny_fields()).save(tmp_path / "tiny.npz")
    outs = {}
    for name, main in (("port", cli.main), ("jax", jcli.main)):
        capsys.readouterr()
        assert main(["export-bag", "--trace", str(tmp_path / "tiny.npz"),
                     "--out", str(tmp_path / name / "bag")]) == 0
        exported = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert main(["import-bag", "--bag", str(tmp_path / name / "bag"),
                     "--out", str(tmp_path / name / "back.npz"), "--map-name", "tiny"]) == 0
        imported = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        outs[name] = (exported, imported)
    for i in (0, 1):
        port, jax_out = outs["port"][i], outs["jax"][i]
        assert sorted(port) == sorted(jax_out)
        assert {k: v for k, v in port.items() if k not in ("bag", "trace")} == {
            k: v for k, v in jax_out.items() if k not in ("bag", "trace")}
    assert_same_trace(Trace.load(tmp_path / "port" / "back.npz"),
                      Trace.load(tmp_path / "jax" / "back.npz"))
