"""The probe kernels' plain versions (``ops/probes.py``) against the JAX
package's ``tools/mega_probe.py`` probes, on the probes' own inputs.

The JAX tool returns nothing, so it is loaded by path and run in
interpret mode with a stand-in for its ``pl`` module that records every
``pallas_call``'s inputs and outputs (a repeated call, the probes' timing
loops, returns the first output). ``probe_rng`` cannot run here:
``prng_seed`` has no CPU lowering. The plain Philox is held instead to
the probe's own statistics and to Philox4x32-10's published known-answer
vectors. Tolerances: exact for the row gather and the staged writes (and
the one-hot-difference gather, which selects one value); rtol 2e-5 for
the scans (the TPU probe's own); fewer than 1% of entries off for the
ancestor gather of the prologue, as the probe allows (:278), since the
CDFs are summed in another order; atol 1e-3 for the one-hot ">= slot"
sums of 4096 normals (float32 matmul sums against a float64 scan).
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from monte_carlo_localization_tpu_torch.ops.probes import (
    Probes,
    gather_rows_reference,
    philox4x32_10_reference,
    philox_normals_reference,
    scan_resample_reference,
    staged_writes_reference,
)
from monte_carlo_localization_tpu_torch.tools import mega_probe as tprobe

REPO = Path(__file__).resolve().parents[1]


class _RecordingPallas:
    """Stands in for the probe module's ``pl``: ``pallas_call`` records
    each call's kernel name, inputs and outputs as numpy."""

    def __init__(self, pl):
        self._pl = pl
        self.calls = []

    def __getattr__(self, name):
        return getattr(self._pl, name)

    def pallas_call(self, kernel, **kw):
        call = self._pl.pallas_call(kernel, **kw)
        record = {"kernel": kernel.__name__}

        def run(*args):
            if "out" not in record:
                record["args"] = [np.asarray(a) for a in args]
                record["out"] = jax.tree.map(np.asarray, call(*args))
                self.calls.append(record)
            return record["out"]

        return run


@pytest.fixture(scope="module")
def jax_probes():
    """{probe name: [recorded pallas_call, ...]} of every JAX probe but rng,
    run in interpret mode; each probe's own assertions hold."""
    torch.set_num_threads(1)
    spec = importlib.util.spec_from_file_location("jax_mega_probe", REPO / "tools" / "mega_probe.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    rec = _RecordingPallas(mod.pl)
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mod, "pl", rec)
        mp.setattr(mod, "INTERPRET", True)
        for name in ("smem", "cumsum", "scratch", "mega_ops", "smem_roundtrip", "mega_parts",
                     "mega_bisect"):
            rec.calls = []
            mod.PROBES[name]()
            out[name] = rec.calls
    return out


def _t(a):
    return torch.from_numpy(np.array(a))


def test_smem_probe_gather(jax_probes):
    (call,) = jax_probes["smem"]
    y0, hbm = call["args"]
    got = gather_rows_reference(_t(hbm), _t(y0.reshape(-1)))
    np.testing.assert_array_equal(got.numpy(), call["out"])


def test_cumsum_probe_scan(jax_probes):
    (call,) = jax_probes["cumsum"]
    got = scan_resample_reference("scan", w=_t(call["args"][0]))
    np.testing.assert_allclose(got.numpy(), call["out"].reshape(-1), rtol=2e-5)


@pytest.mark.parametrize("name, args, shape", [
    ("scratch", (8, 128, 1.0, 0.0, 1.0, 0.0), (8, 128)),
    ("smem_roundtrip", (32, 8, 16.0, 2.0, 0.0, 1.0), (2, 128)),
])
def test_staged_write_probes(jax_probes, name, args, shape):
    (call,) = jax_probes[name]
    got = staged_writes_reference(*args).reshape(shape)
    np.testing.assert_array_equal(got.numpy(), call["out"])


def _assert_prologue(prop, want_prop):
    off = float((np.abs(prop - want_prop) > 0).mean())
    assert off < 0.01, f"{off:.4f} of the ancestor entries differ"
    return np.all(prop == want_prop, axis=1)


def test_mega_ops_probe_prologue(jax_probes):
    (call,) = jax_probes["mega_ops"]
    w, parts = call["args"][:2]
    prop, chk = scan_resample_reference("full", w=_t(w), parts=_t(parts), u0=0.37)
    rows = _assert_prologue(prop.numpy(), call["out"][0])
    np.testing.assert_allclose(chk.numpy()[rows], call["out"][1].reshape(-1)[rows],
                               rtol=1e-5, atol=1e-5)


PART_CASES = {  # JAX kernel -> (port part, which recorded args feed w, g, parts)
    "k_cumsum": ("lanes", dict(w=0)),
    "k_flatten": ("roll", dict(w=0)),
    "k_onehot": ("ge_sum", dict(g=0, parts=1)),
    "k_onehot_def": ("ge_sum", dict(g=0, parts=1)),
    "k_col": ("col", dict(parts=0)),
    "k_onehot_diff": ("gather", dict(g=0, parts=1)),
    "k_front": ("front", dict(w=0, parts=3)),
    "k_full2": ("full", dict(w=0, parts=3)),
}


@pytest.mark.parametrize("probe, kernel", [
    ("mega_parts", "k_cumsum"), ("mega_parts", "k_flatten"), ("mega_parts", "k_onehot"),
    ("mega_parts", "k_onehot_def"), ("mega_parts", "k_col"), ("mega_bisect", "k_onehot_diff"),
    ("mega_bisect", "k_front"), ("mega_bisect", "k_full2"),
])
def test_mega_part_probes(jax_probes, probe, kernel):
    (call,) = [c for c in jax_probes[probe] if c["kernel"] == kernel]
    part, feeds = PART_CASES[kernel]
    kw = {k: _t(call["args"][i].reshape(-1) if k in ("w", "g") else call["args"][i])
          for k, i in feeds.items()}
    got = scan_resample_reference(part, **kw, u0=0.37)
    want = call["out"]
    if part == "lanes":
        np.testing.assert_allclose(got.numpy(), want.reshape(-1), rtol=2e-5)
    elif part in ("roll", "gather"):
        np.testing.assert_array_equal(got.numpy().reshape(want.shape), want)
    elif part == "ge_sum":
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-3)
    elif part == "col":
        np.testing.assert_allclose(got.numpy(), want.reshape(-1), rtol=1e-5, atol=1e-5)
    elif part == "front":
        _assert_prologue(got.numpy(), want)
    else:
        rows = _assert_prologue(got[0].numpy(), want[0])
        np.testing.assert_allclose(got[1].numpy()[rows], want[1].reshape(-1)[rows],
                                   rtol=1e-5, atol=1e-5)


def test_plain_philox_known_answers_and_rng_probe_statistics():
    for ctr, key, want in tprobe.PHILOX_KAT:
        got = philox4x32_10_reference(torch.tensor([ctr], dtype=torch.int64), key)[0]
        assert tuple(int(v) for v in got) == want
    normals, words = philox_normals_reference((12345, 678), 4 * 32 * 128)
    out = normals.reshape(4, 32, 128).numpy()
    assert not np.allclose(out[0], out[1])  # the stream runs on across blocks
    assert abs(float(out.mean())) < 0.05 and abs(float(out.std()) - 1.0) < 0.05
    assert int(words.min()) >= 0 and int(words.max()) <= 0xFFFFFFFF
    assert np.isfinite(out).all()


def test_probe_tool_runs_the_plain_versions_on_cpu(capsys):
    assert tprobe.main(["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split()[:2] for ln in lines] == [["PASS", n] for n in tprobe.PROBES]
    with pytest.raises(SystemExit):
        tprobe.main(["no_such_probe", "--device", "cpu"])


def test_probe_wrappers_take_the_plain_versions_on_cpu():
    pr = Probes()
    for name in tprobe.PROBES:
        tprobe.PROBES[name](pr, torch.device("cpu"))
    assert pr.launch_count == dict(gather_rows=0, philox_normals=0, staged_writes=0,
                                   scan_resample=0)
    with pytest.raises(ValueError, match="unknown part"):
        scan_resample_reference("nope", w=torch.zeros(8))


def test_failed_probe_prints_fail_and_exits_1(monkeypatch, capsys):
    def broken(pr, device):
        raise AssertionError("mismatch")

    monkeypatch.setitem(tprobe.PROBES, "smem", broken)
    assert tprobe.main(["smem", "cumsum", "--device", "cpu"]) == 1
    out = capsys.readouterr().out
    assert "FAIL smem" in out and "PASS cumsum" in out


def test_probe_gates_raise_explicitly():
    """Kernel-vs-plain gates raise ProbeFailure (they survive python -O):
    beyond the probe's tolerance, and where more than 1% of ancestor rows
    differ; the error is reported over every entry."""
    got, plain = torch.zeros(4), torch.tensor([0.0, 0.0, 0.0, 1e-3])
    with pytest.raises(tprobe.ProbeFailure, match="plain version"):
        tprobe._vs_plain(got, plain, "x")
    assert tprobe._vs_plain(got, plain, "x", atol=1e-3) == pytest.approx(1e-3)
    rows, other = torch.zeros((100, 3)), torch.zeros((100, 3))
    other[0, 0] = 5.0
    agree, off = tprobe._rows_vs_plain(rows, other, "x")
    assert off == pytest.approx(0.01) and not bool(agree[0]) and bool(agree[1:].all())
    other[1, 2] = 5.0
    with pytest.raises(tprobe.ProbeFailure, match="rows differ"):
        tprobe._rows_vs_plain(rows, other, "x")


@pytest.mark.parametrize("probe, plain", [
    ("smem", "gather_rows_reference"), ("cumsum", "scan_resample_reference"),
    ("scratch", "staged_writes_reference"), ("mega_parts", "scan_resample_reference"),
    ("mega_bisect", "scan_resample_reference"),
])
def test_probe_fails_when_kernel_and_plain_disagree(probe, plain, monkeypatch):
    """Every call of a probe is held against its plain version: a plain
    version that drifts fails the probe."""
    real = getattr(tprobe, plain)

    def drifted(*args, **kwargs):
        out = real(*args, **kwargs)
        return tuple(o + 0.5 for o in out) if isinstance(out, tuple) else out + 0.5

    monkeypatch.setattr(tprobe, plain, drifted)
    with pytest.raises(tprobe.ProbeFailure):
        tprobe.PROBES[probe](Probes(), torch.device("cpu"))
