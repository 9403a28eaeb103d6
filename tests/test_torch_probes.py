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
    MAX_STAGED,
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


def test_cpu_runs_the_first_main_path_size_only():
    """The card runs the gather and the normals at every count of the
    main path; the CPU at config #1's 4,000 only, to stay cheap."""
    assert tprobe.MAIN_PATH_N == (4_000, 100_000, 1_000_000)
    assert tprobe._main_path_n(torch.device("cpu")) == (4_000,)
    assert tprobe._main_path_n(torch.device("cuda")) == tprobe.MAIN_PATH_N


def test_smem_probe_lists_the_main_path_gather():
    """After the TPU probe's own call: the ancestor gather of 4,000
    particles in (N, 4) float32 rows by N sorted indices with repeats,
    its plain version equal to numpy's fancy index, 36 B a particle."""
    calls = tprobe.probe_smem(Probes(), torch.device("cpu"))
    assert [c.label for c in calls] == ["smem", "smem gather N=4000"]
    assert calls[0].work == (4 * (16 + 2 * 16 * 128), 0, 0)
    n = 4_000
    rng = np.random.default_rng(tprobe.MAIN_PATH_SEED)
    hbm_np = rng.normal(size=(n, 4)).astype(np.float32)
    y0_np = np.sort(rng.integers(0, n, n)).astype(np.int32)
    assert (np.diff(y0_np) == 0).any() and np.unique(y0_np).size < n  # repeats
    main = calls[1]
    assert main.kernel == "gather_rows" and main.work == (36 * n, 0, 0)
    np.testing.assert_array_equal(main.plain().numpy(), hbm_np[y0_np])
    np.testing.assert_array_equal(main.library().numpy(), hbm_np[y0_np])
    assert main.max_abs_err == 0.0 and main.shape is None and main.ported is None


def test_rng_probe_lists_the_main_path_noise():
    """After the TPU probe's own call: the (N, 3) motion noise of 4,000
    particles, 12,000 normals within the probe's mean and std bounds, the
    Philox words 32-bit, 12 B and 210 float32 operations a particle."""
    calls = tprobe.probe_rng(Probes(), torch.device("cpu"))
    assert [c.label for c in calls] == ["rng", "rng motion noise N=4000"]
    assert calls[0].work == (4 * 16384, 16384 * 70, 0)
    n = 4_000
    main = calls[1]
    assert main.kernel == "philox_normals" and main.work == (12 * n, 210 * n, 0)
    normals, words = main.plain()
    assert normals.shape == (3 * n,) and words.shape == (3 * n // 2, 4)
    assert abs(float(normals.mean())) < 0.05 and abs(float(normals.std()) - 1.0) < 0.05
    assert int(words.min()) >= 0 and int(words.max()) <= 0xFFFFFFFF
    assert torch.isfinite(normals).all()
    # the first 16,384 normals of the stream are the TPU-shaped call's
    head, _ = calls[0].plain()
    assert torch.equal(normals, head[:3 * n])
    assert main.max_abs_err == 0.0 and main.shape is None and main.ported is None


def test_box_muller_terms_are_the_plain_normals_factors():
    """The all-inputs table the card's normals are bounded against: at
    every 24-bit u its r and cos are the plain Box-Muller's two factors,
    so r[m1] cos[m2] is the plain normal of words m1 << 8, m2 << 8."""
    from monte_carlo_localization_tpu_torch.ops.probes import (
        box_muller_reference,
        box_muller_terms_reference,
    )

    r, c = box_muller_terms_reference()
    assert r.shape == c.shape == (1 << 24,)
    m1 = torch.from_numpy(np.random.default_rng(2).integers(0, 1 << 24, 4096))
    m2 = torch.from_numpy(np.random.default_rng(3).integers(0, 1 << 24, 4096))
    m1[:2], m2[:2] = torch.tensor([0, (1 << 24) - 1]), torch.tensor([1 << 22, 0])
    assert torch.equal(r[m1] * c[m2], box_muller_reference(m1 << 8, m2 << 8))
    assert float(r.max()) == float(r[0]) and 7.4 < float(r[0]) < 7.5  # u1 = 0 -> 1e-12


@pytest.mark.parametrize("probe, plain", [("smem", "gather_rows_reference"),
                                          ("rng", "philox_normals_reference")])
def test_main_path_calls_are_held_to_their_plain_versions(probe, plain, monkeypatch):
    """A plain version that drifts on the main path's call alone (the
    probe's own call still agrees) fails the probe."""
    real = getattr(tprobe, plain)

    def drifted(*args, **kwargs):
        out = real(*args, **kwargs)
        first = out[0] if isinstance(out, tuple) else out
        if first.shape[0] != 4_000 * (3 if probe == "rng" else 1):
            return out
        return (out[0] + 0.5, *out[1:]) if isinstance(out, tuple) else out + 0.5

    monkeypatch.setattr(tprobe, plain, drifted)
    with pytest.raises(tprobe.ProbeFailure, match="N=4000"):
        tprobe.PROBES[probe](Probes(), torch.device("cpu"))


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


STAGED_STEPS = (1, 7, 8, 9, 32, 100)
STAGED_PER_STEP = (1, 8, 128, 1000)


@pytest.mark.parametrize("per_step", STAGED_PER_STEP)
@pytest.mark.parametrize("steps", STAGED_STEPS)
def test_staged_writes_reference_is_the_formula(steps, per_step):
    """out[i * P + s] = ((a*i + b*s) + c) + add in float32, rounded step
    by step as the kernel rounds it (no FMA)."""
    a, b, c, add = 0.37, -1.3, 2.1, 0.5
    got = staged_writes_reference(steps, per_step, a, b, c, add)
    f32 = np.float32
    i = np.arange(steps, dtype=np.float32)[:, None]
    s = np.arange(per_step, dtype=np.float32)[None, :]
    want = ((f32(a) * i + f32(b) * s) + f32(c)) + f32(add)
    np.testing.assert_array_equal(got.numpy(), want.reshape(-1))


def test_staged_writes_refuses_what_one_cta_cannot_hold():
    """The scratch is one CTA's shared memory (227 KB): the wrapper
    refuses a larger call before it looks at the device, so the CPU
    refuses it too."""
    pr = Probes()
    assert pr.staged_writes(1, MAX_STAGED, 1.0, 0.0, 0.0, 0.0, "cpu").numel() == MAX_STAGED
    for steps, per_step in ((1, MAX_STAGED + 1), (100, 1000), (0, 8), (8, 0)):
        with pytest.raises(ValueError, match="shared memory"):
            pr.staged_writes(steps, per_step, 1.0, 0.0, 0.0, 0.0, "cpu")
    assert pr.launch_count["staged_writes"] == 0


@pytest.mark.parametrize("n", [1, 5, 1000, 4095, 4096, 8192])
def test_scan_roll_col_references_at_the_kernel_sizes(n):
    """The plain scan (float64 sums rounded once), roll and column math at
    the sizes the CUDA tests hold the kernels to."""
    rng = np.random.default_rng(n)
    w = rng.uniform(0.1, 1.0, n).astype(np.float32)
    parts = rng.normal(size=(n, 3)).astype(np.float32)
    scan = scan_resample_reference("scan", w=_t(w))
    np.testing.assert_array_equal(scan.numpy(), np.cumsum(w.astype(np.float64)).astype(np.float32))
    np.testing.assert_array_equal(scan_resample_reference("roll", w=_t(w)).numpy(), np.roll(w, 1))
    th = parts[:, 2]
    np.testing.assert_allclose(scan_resample_reference("col", parts=_t(parts)).numpy(),
                               np.sin(th) + th * np.float32(0.5), rtol=1e-6, atol=1e-6)
