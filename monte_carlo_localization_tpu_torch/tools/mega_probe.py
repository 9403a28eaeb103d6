"""Feasibility probes for the mega-fused MCL step, on Hopper: the port of
the JAX package's ``tools/mega_probe.py``.

Each probe runs what its TPU probe ran, through the probe kernels of
``csrc/probes.cu`` (``ops/probes.py``), on the probe's own inputs, and
checks the result against the probe's own expectation and, on the card,
against the kernel's plain PyTorch version:

    python -m monte_carlo_localization_tpu_torch.tools.mega_probe [probe ...] [--device cpu]

Probes (the TPU capability each one tested, in brackets):
  smem           a row gather by offsets [VMEM -> SMEM -> DMA offsets]
  rng            Philox4x32-10 normals over 4 blocks [prng_seed + bits]
  cumsum         flat inclusive scan of a (32, 128) tile [jnp.cumsum]
  scratch        per-block writes, read back by the last block [scratch]
  mega_ops       the mega step's prologue: scan, CDF, ancestor gather,
                 column math
  smem_roundtrip per-block scalar writes, read back plus one
  mega_parts     the prologue's parts one by one
  mega_bisect    the gather, the front half, the whole prologue

``smem`` and ``rng`` each run the TPU probe's own call first, then the
same function at the main path's particle counts (:data:`MAIN_PATH_N`):
the ancestor gather of N particles padded to 16 B rows, and the (N, 3)
motion noise. On the CPU only the first of those counts runs.

Prints PASS/FAIL per probe (FAIL with the traceback) and exits 1 if any
failed. Every kernel call is held against its plain version at the
probe's own tolerance. On the card each call also prints the kernel's
time and the time of the PyTorch call that computes the same function,
both as CUDA graphs of the bare call (``utils/timing.py`` ``graph_ms``),
beside the wrapper's and the plain version's per-call time, and for the
gather and the normals the time of the kernel as first ported.
"""

from __future__ import annotations

import argparse
import math
import sys
import time
import traceback
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from monte_carlo_localization_tpu_torch.ops.probes import (
    Probes,
    box_muller_terms_reference,
    gather_rows_reference,
    philox4x32_10_reference,
    philox_normals_reference,
    scan_resample_reference,
    staged_writes_reference,
)
from monte_carlo_localization_tpu_torch.utils.timing import event_ms, graph_ms

# Philox4x32-10 known answers (Random123 kat_vectors): counter, key -> words
PHILOX_KAT = (
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
)
N_MEGA = 32 * 128  # the mega probes' particle count
# particle counts of the main path: config #1, config #4's global
# localization, --million; the CPU runs the first only
MAIN_PATH_N = (4_000, 100_000, 1_000_000)
MAIN_PATH_SEED = 16
U0 = 0.37
ROWS_MIN = 0.99  # share of ancestor rows that must agree (knife-edge CDF slots)


class ProbeFailure(Exception):
    """A probe's check did not hold."""


def _expect(cond: bool, msg: str) -> None:
    if not cond:
        raise ProbeFailure(msg)


@dataclass
class Call:
    """One kernel call of a probe, with what measuring it needs."""

    kernel: str  # key of Probes.launch_count
    label: str
    run: Callable  # the wrapper call
    plain: Callable  # the plain version on the same inputs
    library: Callable | None  # one PyTorch call computing the same function
    work: tuple[float, float, float]  # bytes moved, float32 ops, float64 ops
    max_abs_err: float  # kernel against plain over every entry (0.0 on the CPU)
    rows_off: float = 0.0  # share of ancestor rows that differ from the plain version
    shape: dict | None = None  # the launch chosen (the card only)
    ported: Callable | None = None  # the kernel as first ported (the card only)


def _t(a, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _err(got, want) -> float:
    return float((got.float() - want.float()).abs().max()) if got.numel() else 0.0


def _vs_plain(got, plain, what: str, rtol: float = 0.0, atol: float = 0.0) -> float:
    """Max abs error of the kernel against its plain version; raises
    unless every entry is within ``atol + rtol * |plain|`` (the probe's
    own tolerance; exact by default)."""
    g, p = got.float(), plain.float()
    _expect(bool(((g - p).abs() <= atol + rtol * p.abs()).all()),
            f"{what}: kernel differs from its plain version (max abs {_err(g, p):.3g}, "
            f"rtol {rtol}, atol {atol})")
    return _err(g, p)


def _rows_vs_plain(got, plain, what: str):
    """(rows that agree exactly, share of rows that differ) of an ancestor
    gather against its plain version; raises where ROWS_MIN of the rows
    do not agree (a knife-edge CDF slot may pick the other ancestor)."""
    rows = (got == plain).all(dim=1)
    off = 1.0 - float(rows.float().mean())
    _expect(off <= 1.0 - ROWS_MIN, f"{what}: {off:.4f} of rows differ from the plain version")
    return rows, off


def _main_path_n(device) -> tuple[int, ...]:
    return MAIN_PATH_N if torch.device(device).type == "cuda" else MAIN_PATH_N[:1]


def probe_smem(pr: Probes, device) -> list[Call]:
    """The rows y0 names copied out; then the ancestor gather of the main
    path: N particles padded to (N, 4) float32, y0 N sorted indices drawn
    with repeats, as systematic resampling gives them."""
    hbm_np = np.arange(64 * 128, dtype=np.float32).reshape(64, 128)
    y0_np = np.array([3, 7, 0, 61, 5, 5, 9, 33, 2, 40, 1, 0, 8, 21, 13, 60], np.int32)
    calls = [_gather_call(pr, device, "smem", hbm_np, y0_np)]
    rng = np.random.default_rng(MAIN_PATH_SEED)
    for n in _main_path_n(device):
        hbm_np = rng.normal(size=(n, 4)).astype(np.float32)
        y0_np = np.sort(rng.integers(0, n, n)).astype(np.int32)
        calls.append(_gather_call(pr, device, f"smem gather N={n}", hbm_np, y0_np))
    return calls


def _gather_call(pr: Probes, device, label: str, hbm_np, y0_np) -> Call:
    hbm, y0 = _t(hbm_np, device), _t(y0_np, device)
    out = pr.gather_rows(hbm, y0)
    np.testing.assert_array_equal(out.cpu().numpy(), hbm_np[y0_np])
    err = _vs_plain(out, gather_rows_reference(hbm, y0), label)
    lib_out = torch.empty_like(out)
    s, lanes = y0_np.shape[0], hbm_np.shape[1]
    cuda = out.is_cuda
    return Call("gather_rows", label, lambda: pr.gather_rows(hbm, y0),
                lambda: gather_rows_reference(hbm, y0),
                lambda: torch.index_select(hbm, 0, y0, out=lib_out),
                (4 * (s + 2 * s * lanes), 0, 0), err,
                shape=pr.stream_shape("gather_rows", s, lanes) if cuda else None,
                ported=(lambda: pr.gather_rows_as_ported(hbm, y0)) if cuda else None)


def probe_rng(pr: Probes, device) -> list[Call]:
    """Philox normals over 4 blocks: the blocks differ, mean and std sane;
    the generator meets Philox4x32-10's known answers, and on the card its
    bits equal the plain version's and the CUDA toolkit's curand Philox,
    and its normals are bound within 1e-5 of the plain version's over
    every input (:func:`normals_error_bound`). Then the main path's
    motion noise: 3N normals, checked alike."""
    for ctr, key, want in PHILOX_KAT:
        got = philox4x32_10_reference(torch.tensor([ctr], dtype=torch.int64), key)[0]
        _expect(tuple(int(v) for v in got) == want, f"Philox KAT {ctr}: {got}")
    seed, count = (12345, 678), 4 * 32 * 128
    out, bits = pr.philox_normals(seed, count, device, with_bits=True)
    blocks = out.reshape(4, 32, 128).cpu().numpy()
    _expect(not np.allclose(blocks[0], blocks[1]), "the stream must run on across blocks")
    calls = [_normals_call(pr, device, "rng", seed, count, out, bits)]
    if torch.device(device).type == "cuda":
        bound = normals_error_bound(pr, device)
        _expect(bound["bound"] <= 1e-5, f"rng: normals may differ by {bound['bound']:.3g} "
                                        "from the plain version over all inputs")
    for n in _main_path_n(device):
        out, bits = pr.philox_normals(seed, 3 * n, device, with_bits=True)
        calls.append(_normals_call(pr, device, f"rng motion noise N={n}", seed, 3 * n, out, bits))
    return calls


def normals_error_bound(pr: Probes, device) -> dict:
    """The most the card's normals can differ from the plain version's:
    each of the kernel's two terms, r and cos, against the plain
    version's over all 2^24 inputs, then |r cos - r' cos'| <= |r - r'| +
    max r' |cos - cos'|, plus an ulp of the largest normal for the two
    products' roundings. The card only."""
    r, c = pr.box_muller_terms(device)
    r_plain, c_plain = box_muller_terms_reference(device)
    r_max = float(r_plain.max())
    d_r, d_cos = float((r - r_plain).abs().max()), float((c - c_plain).abs().max())
    ulp = float(np.spacing(np.float32(r_max)))
    return dict(r_max_abs_err=d_r, cos_max_abs_err=d_cos, r_max=r_max,
                bound=d_r + r_max * d_cos + ulp)


def _normals_call(pr: Probes, device, label: str, seed, count: int, out, bits) -> Call:
    """The probe's checks of ``count`` normals and their words: mean and
    std sane, the words 32-bit, the normals within 1e-5 of the plain
    version; on the card the words equal the plain version's and the
    first 256 curand's Philox4_32_10."""
    m, s = float(out.mean()), float(out.std())
    _expect(abs(m) < 0.05 and abs(s - 1.0) < 0.05, f"{label} normals: mean {m}, std {s}")
    cuda = torch.device(device).type == "cuda"
    _expect(tuple(bits.shape) == (count // 2, 4), f"{label}: Philox words of shape {bits.shape}")
    if not cuda:  # uint32 words held in int64 (on the card: their bits in int32)
        _expect(int(bits.min()) >= 0 and int(bits.max()) <= 0xFFFFFFFF,
                f"{label}: Philox words out of range")
    plain, words = philox_normals_reference(seed, count, device)
    err = _vs_plain(out, plain, f"{label} normals", atol=1e-5)
    if cuda:
        _expect(torch.equal(bits.long() & 0xFFFFFFFF, words),
                f"{label}: Philox bits differ from the plain version")
        oracle = pr.curand_philox_words(seed, 256, device)
        _expect(torch.equal(bits[:256], oracle),
                f"{label}: Philox bits differ from curand's Philox4_32_10")
    # Philox: 10 rounds of 2 mul-hi, 2 mul-lo, 4 xor, 2 key adds per 4
    # words (counted at the float32 rate), + ~20 float32 ops per normal
    ops = count * (10 * 10 / 2 + 20)
    lib_out = torch.empty_like(out)
    return Call("philox_normals", label, lambda: pr.philox_normals(seed, count, device),
                lambda: philox_normals_reference(seed, count, device),
                lambda: torch.randn(count, out=lib_out),
                (4 * count, ops, 0), err,
                shape=pr.stream_shape("philox_normals", count) if cuda else None,
                ported=(lambda: pr.philox_normals_as_ported(seed, count, device)) if cuda
                else None)


def probe_cumsum(pr: Probes, device) -> list[Call]:
    x_np = np.random.default_rng(0).uniform(size=(32, 128)).astype(np.float32)
    x = _t(x_np, device)
    out = pr.scan_resample("scan", w=x)
    np.testing.assert_allclose(out.cpu().numpy().reshape(32, 128),
                               np.cumsum(x_np.reshape(-1)).reshape(32, 128), rtol=2e-5)
    err = _vs_plain(out, scan_resample_reference("scan", w=x), "cumsum", rtol=2e-5)
    n = x.numel()
    lib_out = torch.empty_like(out)
    return [_scan_call(pr, "cumsum (scan)", "scan", (8 * n, 0, n), err,
                       library=lambda: torch.cumsum(x.reshape(-1), 0, out=lib_out), w=x)]


def _staged(pr, device, label, steps, per_step, a, b, c, add, want) -> Call:
    out = pr.staged_writes(steps, per_step, a, b, c, add, device)
    np.testing.assert_array_equal(out.cpu().numpy(), want.reshape(-1))
    plain = staged_writes_reference(steps, per_step, a, b, c, add, device)
    err = _vs_plain(out, plain, label)
    n = steps * per_step
    lib_out = torch.empty_like(plain)
    return Call("staged_writes", label,
                lambda: pr.staged_writes(steps, per_step, a, b, c, add, device),
                lambda: staged_writes_reference(steps, per_step, a, b, c, add, device),
                lambda: lib_out.copy_(plain), (4 * n, 3 * n, 0), err,
                shape=pr.staged_shape(steps, per_step) if out.is_cuda else None)


def probe_scratch(pr: Probes, device) -> list[Call]:
    """8 steps each write a (128,) row of i + 1; the last reads all 8."""
    want = np.tile(np.arange(1, 9, dtype=np.float32)[:, None], (1, 128))
    return [_staged(pr, device, "scratch", 8, 128, 1.0, 0.0, 1.0, 0.0, want)]


def probe_smem_roundtrip(pr: Probes, device) -> list[Call]:
    """32 steps each write 8 scalars (8i + s) * 2; read back plus one."""
    want = np.arange(256, dtype=np.float32) * 2.0 + 1.0
    return [_staged(pr, device, "smem_roundtrip", 32, 8, 16.0, 2.0, 0.0, 1.0, want)]


def _mega_inputs(scale: float, with_g: bool = False):
    rng = np.random.default_rng(1)
    w = rng.uniform(0.1, 1.0, (32, 128)).astype(np.float32)
    parts = rng.normal(size=(N_MEGA, 3)).astype(np.float32) * scale
    g = np.sort(rng.uniform(0, N_MEGA, N_MEGA)).astype(np.float32) if with_g else None
    return w, parts, g


def _want_ancestors(g: np.ndarray, parts: np.ndarray) -> np.ndarray:
    """The one-hot-difference gather: the first j with g[j] >= slot, zero
    rows where there is none."""
    j = np.searchsorted(g, np.arange(len(g), dtype=np.float32), side="left")
    return np.where((j < len(g))[:, None], parts[np.minimum(j, len(g) - 1)], 0.0)


def _want_prologue(w: np.ndarray, parts: np.ndarray) -> np.ndarray:
    """The TPU probe's own reference (:269-278): numpy's CDF, searchsorted,
    clipped to the last particle."""
    flat = w.reshape(-1)
    gg = N_MEGA * (np.cumsum(flat) / flat.sum()) - U0
    idx = np.clip(np.searchsorted(gg, np.arange(N_MEGA), side="left"), 0, N_MEGA - 1)
    return parts[idx]


def _scan_call(pr, label, part, work, err, library=None, rows_off=0.0, **kw) -> Call:
    ref = kw.get("w", kw.get("g", kw.get("parts")))
    n = ref.numel() if "w" in kw else ref.shape[0]
    return Call("scan_resample", label, lambda: pr.scan_resample(part, **kw),
                lambda: scan_resample_reference(part, **kw), library, work, err, rows_off,
                shape=pr.scan_shape(part, n) if ref.is_cuda else None)


def _gather_library(g, parts):
    """searchsorted + index into outputs allocated beforehand."""
    n = g.shape[0]
    slots = torch.arange(n, dtype=torch.float32, device=g.device)
    j = torch.empty(n, dtype=torch.int64, device=g.device)
    out = torch.empty_like(parts)

    def run():
        torch.searchsorted(g, slots, out=j)
        j.clamp_(max=n - 1)
        return torch.index_select(parts, 0, j, out=out)

    return run


def _check_prologue(pr, device, w_np, parts_np, part: str):
    """The front or full prologue against the probe's reference (< 1%
    entries off, the knife-edge CDF slots) and against the plain version:
    at least ROWS_MIN of the ancestor rows equal, the column math within
    the probe's tolerance on them. Returns (w, parts, max abs error over
    every row, share of rows that differ)."""
    w, parts = _t(w_np, device), _t(parts_np, device)
    got = pr.scan_resample(part, w=w, parts=parts, u0=U0)
    plain = scan_resample_reference(part, w=w, parts=parts, u0=U0)
    prop, pprop = (got[0], plain[0]) if part == "full" else (got, plain)
    want = _want_prologue(w_np, parts_np)
    off = float((np.abs(prop.cpu().numpy() - want) > 0).mean())
    _expect(off < 0.01, f"{part}: resample gather mismatch on {off:.4f} of entries")
    rows, rows_off = _rows_vs_plain(prop, pprop, f"{part} kernel vs plain")
    err = _err(prop, pprop)
    if part == "full":
        th = prop[:, 2].cpu().numpy()
        np.testing.assert_allclose(got[1].cpu().numpy(), np.sin(th) + th * 0.5,
                                   rtol=1e-5, atol=1e-5)
        _vs_plain(got[1][rows], plain[1][rows], "full column math", rtol=1e-5, atol=1e-5)
        err = max(err, _err(got[1], plain[1]))
    return w, parts, err, rows_off


def _prologue_work(full: bool) -> tuple[float, float, float]:
    n = N_MEGA
    search = n * math.ceil(math.log2(n))
    b = 4 * n + 12 * n + 12 * n + (4 * n if full else 0)
    return (b, 3 * n + search + (3 * n if full else 0), n)


def probe_mega_ops(pr: Probes, device) -> list[Call]:
    """The mega prologue at N = 4096: scan -> CDF -> ancestor gather ->
    column math (the TPU's matmul cumsum and one-hot gather)."""
    w_np, parts_np, _ = _mega_inputs(10.0)
    w, parts, err, rows_off = _check_prologue(pr, device, w_np, parts_np, "full")
    return [_scan_call(pr, "mega_ops (full prologue)", "full", _prologue_work(True), err,
                       rows_off=rows_off, w=w, parts=parts, u0=U0)]


def probe_mega_parts(pr: Probes, device) -> list[Call]:
    """The prologue's parts one by one: row-wise lane scan over the total,
    flatten + roll, the one-hot ">= slot" sums (HIGHEST and DEFAULT on the
    TPU; float32 on Hopper, one kernel), column math."""
    w_np, parts_np, g_np = _mega_inputs(1.0, with_g=True)
    w, parts, g = _t(w_np, device), _t(parts_np, device), _t(g_np, device)
    n = N_MEGA
    search = n * math.ceil(math.log2(n))
    calls = []

    lanes = pr.scan_resample("lanes", w=w)
    np.testing.assert_allclose(lanes.cpu().numpy().reshape(32, 128),
                               np.cumsum(w_np, axis=1) / w_np.sum(), rtol=2e-5)
    calls.append(_scan_call(pr, "mega_parts lanes (cumsum-matmul)", "lanes", (8 * n, n, n),
                            _vs_plain(lanes, scan_resample_reference("lanes", w=w), "lanes",
                                      rtol=2e-5), w=w))

    rolled = pr.scan_resample("roll", w=w)
    np.testing.assert_array_equal(rolled.cpu().numpy(), np.roll(w_np.reshape(-1), 1))
    calls.append(_scan_call(pr, "mega_parts roll (flatten+roll)", "roll", (8 * n, 0, 0),
                            _vs_plain(rolled, scan_resample_reference("roll", w=w), "roll"),
                            library=lambda: torch.roll(w.reshape(-1), 1), w=w))

    ge = pr.scan_resample("ge_sum", g=g, parts=parts)
    want = np.stack([parts_np[g_np >= s].astype(np.float64).sum(0) for s in range(n)])
    np.testing.assert_allclose(ge.cpu().numpy(), want, rtol=0, atol=1e-3)
    ge_err = _vs_plain(ge, scan_resample_reference("ge_sum", g=g, parts=parts), "ge_sum",
                       atol=1e-3)
    for precision in ("HIGHEST", "DEFAULT"):
        calls.append(_scan_call(pr, f"mega_parts ge_sum (onehot32+mm-{precision})", "ge_sum",
                                (4 * n + 12 * n + 12 * n, search, 6 * n), ge_err, g=g,
                                parts=parts))

    col = pr.scan_resample("col", parts=parts)
    th = parts_np[:, 2]
    np.testing.assert_allclose(col.cpu().numpy(), np.sin(th) + th * 0.5, rtol=1e-5, atol=1e-5)
    calls.append(_scan_call(pr, "mega_parts col (colmath+reshape)", "col", (8 * n, 3 * n, 0),
                            _vs_plain(col, scan_resample_reference("col", parts=parts), "col",
                                      rtol=1e-5, atol=1e-5),
                            parts=parts))
    return calls


def probe_mega_bisect(pr: Probes, device) -> list[Call]:
    """The one-hot-difference gather alone, the front half (scan -> gather)
    and the whole prologue (+ column math, two outputs)."""
    w_np, parts_np, g_np = _mega_inputs(1.0, with_g=True)
    g, parts = _t(g_np, device), _t(parts_np, device)
    n = N_MEGA
    got = pr.scan_resample("gather", g=g, parts=parts)
    np.testing.assert_array_equal(got.cpu().numpy(), _want_ancestors(g_np, parts_np))
    plain = scan_resample_reference("gather", g=g, parts=parts)
    calls = [_scan_call(pr, "mega_bisect gather (onehot-diff+mm)", "gather",
                        (4 * n + 24 * n, n * math.ceil(math.log2(n)), 0),
                        _vs_plain(got, plain, "gather"),
                        library=_gather_library(g, parts), g=g, parts=parts)]
    for part, label, full in (("front", "cumsum->onehot-diff+mm", False),
                              ("full", "full(+colmath+2outs)", True)):
        w, parts_t, err, rows_off = _check_prologue(pr, device, w_np, parts_np, part)
        calls.append(_scan_call(pr, f"mega_bisect {part} ({label})", part, _prologue_work(full),
                                err, rows_off=rows_off, w=w, parts=parts_t, u0=U0))
    return calls


PROBES = dict(smem=probe_smem, rng=probe_rng, cumsum=probe_cumsum, scratch=probe_scratch,
              mega_ops=probe_mega_ops, smem_roundtrip=probe_smem_roundtrip,
              mega_parts=probe_mega_parts, mega_bisect=probe_mega_bisect)


def measure(call: Call) -> dict:
    """Times of one call on the card. The kernel (``ms``) and the library
    call (``library_ms``, None where no one PyTorch call computes it) are
    timed alike: a CUDA graph of the bare call, outputs allocated before
    capture or from the graph's pool; so is the kernel as first ported
    (``ported_ms``, the gather's and the normals' calls only).
    The wrapper's and the plain version's ms are CUDA events around
    back-to-back Python calls."""
    return dict(
        kernel=call.kernel, label=call.label, ms=graph_ms(call.run), time_source="cuda_graph",
        wrapper_ms=event_ms(call.run),
        plain_ms=event_ms(call.plain, iters=10),
        library_ms=None if call.library is None else graph_ms(call.library),
        ported_ms=None if call.ported is None else graph_ms(call.ported),
        bytes=call.work[0], f32_ops=call.work[1], f64_ops=call.work[2],
        max_abs_err=call.max_abs_err, rows_off=call.rows_off, shape=call.shape,
    )


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("probes", nargs="*", metavar="probe",
                        help=f"probes to run (default: all of {', '.join(PROBES)})")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) runs the kernels; cpu their plain versions")
    args = parser.parse_args(argv)
    unknown = sorted(set(args.probes) - set(PROBES))
    if unknown:
        parser.error(f"unknown probes {unknown}; probes are {', '.join(PROBES)}")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("mega_probe: no CUDA device (pass --device cpu for the plain versions)",
              file=sys.stderr)
        return 2
    pr = Probes()
    failed = []
    for name in args.probes or list(PROBES):
        t0 = time.perf_counter()
        try:
            calls = PROBES[name](pr, device)
        except Exception:
            print(f"FAIL {name} ({time.perf_counter() - t0:.1f}s)")
            traceback.print_exc()
            failed.append(name)
            continue
        print(f"PASS {name} ({time.perf_counter() - t0:.1f}s)")
        if device.type == "cuda":
            for call in calls:
                m = measure(call)
                lib = "-" if m["library_ms"] is None else f"{m['library_ms']:.5f}"
                ported = "" if m["ported_ms"] is None else f", as ported {m['ported_ms']:.5f}"
                print(f"  {call.label:44s} kernel {m['ms']:.5f} ms, library {lib}{ported} "
                      "(CUDA graphs); "
                      f"wrapper {m['wrapper_ms']:.4f}, plain {m['plain_ms']:.4f}; "
                      f"max abs err {m['max_abs_err']:.3g}, rows off {m['rows_off']:.4f}; "
                      f"launch {m['shape']}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
