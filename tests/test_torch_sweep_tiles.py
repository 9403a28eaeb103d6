"""The range-LUT sweep kernel's design, checked on the CPU (the kernel
itself, ``csrc/range_lut_sweep.cu``, runs only on a card).

- The tile plan (``ops/range_lut_sweep.py`` ``tile_plan``) covers every
  physical bin of every bin group exactly once, each tile inside one run
  of adjacent bins of one group, at each LUT geometry ``chip_smoke.py``'s
  ``lut_build`` checks on the card.
- Saturating D at C = max_range_px + 1 changes no entry: ``step_len >= 1``
  in every group, and ``px(min(D, C)) == px(D)`` for every step length of
  those geometries and D up to the longest line + 1, in float32 rounding
  step by step.
- A test-local emulation of the kernel's algorithm (tiles of lanes packed
  in 32-bit words, the carry-free saturated increment, line chunks with a
  warm-up, the float bits of 2^23 + D) equals the plain sweep and the JAX
  builders bit for bit, u8 and u16, dense and compact, stride T and padded.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from monte_carlo_localization_tpu.mapping.range_lut_device import (
    build_compact_range_lut_jax,
    build_range_lut_jax,
)
from monte_carlo_localization_tpu_torch.bench import _beams
from monte_carlo_localization_tpu_torch.mapping import clearance_field
from monte_carlo_localization_tpu_torch.mapping.range_lut_device import (
    FAR_ROW_MARGIN,
    build_compact_range_lut_device,
    build_range_lut_device,
    compact_row_map,
    shear_groups,
)
from monte_carlo_localization_tpu_torch.ops.range_lut_sweep import (
    LINE_WORDS,
    MAX_LINE_CELLS,
    SMEM_BYTES,
    chunk_lines,
    line_cells,
    line_words,
    smem_bytes,
    tile_plan,
    warm_share,
)

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _trace_beams(name: str) -> np.ndarray:
    with np.load(REPO / "traces" / name) as z:
        return np.asarray(z["beam_angles"], np.float32)[::18]


def _geometries() -> dict:
    """name -> (T, row stride, itemsize, max_range_px, longest line) of
    each LUT ``chip_smoke.py``'s ``lut_build`` builds on the card."""
    out = {}
    cases = (
        ("config1", _trace_beams("config1_map_1753950572.npz"), 240, 288),
        ("spielberg_compact_u8", _beams(1080), int(12.0 / 0.05796), 2000),
        ("spielberg_crop_u16", _beams(1080), int(25.6 / 0.05796), 400),
        ("basement_u8", _trace_beams("config4_basement_fixed.npz"), int(12.0 / 0.0504), 1300),
        ("basement_u16", _trace_beams("u16_basement.npz"), int(25.6 / 0.0504), 1300),
        ("config5", _beams(60), 240, 446),
    )
    for name, beams, mrp, line in cases:
        t, stride, itemsize = chip_smoke.lut_geometry(beams, mrp)
        out[name] = (t, stride, itemsize, mrp, line)
        if name == "config1":
            out["config1_T"] = (t, t, itemsize, mrp, line)
    out["spielberg_dense_1440"] = (1440, 1440, 1, int(12.0 / 0.05796), 2000)
    return out


GEOMETRIES = _geometries()


def test_geometries_are_the_chip_runs():
    """The geometries are the ones the PERF records name: config #1 at
    T = 1439 and padded, the 3072- and 3328-entry strides."""
    g = GEOMETRIES
    assert g["config1_T"][:2] == (1439, 1439) and g["config1"][1] > 1439
    assert g["spielberg_compact_u8"][1:3] == (3072, 1)
    assert g["basement_u8"][1:3] == (3072, 1) and g["basement_u16"][1:3] == (3328, 2)


@pytest.mark.parametrize("name", sorted(GEOMETRIES))
@pytest.mark.parametrize("words", LINE_WORDS)
def test_tile_plan_covers_every_bin_once(name, words):
    t, stride, itemsize, _, _ = GEOMETRIES[name]
    lanes = words * 4 // itemsize
    seen = np.zeros(stride, np.int64)
    for g in shear_groups(4, 4, t, stride):
        tiles = tile_plan(g.bins, lanes)
        assert tiles.dtype == np.int32 and tiles.shape[1] == 4
        covered = []
        for first, base, lo, hi in tiles.tolist():
            assert base % lanes == 0 and 0 <= lo < hi <= lanes
            run = g.bins[first:first + hi - lo]
            # one run of adjacent physical bins, in the tile's aligned window
            np.testing.assert_array_equal(run, base + np.arange(lo, hi))
            covered.append(run)
        np.testing.assert_array_equal(np.concatenate(covered), g.bins)
        seen[g.bins] += 1
    assert (seen == 1).all()


def test_tile_plan_cuts_runs_and_sector_boundaries():
    bins = np.array([3, 4, 5, 6, 7, 8, 40, 41, 63, 64, 65])
    np.testing.assert_array_equal(tile_plan(bins, 4), [
        [0, 0, 3, 4], [1, 4, 0, 4], [5, 8, 0, 1], [6, 40, 0, 2], [8, 60, 3, 4], [9, 64, 0, 2]])
    assert tile_plan(np.zeros(0, np.int64), 32).shape == (0, 4)


@pytest.mark.parametrize("name", sorted(GEOMETRIES))
def test_step_len_at_least_one(name):
    t, stride, _, _, _ = GEOMETRIES[name]
    for g in shear_groups(4, 4, t, stride):
        assert g.step_len.dtype == np.float32 and (g.step_len >= np.float32(1.0)).all()


def _entries(d: np.ndarray, sl: np.ndarray, maxr: int) -> np.ndarray:
    """The builders' float32 expression, one rounding a step."""
    px = np.float32(d.astype(np.float32)[None, :] * sl[:, None]) - np.float32(1.0)
    px = np.minimum(np.maximum(px, np.float32(0.0)), np.float32(maxr))
    return (px + np.float32(0.5)).astype(np.int64)


@pytest.mark.parametrize("maxr", [238, 254, 507])
def test_saturated_distance_gives_the_same_entries(maxr):
    lines = max(g[4] for g in GEOMETRIES.values())
    sls = np.unique(np.concatenate([
        g.step_len for t, stride, *_ in GEOMETRIES.values() for g in shear_groups(4, 4, t, stride)]))
    d = np.arange(lines + 2)
    sat = maxr + 1
    np.testing.assert_array_equal(_entries(np.minimum(d, sat), sls, maxr), _entries(d, sls, maxr))
    assert (_entries(np.array([sat]), sls, maxr) == maxr).all()


def test_line_words_and_the_longest_line():
    assert line_words(2000) == 8 and smem_bytes(2000, 8) <= SMEM_BYTES
    assert line_words(3300) == 4 and line_words(MAX_LINE_CELLS) == 1
    assert smem_bytes(MAX_LINE_CELLS, 1) <= SMEM_BYTES < smem_bytes(MAX_LINE_CELLS + 1, 1)
    assert line_words(MAX_LINE_CELLS + 1) == 0


def test_chunk_plan_fills_the_card():
    """Spielberg's groups (some 25 tiles each) on 132 SMs of one block:
    chunks bring the launch to about one full wave; a line count below C
    still plans, and one chunk is kept where the tiles alone fill it."""
    lines = chunk_lines(2000, 26, 208, 132)
    blocks = 26 * -(-2000 // lines)
    assert 100 <= blocks <= 132 and lines < 2000
    assert 0.0 < warm_share(2000, lines, 208) < 0.5
    assert chunk_lines(2000, 26, 208, 4) == 2000  # four slots: chunks only add warm-up
    assert warm_share(2000, 2000, 208) == 0.0
    assert warm_share(100, 7, 19) == pytest.approx(sum(min(19, f) for f in range(0, 100, 7))
                                                   / (100 + sum(min(19, f) for f in range(0, 100, 7))))


# ---- the kernel's algorithm, emulated --------------------------------------

def _lane_masks(lanes_per_word: int):
    bits = 32 // lanes_per_word
    one = sum(1 << (bits * j) for j in range(lanes_per_word))
    low = one * ((1 << (bits - 1)) - 1)
    return bits, one, low


def _sat_inc(x: np.ndarray, c_word: int, lanes_per_word: int) -> np.ndarray:
    """min(lane + 1, C) in every lane of uint32 words, carry-free."""
    bits, one, low = _lane_masks(lanes_per_word)
    ne = x ^ np.uint32(c_word)
    top = ((ne & np.uint32(low)) + np.uint32(low)) | ne
    return x + ((top >> np.uint32(bits - 1)) & np.uint32(one))


def _entry_from_lane(v: np.ndarray, sl: np.float32, maxr: int) -> np.ndarray:
    """Lane value -> entry through the float bits of 2^23 + v, as the kernel."""
    d = (np.uint32(0x4B000000) | v.astype(np.uint32)).view(np.float32) - np.float32(8388608.0)
    px = np.minimum(np.maximum(np.float32(d * sl) - np.float32(1.0), np.float32(0.0)),
                    np.float32(maxr))
    return np.floor(px + np.float32(0.5)).astype(np.int64)  # v >= 0: the rz add's floor


def _emulate_group(cells, g, maxr, out, stride, compact, words, itemsize, lines, stats):
    """One group as the kernel sweeps it: a block per (tile, chunk)."""
    k = 4 // itemsize  # lanes a word
    bits = 8 * itemsize
    lane_max = np.uint32((1 << bits) - 1)
    shift = (np.arange(k) * bits).astype(np.uint32)
    sat = maxr + 1
    c_word = sat * _lane_masks(k)[1]
    p_len, q_len = cells.shape
    occupied = cells < 0
    rows = (cells & 0x7FFFFFFF).astype(np.int64)
    for first_bin, base, lo, hi in tile_plan(g.bins, words * k).tolist():
        lane = np.arange(words * k).reshape(words, k)
        valid = (lane >= lo) & (lane < hi)
        col = np.where(valid, first_bin + lane - lo, 0)
        sl = np.where(valid, g.step_len[col], np.float32(1.0)).astype(np.float32)
        for first in range(0, p_len, lines):
            last, start = min(first + lines, p_len), max(first - sat, 0)
            stats["warm_starts"] += start > 0
            d = np.full((q_len + 2, words), 0 if start == 0 else c_word, np.uint32)
            d[[0, -1]] = 0  # off the line
            for i in range(start, last):
                p = i if g.forward else p_len - 1 - i
                r = np.where(valid, g.rel[p][col], 0)
                left = np.bitwise_or.reduce((r < 0).astype(np.uint32) * lane_max << shift, 1)
                right = np.bitwise_or.reduce((r > 0).astype(np.uint32) * lane_max << shift, 1)
                mid = ~(left | right)
                nbr = (d[:-2] & left) | (d[1:-1] & mid) | (d[2:] & right)
                new = np.where(occupied[p][:, None], np.uint32(0), _sat_inc(nbr, c_word, k))
                v = (new[:, :, None] >> shift) & lane_max  # (Q, words, k)
                assert (v <= sat).all()
                d[1:-1] = new
                if i < first:
                    continue  # warm-up: nothing stored
                stats["saturated"] += int((v[:, valid] == sat).sum())
                keep = rows[p] > 0 if compact else np.ones(q_len, bool)
                e = _entry_from_lane(v[keep], sl, maxr)
                idx = (rows[p][keep][:, None, None]) * stride + base + lane
                out[idx[:, valid]] = e[:, valid]


def _emulate(occ, t, maxr, stride, itemsize, words, lines, clearance=None):
    h, w = occ.shape
    if clearance is None:
        out = np.zeros(h * w * stride, np.int64)
        row_map = None
    else:
        row_map, row_cells = compact_row_map(clearance, maxr)
        out = np.full((len(row_cells) + 1) * stride, maxr, np.int64)
    rm = None if row_map is None else torch.from_numpy(row_map)
    stats = {"warm_starts": 0, "saturated": 0}
    for g in shear_groups(h, w, t, stride):
        cells = line_cells(torch.from_numpy(occ), rm, g.row_major).numpy()
        _emulate_group(cells, g, maxr, out, stride, row_map is not None, words, itemsize,
                       lines, stats)
    return out, stats


def _sparse_occ(h, w, seed):
    """A few scattered cells and one short wall, no border: most rays
    cross the whole map, so D saturates and chunks start mid-chain."""
    rng = np.random.default_rng(seed)
    occ = np.zeros((h, w), bool)
    occ[rng.integers(0, h, 6), rng.integers(0, w, 6)] = True
    r = int(rng.integers(2, h - 2))
    occ[r, w // 4: w // 4 + 5] = True
    return occ


EMULATED = [  # (h, w, T, stride, max_range_px, itemsize, compact, words, lines)
    (24, 40, 90, 90, 9, 1, False, 8, 5),      # stride T, chunks shorter than C
    (24, 40, 90, 512, 9, 1, True, 8, 12),     # padded, compact
    (30, 26, 64, 512, 18, 1, False, 4, 40),   # one chunk a group (lines > P)
    (8, 300, 90, 1024, 254, 1, False, 8, 40),  # C = 255 fills a u8 lane, warm-up from it
    (24, 40, 90, 256, 11, 2, False, 8, 6),    # u16 lanes, saturated
    (26, 30, 60, 256, 300, 2, True, 1, 7),    # u16 past 254 px, narrowest tile
]


@pytest.mark.parametrize("h, w, t, stride, mrp, itemsize, compact, words, lines", EMULATED,
                         ids=[f"{c[0]}x{c[1]}-T{c[2]}-s{c[3]}-{c[4]}px-u{8 * c[5]}-"
                              f"{'compact' if c[6] else 'dense'}-w{c[7]}-L{c[8]}" for c in EMULATED])
def test_emulated_kernel_equals_plain_and_jax(h, w, t, stride, mrp, itemsize, compact, words,
                                              lines):
    occ = _sparse_occ(h, w, h * w + mrp)
    dt = np.uint8 if itemsize == 1 else np.uint16
    if compact:
        clr = clearance_field(occ, mrp + FAR_ROW_MARGIN + 2)
        got, stats = _emulate(occ, t, mrp, stride, itemsize, words, lines, clr)
        plain, _ = build_compact_range_lut_device(torch.from_numpy(occ), clr, t, mrp, stride,
                                                  lut_dtype=dt)
        jax_lut, _ = build_compact_range_lut_jax(occ, clr, t, mrp, stride, lut_dtype=dt)
    else:
        got, stats = _emulate(occ, t, mrp, stride, itemsize, words, lines)
        plain = build_range_lut_device(torch.from_numpy(occ), t, mrp, stride, dt)
        jax_lut = build_range_lut_jax(occ, t, mrp, stride, dt)
    plain = plain.view(torch.int16) if dt == np.uint16 else plain
    want = plain.numpy().reshape(-1).astype(np.int64) & ((1 << (8 * itemsize)) - 1)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.asarray(jax_lut).reshape(-1).astype(np.int64))
    # the edges each case is for: chunks that start from a saturated
    # warm-up, and rays that cross the map far enough to saturate
    sat = mrp + 1
    assert (stats["warm_starts"] > 0) == any(f > sat for n in (h, w) for f in range(0, n, lines))
    assert (stats["saturated"] > 0) == (max(h, w) > sat)


def test_sat_inc_every_lane_value():
    """The carry-free increment on every lane value 0..C for every C of a
    u8 lane and a sample of u16 ones, beside random neighbour lanes."""
    rng = np.random.default_rng(0)
    for k, cs in ((4, range(1, 256)), (2, [1, 2, 255, 256, 508, 4096, 65535])):
        bits = 32 // k
        for c in cs:
            x = np.arange(c + 1, dtype=np.uint32)
            others = rng.integers(0, c + 1, (x.size, k), dtype=np.uint32)
            others[:, 0] = x
            words = np.bitwise_or.reduce(others << (np.arange(k, dtype=np.uint32) * bits), 1)
            c_word = c * _lane_masks(k)[1]
            got = _sat_inc(words.astype(np.uint32), c_word, k)
            lanes = (got[:, None] >> (np.arange(k, dtype=np.uint32) * bits)) & ((1 << bits) - 1)
            np.testing.assert_array_equal(lanes, np.minimum(others + 1, c))


def test_sweep_times_needs_a_card():
    """The parent/change timing tool refuses to run without a card, prints
    no result, and imports nothing of JAX."""
    import subprocess

    if torch.cuda.is_available():
        pytest.skip("a card is present: the tool would run in full")
    probe = ("import runpy, sys\n"
             "sys.argv = ['sweep_times.py']\n"
             "try:\n"
             "    runpy.run_path('monte_carlo_localization_tpu_torch/tools/sweep_times.py',"
             " run_name='__main__')\n"
             "except SystemExit as e:\n"
             "    assert 'jax' not in sys.modules, 'sweep_times.py imported jax'\n"
             "    sys.exit(e.code)\n")
    res = subprocess.run([sys.executable, "-c", probe], cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 2, res.stderr
    assert res.stdout == "" and "no CUDA device" in res.stderr
