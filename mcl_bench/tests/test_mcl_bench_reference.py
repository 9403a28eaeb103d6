"""The reference against small cases worked by hand, and its LUT entries
against the program's plain LUT sweep on the CPU."""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from mcl_bench.reference.lut import RangeOracle, beam_offsets, theta_bins
from mcl_bench.reference.mapio import RefMap
from mcl_bench.reference.model import OOB_LOG_WEIGHT, Params, Reference

torch.set_num_threads(1)


def _wall_map() -> np.ndarray:
    occ = np.zeros((6, 8), bool)
    occ[:, 6] = True  # a wall along column 6
    return occ


@pytest.mark.parametrize("cell, t_bin, want", [
    ((2, 1), 0, 4),   # east: cells 1..5 free, the wall 5 cells on: 5 * 1 - 1
    ((2, 6), 0, 0),   # on the wall
    ((2, 1), 4, 1),   # west: cells 1, 0, then the edge: 2 - 1
    ((0, 1), 2, 5),   # north: six free rows to the edge: 6 - 1
    ((5, 3), 6, 5),   # south from the top row
])
def test_entries_count_free_cells_along_the_bin_minus_one(cell, t_bin, want):
    o = RangeOracle(_wall_map(), 8, 20, "cpu")
    y, x = cell
    got = o.entries(torch.tensor([y]), torch.tensor([x]), torch.tensor([t_bin]))
    assert got.tolist() == [want]


def test_entries_saturate_at_the_max_range():
    o = RangeOracle(np.zeros((40, 40), bool), 8, 10, "cpu")
    assert o.entries(torch.tensor([0]), torch.tensor([0]), torch.tensor([0])).tolist() == [10]


def test_entries_equal_the_programs_plain_lut_sweep():
    from monte_carlo_localization_tpu_torch.mapping.range_lut_device import (
        build_range_lut_device,
    )

    rng = np.random.default_rng(4)
    occ = rng.random((23, 31)) < 0.12
    t, maxr = 96, 30
    lut = build_range_lut_device(torch.from_numpy(occ), t, maxr, plain=True).numpy()
    o = RangeOracle(occ, t, maxr, "cpu")
    y, x, b = np.meshgrid(np.arange(23), np.arange(31), np.arange(t), indexing="ij")
    got = o.entries(torch.from_numpy(y.ravel()), torch.from_numpy(x.ravel()),
                    torch.from_numpy(b.ravel()))
    assert np.array_equal(got.numpy().astype(np.int64), lut.reshape(-1).astype(np.int64))


def test_beam_geometry_of_sixty_beams_over_270_degrees():
    beams = (-0.75 * math.pi + np.arange(1080) * 1.5 * math.pi / 1079)[::18].astype(np.float32)
    t = theta_bins(beams)
    base, off = beam_offsets(beams, t)
    assert np.all(np.diff(off) > 0) and off[0] == 0
    assert (base + off[-1] - (base + off[0])) == pytest.approx(0.75 * t * 59 / 60, abs=2)


def _reference(n: int = 4) -> Reference:
    occ = np.zeros((20, 20), bool)
    occ[:, 15] = True
    m = RefMap(occupied=occ, free_cells=np.argwhere(~occ), resolution=0.1, origin_x=0.0,
               origin_y=0.0, max_range_px=30)
    p = Params(num_particles=n, z_hit=0.8, z_short=0.01, z_max=0.07, z_rand=0.12,
               sigma_hit=2.0, squash_factor=2.2, dispersion=(0.05, 0.025, 0.25), angle_step=1)
    beams = np.linspace(-0.1, 0.1, 9).astype(np.float32)
    return Reference(m, beams, p, "cpu")


def test_ancestors_of_uniform_and_one_hot_weights():
    ref = _reference()
    lw = torch.zeros(8)
    assert ref.ancestors(lw, torch.tensor(0.5)).tolist() == list(range(8))
    one = torch.full((8,), -1e4)
    one[5] = 0.0
    assert ref.ancestors(one, torch.tensor(0.3)).tolist() == [5] * 8


def test_motion_of_standing_still_and_of_a_straight_step():
    ref = _reference()
    p = torch.tensor([[1.0, 2.0, 0.3], [0.5, 0.5, -2.0]])
    zero = torch.zeros(2, 3)
    assert torch.allclose(ref.motion(p, torch.zeros(3), zero), p, atol=1e-6)  # heading re-wrapped
    moved = ref.motion(p, torch.tensor([0.05, 0.0, 0.0]), zero)
    want = p[:, 0] + 0.05 * torch.cos(p[:, 2])
    assert torch.allclose(moved[:, 0], want) and torch.allclose(moved[:, 2], p[:, 2])
    noisy = ref.motion(p, torch.zeros(3), torch.ones(2, 3))
    assert torch.allclose(noisy[:, :2] - p[:, :2], torch.tensor([[0.05, 0.025]] * 2))


def test_the_beam_model_peaks_where_the_scan_agrees_and_floors_off_the_map():
    ref = _reference()
    # from (0.55, 1.05) facing east the wall at column 15 is 10 cells off: entry 9 px
    p = torch.tensor([[0.55, 1.05, 0.0], [1.0, 1.9, 0.0], [-1.0, 1.0, 0.0]])
    gy, gx, b0, oob = ref.windows(p)
    assert oob.tolist() == [False, False, True]
    d = ref.oracle.entries(gy[:1], gx[:1], torch.tensor([0]))
    assert d.tolist() == [9.0]
    scores = [float(ref.loglik(p[:1], torch.full((9,), v))[0]) for v in (3.0, 9.0, 20.0)]
    assert scores[1] > scores[0] and scores[1] > scores[2]
    assert float(ref.loglik(p, torch.full((9,), 9.0))[2]) == OOB_LOG_WEIGHT


def test_the_pose_is_the_weighted_mean():
    p = torch.tensor([[0.0, 0.0, 0.1], [2.0, 4.0, 3.0], [1.0, 1.0, -3.0]])
    lw = torch.tensor([-1e4, 0.0, -1e4], dtype=torch.float64)
    assert torch.allclose(Reference.pose(p, lw), p[1].double())
    even = Reference.pose(p[:2], torch.zeros(2, dtype=torch.float64))
    assert torch.allclose(even[:2], torch.tensor([1.0, 2.0], dtype=torch.float64))
