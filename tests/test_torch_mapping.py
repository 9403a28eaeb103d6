"""The port's map loading and range-LUT builders against the JAX package.

Map arrays and LUT bytes must be equal: the port keeps the JAX package's
byte layout (``row_stride`` entries per row with wraparound padding) so
one LUT buffer serves both packages.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from monte_carlo_localization_tpu.mapping import load_map as j_load_map
from monte_carlo_localization_tpu.mapping import map_from_occupancy as j_map_from_occupancy
from monte_carlo_localization_tpu.mapping import random_obstacle_world
from monte_carlo_localization_tpu_torch.mapping import (
    GridMap,
    load_map,
    map_from_occupancy,
)
from monte_carlo_localization_tpu_torch.mapping.range_lut import (
    build_range_lut,
    cached_range_lut,
)

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _one_thread_private_lut_cache(monkeypatch, tmp_path):
    torch.set_num_threads(1)
    monkeypatch.setenv("MCL_LUT_CACHE", str(tmp_path / "lut_cache"))


def _maps(max_range_meters, resolution=0.05):
    occ = np.asarray(
        random_obstacle_world(height=72, width=96, num_obstacles=4, seed=5).occupancy
    )
    kw = dict(resolution=resolution, origin=(-1.25, 0.5, 0.0),
              max_range_meters=max_range_meters)
    return j_map_from_occupancy(occ, **kw), map_from_occupancy(occ, **kw, device="cpu")


def test_load_map_matches():
    path = REPO / "maps" / "map_1753950572.yaml"
    jm, tm = j_load_map(path), load_map(path, device="cpu")
    assert tm.device == torch.device("cpu")
    for name in ("occupancy", "occupied", "permissible", "clearance", "free_cells"):
        np.testing.assert_array_equal(getattr(tm, name).numpy(), np.asarray(getattr(jm, name)))
    assert tm.num_free == int(jm.num_free)
    assert (tm.max_range_px, tm.resolution, tm.name) == (jm.max_range_px, jm.resolution, jm.name)
    assert (tm.origin_x, tm.origin_y) == (float(jm.origin_x), float(jm.origin_y))


@pytest.mark.parametrize("max_range_meters", [0.92, 15.01], ids=["u8", "u16"])
def test_dense_lut_bit_equal(max_range_meters):
    jm, tm = _maps(max_range_meters)
    t, stride = 90, 1024
    want = np.asarray(jm.with_range_lut(t, use_cache=False, row_stride=stride).range_lut)
    got = tm.with_range_lut(t, use_cache=False, row_stride=stride)
    assert got.lut_row_map is None and got.row_stride == stride
    assert got.range_lut.numpy().dtype == want.dtype
    np.testing.assert_array_equal(got.range_lut.numpy(), want.reshape(-1))
    # the numpy fallback builds the same bytes
    occ = tm.occupied.numpy()
    np.testing.assert_array_equal(
        build_range_lut(occ, t, tm.max_range_px, backend="numpy", row_stride=stride).reshape(-1),
        want.reshape(-1),
    )


def test_cached_range_lut_roundtrip(tmp_path):
    _, tm = _maps(0.92)
    occ = tm.occupied.numpy()
    first = cached_range_lut(occ, 60, tm.max_range_px, cache_dir=tmp_path, row_stride=512)
    again = cached_range_lut(occ, 60, tm.max_range_px, cache_dir=tmp_path, row_stride=512)
    assert len(list(tmp_path.glob("rlut_*.npy"))) == 1
    np.testing.assert_array_equal(first, again)


@pytest.mark.parametrize("max_range_meters", [0.92, 15.01], ids=["u8", "u16"])
def test_compact_lut_bit_equal(max_range_meters):
    jm, tm = _maps(max_range_meters)
    t, stride = 90, 1024
    jc = jm.with_compact_range_lut(t, stride)
    tc = tm.with_compact_range_lut(t, stride)
    np.testing.assert_array_equal(tc.lut_row_map.numpy(), np.asarray(jc.lut_row_map))
    if tm.max_range_px < 100:  # the long-range map has no far cells
        assert (tc.lut_row_map.numpy() == 0).any(), "case must have far cells"
    np.testing.assert_array_equal(tc.range_lut.numpy(), np.asarray(jc.range_lut).reshape(-1))


def test_kernel_lut_dense_or_compact(monkeypatch):
    _, tm = _maps(0.92)
    assert tm.with_kernel_lut(90, 1024, 1).lut_row_map is None
    monkeypatch.setenv("MCL_LUT_DENSE_MAX", "1")
    assert tm.with_kernel_lut(90, 1024, 1).lut_row_map is not None


def test_from_numpy_carries_the_jax_map():
    jm, _ = _maps(0.92)
    jm = jm.with_range_lut(90, use_cache=False, row_stride=1024)
    tm = GridMap.from_numpy(
        occupancy=np.asarray(jm.occupancy), free_cells=np.asarray(jm.free_cells),
        num_free=int(jm.num_free), clearance=np.asarray(jm.clearance),
        origin_x=float(jm.origin_x), origin_y=float(jm.origin_y),
        resolution=jm.resolution, max_range_px=jm.max_range_px,
        range_lut=np.asarray(jm.range_lut), lut_theta_bins=jm.lut_theta_bins,
        lut_row_stride=jm.lut_row_stride, device="cpu",
    )
    assert tm.with_range_lut(90, row_stride=1024) is tm  # attached LUT reused
    np.testing.assert_array_equal(tm.permissible.numpy(), np.asarray(jm.permissible))
    with pytest.raises(ValueError, match="whole rows"):
        GridMap.from_numpy(
            occupancy=np.asarray(jm.occupancy), free_cells=np.asarray(jm.free_cells),
            num_free=1, clearance=np.asarray(jm.clearance), origin_x=0.0,
            origin_y=0.0, resolution=0.05, max_range_px=18,
            range_lut=np.zeros(1000, np.uint8), lut_theta_bins=90,
            lut_row_stride=1024, device="cpu",
        )
