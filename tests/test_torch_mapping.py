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
    # the host builder's fallback, the sweep's plain version, builds the same bytes
    occ = tm.occupied.numpy()
    np.testing.assert_array_equal(
        build_range_lut(occ, t, tm.max_range_px, backend="plain", row_stride=stride).reshape(-1),
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


SYNTHETIC = {
    "box_world": dict(height=50, width=70, wall=2, origin=(0.5, -0.25, 0.0)),
    "corridor_world": dict(height=40, width=160, corridor_half_width=8),
    "random_obstacle_world": dict(height=90, width=110, num_obstacles=9, seed=7),
}


@pytest.mark.parametrize("name", list(SYNTHETIC))
def test_synthetic_worlds_match_jax(name):
    import monte_carlo_localization_tpu.mapping as jmapping
    import monte_carlo_localization_tpu_torch.mapping as tmapping

    kw = SYNTHETIC[name]
    jm, tm = getattr(jmapping, name)(**kw), getattr(tmapping, name)(**kw, device="cpu")
    for field in ("occupancy", "occupied", "permissible", "clearance", "free_cells"):
        np.testing.assert_array_equal(getattr(tm, field).numpy(), np.asarray(getattr(jm, field)),
                                      err_msg=field)
    assert (tm.num_free, tm.name, tm.max_range_px, tm.resolution) == (
        int(jm.num_free), jm.name, jm.max_range_px, jm.resolution)
    assert (tm.origin_x, tm.origin_y) == (float(jm.origin_x), float(jm.origin_y))


def test_grid_helpers_match_jax():
    """``num_free_cells``, ``world_to_grid``, ``grid_to_world`` and
    ``with_padded_lut`` of the JAX ``GridMap`` (``grid_map.py:548-596``),
    on one map and on a stacked one."""
    from monte_carlo_localization_tpu.parallel import stack_maps as j_stack_maps
    from monte_carlo_localization_tpu_torch.parallel import stack_maps

    jm, tm = _maps(3.0)
    assert tm.num_free_cells == jm.num_free_cells
    j2, t2 = _maps(3.0)
    assert stack_maps([tm, t2]).num_free_cells == j_stack_maps([jm, j2]).num_free_cells
    rng = np.random.default_rng(4)
    x, y = rng.uniform(-3, 5, 16), rng.uniform(-2, 6, 16)
    # JAX computes in float32 (its origins are float32 arrays), the port in
    # float64 from the same float32 origins: equal to float32 rounding
    np.testing.assert_allclose(np.stack(tm.world_to_grid(x, y)),
                               np.stack(jm.world_to_grid(x, y)), rtol=1e-6, atol=0)
    row, col = rng.integers(0, 72, 16), rng.integers(0, 96, 16)
    np.testing.assert_allclose(np.stack(tm.grid_to_world(row, col)),
                               np.stack(jm.grid_to_world(row, col)), rtol=1e-6, atol=0)
    t, stride = 90, 256
    jl, tl = jm.with_range_lut(t, use_cache=False), tm.with_range_lut(t, use_cache=False)
    jp, tp = jl.with_padded_lut(stride), tl.with_padded_lut(stride)
    np.testing.assert_array_equal(tp.range_lut.numpy(), np.asarray(jp.range_lut).reshape(-1))
    assert tp.lut_row_stride == jp.lut_row_stride == stride and tp.row_stride == stride
    assert tp.with_padded_lut(stride) is tp
    with pytest.raises(ValueError, match="different stride"):
        tp.with_padded_lut(stride + 16)
    with pytest.raises(ValueError, match="attach a range LUT first"):
        tm.with_padded_lut(stride)


@pytest.mark.parametrize("device, backend, native, want", [
    ("cuda", "auto", True, "kernel"),
    ("cuda", "auto", False, "kernel"),
    ("cuda", "device", False, "kernel"),
    ("cuda", "native", True, "native"),
    ("cpu", "auto", True, "native"),
    ("cpu", "auto", False, "plain"),
    ("cpu", "device", True, "plain"),
    ("cpu", "native", True, "native"),
])
def test_lut_route_is_decided_before_any_launch(device, backend, native, want):
    """Where a LUT is built is a pure function of the device type, the
    backend and whether the native builder is there: every card map takes
    the kernel, whatever its shape."""
    from monte_carlo_localization_tpu_torch.mapping.grid_map import lut_route

    assert lut_route(device, backend, native) == want


def test_lut_route_refuses_what_it_cannot_build():
    from monte_carlo_localization_tpu_torch.mapping.grid_map import lut_route

    with pytest.raises(RuntimeError, match="native LUT builder unavailable"):
        lut_route("cuda", "native", False)
    with pytest.raises(ValueError, match="unknown LUT backend"):
        lut_route("cuda", "host")


@pytest.mark.parametrize("q_len, words, global_d", [
    (64, 8, False),
    (2000, 8, False),
    (3300, 4, False),
    (14_527, 1, False),
    (14_528, 8, True),
    (15_000, 8, True),
    (100_000, 8, True),
])
def test_sweep_line_layout_is_decided_by_length(q_len, words, global_d):
    """The sweep kernel keeps two lines of D in a block's shared memory up
    to MAX_LINE_CELLS cells a line, and in a global scratch past it (at
    the widest tile), decided from the line's length before any launch;
    a scratch block's two lines fit the launch's scratch cap."""
    from monte_carlo_localization_tpu_torch.ops.range_lut_sweep import (
        MAX_LINE_CELLS,
        SCRATCH_BYTES,
        SMEM_BYTES,
        d_bytes,
        line_layout,
        smem_bytes,
    )

    assert MAX_LINE_CELLS == 14_527
    assert line_layout(q_len) == (words, global_d)
    if global_d:
        assert smem_bytes(q_len, 1) > SMEM_BYTES and d_bytes(q_len, words) <= SCRATCH_BYTES
    else:
        assert smem_bytes(q_len, words) <= SMEM_BYTES


@pytest.mark.parametrize("compact", [False, True], ids=["dense", "compact"])
def test_every_group_goes_through_the_sweep_wrapper(monkeypatch, compact):
    """The device builders hand every bin group, row and column lines
    alike, to the kernel's wrapper (never to the plain sweep directly),
    whatever the lines' length; the LUT is bit-equal to the native
    builder's."""
    from monte_carlo_localization_tpu_torch import native
    from monte_carlo_localization_tpu_torch.mapping import clearance_field
    from monte_carlo_localization_tpu_torch.mapping.range_lut_device import (
        FAR_ROW_MARGIN,
        build_compact_range_lut_device,
        build_range_lut_device,
        compact_row_map,
        shear_groups,
    )
    from monte_carlo_localization_tpu_torch.native import native_build_compact_range_lut
    from monte_carlo_localization_tpu_torch.ops import range_lut_sweep

    if not native.available():
        pytest.skip("no C++ toolchain for the native oracle")
    _, tm = _maps(1.2)
    occ = tm.occupied  # 72 x 96
    wrapped = []

    def recording(occupied, rel, step_len, bins, forward, row_major, *a, **k):
        wrapped.append(occupied.shape[1] if row_major else occupied.shape[0])
        range_lut_sweep.sweep_group_reference(occupied, rel, step_len, bins, forward,
                                              row_major, *a, **k)

    monkeypatch.setattr(range_lut_sweep, "sweep", recording)
    t, stride, mrp = 90, 512, tm.max_range_px
    host = occ.numpy()
    if compact:
        clr = clearance_field(host, mrp + FAR_ROW_MARGIN + 2)
        got, row_map = build_compact_range_lut_device(occ, clr, t, mrp, stride)
        want = native_build_compact_range_lut(host, t, mrp, compact_row_map(clr, mrp)[0], stride)
    else:
        got = build_range_lut_device(occ, t, mrp, stride)
        want = build_range_lut(host, t, mrp, backend="native", row_stride=stride)
    groups = shear_groups(72, 96, t, stride)
    assert sorted(wrapped) == sorted(96 if g.row_major else 72 for g in groups)
    assert set(wrapped) == {72, 96}
    np.testing.assert_array_equal(got.numpy().reshape(-1), np.asarray(want).reshape(-1))
