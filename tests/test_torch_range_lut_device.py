"""The port's range-LUT builders (``mapping/range_lut_device.py``: the shear
sweep of ``ops/range_lut_sweep.py``, here its plain version on the CPU)
against the JAX package's device builders and the port's native host
builder, bit for bit.

Dense: ``build_range_lut_jax`` at stride T and padded, u8 (18 px) and
u16 (300 px). Compact: ``build_compact_range_lut_jax``, its tiled output
reshaped to the port's flat ``(K + 1) * stride`` layout, and the native
compact builder. Member blocks written in place (``out=``/``row_base=``)
equal separate builds, and the GridMap routes (plain against native) give
the same buffers. The five ``ValueError``s of the JAX compact builder
hold. The JAX builders run on the CPU, as ``tests/test_range_lut_device.py``
runs them.
"""

import numpy as np
import pytest
import torch

from monte_carlo_localization_tpu.mapping import random_obstacle_world
from monte_carlo_localization_tpu.mapping.range_lut_device import (
    build_compact_range_lut_jax,
    build_range_lut_jax,
)
from monte_carlo_localization_tpu_torch.mapping import clearance_field, map_from_occupancy
from monte_carlo_localization_tpu_torch.mapping.range_lut_device import (
    FAR_ROW_MARGIN,
    build_compact_range_lut_device,
    build_range_lut_device,
    compact_row_map,
    shear_groups,
)
from monte_carlo_localization_tpu_torch.native import (
    native_build_compact_range_lut,
    native_build_range_lut,
)
from monte_carlo_localization_tpu_torch.ops.range_lut_sweep import sweep
from monte_carlo_localization_tpu_torch.parallel import stack_maps


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _occ(hw, seed):
    """A seeded world of 3 obstacles; seed 0 an empty box (cells far from
    every wall share the compact LUT's far row)."""
    world = random_obstacle_world(height=hw[0], width=hw[1], num_obstacles=3 if seed else 0,
                                  seed=seed)
    return np.array(world.occupied)


def _np_dtype(mrp):
    return np.uint8 if mrp <= 254 else np.uint16


CASES = [((40, 56), 90, 0, 18, 1), ((40, 56), 90, 1024, 300, 2), ((64, 64), 64, 512, 18, 3),
         ((64, 64), 64, 0, 300, 4), ((40, 56), 90, 1024, 18, 5), ((72, 72), 90, 1024, 18, 0)]


@pytest.mark.parametrize("hw, t, stride, mrp, seed", CASES,
                         ids=[f"{c[0][0]}x{c[0][1]}-T{c[1]}-s{c[2] or c[1]}-{c[3]}px"
                              for c in CASES])
def test_dense_builder_equals_jax_and_native(hw, t, stride, mrp, seed):
    occ = _occ(hw, seed)
    want = np.asarray(build_range_lut_jax(occ, t, mrp, stride, _np_dtype(mrp)))
    launches = sweep.launch_count
    got = build_range_lut_device(torch.from_numpy(occ), t, mrp, stride)
    assert sweep.launch_count == launches  # CPU tensors: the plain version
    assert got.shape == want.shape == (*hw, stride or t)
    assert got.numpy().dtype == want.dtype
    np.testing.assert_array_equal(got.numpy(), want)
    native = native_build_range_lut(occ, t, mrp, dtype=_np_dtype(mrp))
    np.testing.assert_array_equal(got.numpy()[..., :t], native)
    # the padded tail repeats the bins: entry b is bin b % T
    np.testing.assert_array_equal(got.numpy(), np.take(native, np.arange(stride or t) % t, 2))


@pytest.mark.parametrize("hw, t, stride, mrp, seed",
                         [c for c in CASES if c[2]],
                         ids=[f"{c[0][0]}x{c[0][1]}-T{c[1]}-s{c[2]}-{c[3]}px" for c in CASES if c[2]])
def test_compact_builder_equals_jax_and_native(hw, t, stride, mrp, seed):
    occ = _occ(hw, seed)
    clr = clearance_field(occ, mrp + FAR_ROW_MARGIN + 2)
    dt = _np_dtype(mrp)
    jl, jrm = build_compact_range_lut_jax(occ, clr, t, mrp, stride, lut_dtype=dt)
    lut, rm = build_compact_range_lut_device(torch.from_numpy(occ), clr, t, mrp, stride,
                                             lut_dtype=dt)
    np.testing.assert_array_equal(rm, jrm)
    k = int(rm.max())
    assert lut.shape == ((k + 1) * stride,) and 0 < k <= occ.size
    assert seed or k < occ.size  # the empty box has far cells
    np.testing.assert_array_equal(lut.numpy(), np.asarray(jl).reshape(-1))
    np.testing.assert_array_equal(
        lut.numpy(), native_build_compact_range_lut(occ, t, mrp, rm, stride, dtype=dt).reshape(-1))
    assert (lut.numpy()[:stride] == mrp).all()  # the far row


@pytest.mark.parametrize("mrp", [18, 300], ids=["u8", "u16"])
def test_member_blocks_in_one_buffer_equal_separate_builds(mrp):
    dt, stride, t = _np_dtype(mrp), 1024, 90
    occs = [_occ((40, 56), 6), _occ((48, 40), 7)]
    clrs = [clearance_field(o, mrp + FAR_ROW_MARGIN + 2) for o in occs]
    rows = [int(compact_row_map(c, mrp)[1].size) + 1 for c in clrs]
    torch_dt = torch.uint8 if mrp <= 254 else torch.uint16
    out = torch.full(((sum(rows) + 3) * stride,), mrp, dtype=torch_dt)
    bases = [2, 2 + rows[0]]
    for o, c, b in zip(occs, clrs, bases):
        got, _ = build_compact_range_lut_device(torch.from_numpy(o), c, t, mrp, stride, out=out,
                                                row_base=b, lut_dtype=dt)
        assert got is out
    flat = out.numpy()
    assert (flat[: 2 * stride] == mrp).all() and (flat[-stride:] == mrp).all()
    for o, c, b, n in zip(occs, clrs, bases, rows):
        alone, _ = build_compact_range_lut_device(torch.from_numpy(o), c, t, mrp, stride,
                                                  lut_dtype=dt)
        np.testing.assert_array_equal(flat[b * stride:(b + n) * stride], alone.numpy())
    dense = torch.empty((40 * 56 + 48 * 40) * stride, dtype=torch_dt)
    build_range_lut_device(torch.from_numpy(occs[0]), t, mrp, stride, out=dense)
    build_range_lut_device(torch.from_numpy(occs[1]), t, mrp, stride, out=dense,
                           row_base=40 * 56)
    np.testing.assert_array_equal(
        dense.numpy()[40 * 56 * stride:],
        build_range_lut_device(torch.from_numpy(occs[1]), t, mrp, stride).reshape(-1).numpy())


def test_compact_builder_raises_as_jax():
    occ = _occ((40, 56), 8)
    clr = clearance_field(occ, 22)
    o = torch.from_numpy(occ)
    rows = int(compact_row_map(clr, 18)[1].size) + 1
    with pytest.raises(ValueError, match="unsupported LUT dtype"):
        build_compact_range_lut_device(o, clr, 90, 18, 1024, lut_dtype=np.float32)
    with pytest.raises(ValueError, match="multiple of 512"):
        build_compact_range_lut_device(o, clr, 90, 18, 1000)
    buf = torch.full((rows * 1024,), 18, dtype=torch.uint8)
    with pytest.raises(ValueError, match="exceeds the buffer"):
        build_compact_range_lut_device(o, clr, 90, 18, 1024, out=buf, row_base=1)
    with pytest.raises(ValueError, match="exceeds the buffer"):
        build_compact_range_lut_device(o, clr, 90, 18, 1024, out=buf, row_base=-1)
    with pytest.raises(ValueError, match="whole rows of row_stride"):
        build_compact_range_lut_device(o, clr, 90, 18, 1024,
                                       out=torch.full((rows, 2048), 18, dtype=torch.uint8))
    with pytest.raises(ValueError, match="dtype"):
        build_compact_range_lut_device(o, clr, 90, 18, 1024,
                                       out=torch.full((rows * 1024,), 18, dtype=torch.uint16))
    # the JAX builder raises on the first two as well
    for kw in (dict(lut_dtype=np.float32), dict(row_stride=1000)):
        args = dict(row_stride=1024) | kw
        with pytest.raises(ValueError):
            build_compact_range_lut_jax(occ, clr, 90, 18, **args)


def test_shear_tables_are_the_jax_tables():
    groups = shear_groups(40, 56, 90, 1024)
    bins = np.sort(np.concatenate([g.bins for g in groups]))
    np.testing.assert_array_equal(bins, np.arange(1024))  # every physical bin once
    assert len(groups) == 4
    for g in groups:
        assert g.rel.dtype == np.int8 and set(np.unique(g.rel)) <= {-1, 0, 1}
        assert g.rel.shape == ((40 if g.row_major else 56), len(g.bins))
        assert g.step_len.dtype == np.float32 and (g.step_len >= 1.0).all()


def test_gridmap_routes_give_one_buffer(monkeypatch, tmp_path):
    """On a CPU map the native builder is the route; without it (and for
    the dense LUTs with ``backend="device"``) the sweep's plain version
    is; both give the same bits, for the dense, compact and both member
    LUTs."""
    from monte_carlo_localization_tpu_torch import native

    monkeypatch.setenv("MCL_LUT_CACHE", str(tmp_path))
    occ = np.where(_occ((48, 64), 9), 100, 0).astype(np.int8)
    gm = map_from_occupancy(occ, resolution=0.05, max_range_meters=0.9, device="cpu")
    fleet = stack_maps([gm, map_from_occupancy(occ[:40, :50], resolution=0.05,
                                               max_range_meters=0.9, device="cpu")])
    attaches = (lambda: gm.with_range_lut(90, row_stride=1024),
                lambda: gm.with_compact_range_lut(90, 1024),
                lambda: fleet.with_member_luts(90, 1024, 512),
                lambda: fleet.with_member_compact_luts(90, 1024, 512))
    built = [attach() for attach in attaches]
    with monkeypatch.context() as m:
        m.setattr(native, "available", lambda: False)
        plain = [attach() for attach in attaches]
    for got, want in zip(plain, built):
        assert (want.lut_route, got.lut_route) == ("native", "plain")
        assert want.lut_build_s >= 0 and got.lut_build_s >= 0
        for field in ("range_lut", "lut_row_map", "lut_member_base", "lut_row_map_base"):
            a, b = getattr(got, field), getattr(want, field)
            assert (a is None and b is None) or torch.equal(a, b), field
    device = gm.with_range_lut(90, row_stride=1024, backend="device")
    assert device.lut_route == "plain" and torch.equal(device.range_lut, built[0].range_lut)
    stacked = fleet.with_range_lut(90, backend="device")
    assert stacked.range_lut.numel() == 2 * 48 * 64 * 90 and stacked.lut_member_base is None
    assert torch.equal(stacked.range_lut[: 48 * 64 * 90],
                       gm.with_range_lut(90, backend="device").range_lut)
    with pytest.raises(ValueError, match="unknown LUT backend"):
        gm.with_range_lut(90, backend="numpy")


def test_host_builder_falls_back_to_the_plain_sweep(monkeypatch):
    """Without the native library ``build_range_lut`` (``auto``) builds
    with the sweep's plain version, the same bytes as the native builder,
    padded rows included; ``native`` then raises."""
    from monte_carlo_localization_tpu_torch import native
    from monte_carlo_localization_tpu_torch.mapping.range_lut import build_range_lut

    occ = _occ((40, 56), 7)
    want = build_range_lut(occ, 90, 300, backend="native", row_stride=1024)
    monkeypatch.setattr(native, "native_build_range_lut", lambda *a, **k: None)
    got = build_range_lut(occ, 90, 300, row_stride=1024)
    assert got.dtype == want.dtype == np.uint16 and got.shape == (40, 56, 1024)
    np.testing.assert_array_equal(got, want)
    with pytest.raises(RuntimeError, match="native LUT builder unavailable"):
        build_range_lut(occ, 90, 300, backend="native")
    with pytest.raises(ValueError, match="unknown LUT backend"):
        build_range_lut(occ, 90, 300, backend="numpy")
