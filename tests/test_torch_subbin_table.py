"""The sub-bin table of the port's K3 and the unique-window plan's window
keys, on the CPU.

K3 (the sub-bin heading lerp) makes the expected range a fraction, so its
kernel reads the beam model's normaliser from a table of cubic Hermite
segments, one per 1/2 px (``subbin_norm_table``, read by
``subbin_log_norm``). Its error against the analytic normaliser
(``_log_norm``) is held to the budget the kernels keep against their 1e-3
tolerance: at 1080 beams, ``r * inv_squash * max |error| <= 2.5e-4``. Its
nodes at integer ranges are the integer table's bits, so a whole-bin
heading reads K1's normaliser. The plain likelihood through the table is
held to the analytic one (atol 2.5e-4, that budget) and to the JAX
package's Pallas K3 in interpret mode (atol 2e-3, the JAX tests' bound).

The unique-window plan's key kernel (``window_keys``, its plain version)
must give ``dedup_plan``'s keys in 32 bits where they fit.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from monte_carlo_localization_tpu.ops import pallas_lut as jlut
from monte_carlo_localization_tpu_torch.ops import lut_query as tlut

MODEL = dict(z_hit=0.8, z_short=0.01, z_max=0.07, z_rand=0.12, sigma_hit=8.0, inv_squash=1 / 2.2)
BEAMS_60 = np.linspace(-2.35, 2.35, 60).astype(np.float32)
BEAMS_200 = np.linspace(-2.35, 2.35, 200).astype(np.float32)
H, W, RES = 24, 32, 0.05
BUDGET = 2.5e-4  # r * inv_squash * max |table error| at 1080 beams
TABLE_TOL = BUDGET / (1080 * MODEL["inv_squash"])  # 5.09e-7 per term


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _query(max_range_px, beams=BEAMS_60, **opts):
    dtype = np.uint8 if max_range_px <= 254 else np.uint16
    t = tlut.suggest_theta_bins(beams)
    stride = tlut.required_row_stride(t, beams, np.dtype(dtype).itemsize)
    return tlut.LUTQuery(t, beams, height=H, width=W, resolution=RES, origin_x=0.0,
                         origin_y=0.0, max_range_px=max_range_px, row_stride=stride,
                         lut_dtype=dtype, device="cpu", **{**MODEL, **opts})


def _dense_d(m):
    """Every node, a dense grid over [0, m] and ranges inside (0, h), the
    first segment, where the short term jumps."""
    h = 1.0 / tlut.SUBBIN_STEPS
    return torch.cat([
        torch.linspace(0.0, m, 200_001, dtype=torch.float32),
        torch.arange(0, tlut.SUBBIN_STEPS * m + 1, dtype=torch.float32) * h,
        torch.from_numpy(np.random.default_rng(1).uniform(0, h, 20_000).astype(np.float32)),
        torch.tensor([1e-30, 1e-7, 1e-3], dtype=torch.float32),
    ]).clamp(max=m)


@pytest.mark.parametrize("max_range_px", [200, 238, 400, 1023],
                         ids=["m200", "basement_m238", "u16_m400", "cap_m1023"])
def test_table_error_within_the_1080_beam_budget(max_range_px):
    q = _query(max_range_px, subbin=True)
    table = tlut.subbin_norm_table(q)
    assert q.subbin_table_entries == tlut.SUBBIN_STEPS * max_range_px + 1
    assert tuple(table.shape) == (q.subbin_table_entries, 4) and table.dtype == torch.float32
    assert bool(torch.isfinite(table).all())
    d = _dense_d(max_range_px)
    err = float((tlut.subbin_log_norm(table, d) - tlut._log_norm(q, d)).abs().max())
    assert err <= TABLE_TOL, err
    assert 1080 * q.inv_squash * err <= BUDGET
    # the wrapper's table on CPU tensors is this plain version, made once
    assert torch.equal(q.subbin_table("cpu"), table) and q.subbin_table("cpu") is q.subbin_table("cpu")
    assert q.subbin_table_launch_count == 0


def test_step_is_sized_by_its_error():
    """In float64, where rounding does not hide it: a linear table of the
    normaliser even at 1/16 px misses the per-term budget, while a cubic
    Hermite segment of 1/2 px stays under a tenth of it. The table's
    coefficient formulas are subbin_norm_table's, on exact values."""
    m, z_hit, z_short, z_max, z_rand, sq2 = 238.0, 0.8, 0.01, 0.07, 0.12, math.sqrt(2) * 8.0

    def g(d):  # log norm(d) with the short term on, exact erf
        gauss = 0.5 * (torch.special.erf((m - d + 0.5) / sq2) + torch.special.erf((d + 0.5) / sq2))
        return torch.log(z_hit * gauss + z_short * (d + 1.0) + z_max + z_rand)

    def slope(d):
        dgauss = (torch.exp(-((d + 0.5) / sq2) ** 2) - torch.exp(-((m - d + 0.5) / sq2) ** 2))
        return (z_hit * dgauss / (math.sqrt(math.pi) * sq2) + z_short) / torch.exp(g(d))

    d = torch.linspace(1e-9, m, 400_001, dtype=torch.float64)
    h = 1.0 / 16
    k = torch.ceil(d / h)
    t = k - d / h  # back from the node, as the kernels read
    linear = g(k * h) + t * (g((k - 1) * h) - g(k * h))
    h = 1.0 / tlut.SUBBIN_STEPS
    k = torch.ceil(d / h)
    s = k - d / h
    v1, v0 = g(k * h), g((k - 1) * h)
    a1, b1 = -h * slope(k * h), -h * slope((k - 1) * h)
    delta = v0 - v1
    cubic = v1 + s * (a1 + s * ((3 * delta - 2 * a1 - b1) + s * (b1 + a1 - 2 * delta)))
    assert float((linear - g(d)).abs().max()) > TABLE_TOL
    assert float((cubic - g(d)).abs().max()) < TABLE_TOL / 10


@pytest.mark.parametrize("max_range_px", [200, 238, 400])
def test_integer_nodes_are_the_integer_tables_bits(max_range_px):
    q = _query(max_range_px, subbin=True)
    table = tlut.subbin_norm_table(q)
    ints = tlut.log_norm_table(_query(max_range_px))[:, 0]  # K1's table at this m
    assert torch.equal(table[::tlut.SUBBIN_STEPS, 0], ints)
    d = torch.arange(max_range_px + 1, dtype=torch.float32)
    assert torch.equal(tlut.subbin_log_norm(table, d), ints)
    # every node, half-integers too, reads its own value: s = 0
    nodes = torch.arange(table.shape[0], dtype=torch.float32) / tlut.SUBBIN_STEPS
    assert torch.equal(tlut.subbin_log_norm(table, nodes), table[:, 0])


def test_short_term_jump_at_zero_is_not_smeared():
    """log norm jumps by ~log(1 + z_short / norm(0)) at d = 0: d = 0 reads
    log norm(0), any d > 0 of the first segment the limit from the right."""
    q = _query(200, subbin=True)
    table = tlut.subbin_norm_table(q)
    zero = torch.zeros(1)
    assert torch.equal(tlut.subbin_log_norm(table, zero), tlut._log_norm(q, zero))
    jump = float(tlut._log_norm_right(q, zero) - tlut._log_norm(q, zero))
    assert jump > 0.01
    d = torch.tensor([1e-30, 1e-6, 1e-3, 0.1, 0.25, 0.4999], dtype=torch.float32)
    got = tlut.subbin_log_norm(table, d)
    assert float((got - tlut._log_norm(q, d)).abs().max()) <= TABLE_TOL
    assert float((got[0] - tlut._log_norm(q, zero)).abs()) > 0.5 * jump


def test_which_ranges_take_the_table():
    """An integer max range of 1..1023 px takes the table; a fractional one
    or one past the cap keeps the analytic normaliser, as the integer
    table does past its cap. Only subbin queries have one."""
    assert tlut.subbin_table_entries(200) == 401
    assert tlut.subbin_table_entries(1023) == tlut.MAX_SUBBIN_ENTRIES == 2047
    assert tlut.subbin_table_entries(1024) == 0
    assert tlut.subbin_table_entries(198.4) == 0
    assert tlut.subbin_table_entries(0) == 0
    assert _query(200).subbin_table_entries == 0 and _query(200).subbin_table("cpu") is None
    for m in (198.4, 1500):
        q = _query(m, subbin=True)
        assert q.subbin_table_entries == 0 and q.subbin_table("cpu") is None
        assert q.kernel_table("cpu") == (None, 0)
        with pytest.raises(ValueError, match="no sub-bin table"):
            q.launch_subbin_norm()
        with pytest.raises(ValueError, match="no sub-bin table"):
            tlut.subbin_norm_table(q)
    q = _query(200, subbin=True)
    table, rows = q.kernel_table("cpu")
    assert rows == 401 and table is q.subbin_table("cpu")
    with pytest.raises(ValueError, match="CUDA"):
        q.launch_subbin_norm("cpu")


def _jax_and_port(beams, n, max_range_px):
    t = jlut.suggest_theta_bins(beams)
    dtype = np.uint8 if max_range_px <= 254 else np.uint16
    stride = jlut.required_row_stride(t, beams, itemsize=np.dtype(dtype).itemsize)
    kw = dict(height=H, width=W, resolution=RES, origin_x=0.0, origin_y=0.0,
              max_range_px=max_range_px, row_stride=stride, lut_dtype=dtype, **MODEL)
    jq, _ = jlut.build_lut_query_fn(t, beams, n, subbin=True, block=8, interpret=True, **kw)
    tq = tlut.LUTQuery(t, beams, subbin=True, device="cpu", **kw)
    return jq, tq, t, stride, dtype


@pytest.mark.parametrize("compact,max_range_px,beams", [
    (False, 120, BEAMS_60), (True, 400, BEAMS_60), (True, 120, BEAMS_200)],
    ids=["dense_u8_r60", "row_map_u16_r60", "row_map_u8_r200"])
def test_plain_k3_through_the_table_matches_analytic_and_pallas(compact, max_range_px, beams):
    rng = np.random.default_rng(max_range_px + len(beams) + compact)
    n = 24
    jq, tq, t, stride, dtype = _jax_and_port(beams, n, max_range_px)
    n_rows = H * W // 2 + 1 if compact else H * W
    base = rng.integers(0, max_range_px + 1, (n_rows, t)).astype(dtype)
    lut = np.tile(base, (1, -(-stride // t)))[:, :stride].reshape(-1).copy()
    row_map = rng.integers(0, n_rows, H * W).astype(np.int32) if compact else None
    parts = np.stack([rng.uniform(-0.1, W * RES + 0.1, n), rng.uniform(-0.1, H * RES + 0.1, n),
                      rng.uniform(-2 * math.pi, 2 * math.pi, n)], 1).astype(np.float32)
    obs = rng.uniform(0, max_range_px * 1.1, len(beams)).astype(np.float32)
    args = (torch.from_numpy(lut), torch.from_numpy(parts), torch.from_numpy(obs),
            None if row_map is None else torch.from_numpy(row_map))
    analytic = tlut.lut_log_weights_reference(tq, *args).numpy()
    tabled = tlut.lut_log_weights_reference(tq, *args, norm_table=tq.subbin_table("cpu")).numpy()
    want = np.asarray(jq(jnp.asarray(lut), jnp.asarray(parts), jnp.asarray(obs),
                         row_map=None if row_map is None else jnp.asarray(row_map)))
    assert 0 < int((analytic == -1e4).sum()) < n
    np.testing.assert_array_equal(tabled == -1e4, analytic == -1e4)
    np.testing.assert_allclose(tabled, analytic, rtol=0, atol=BUDGET)
    np.testing.assert_allclose(tabled, want, rtol=0, atol=2e-3)


def test_plain_k3_through_the_table_on_whole_bins_equals_k1_through_its_table():
    """At headings on a whole bin the lerp's fraction is 0: the sub-bin
    table gives the integer table's normaliser, so the bits of K1's plain
    version through its table."""
    rng = np.random.default_rng(7)
    qs, q = _query(200, subbin=True), _query(200)
    lut = torch.from_numpy(rng.integers(0, 201, H * W * q.row_stride).astype(np.uint8))
    k = rng.integers(-q.t_bins, q.t_bins, 400).astype(np.float32)
    theta = torch.from_numpy(k) / q.bin_scale
    bpos = theta * q.bin_scale
    keep = (bpos == torch.floor(bpos)) & (bpos == torch.round(bpos))
    n = int(keep.sum())
    assert n > 50
    parts = torch.stack([torch.from_numpy(rng.uniform(0.01, W * RES - 0.01, n).astype(np.float32)),
                         torch.from_numpy(rng.uniform(0.01, H * RES - 0.01, n).astype(np.float32)),
                         theta[keep]], 1)
    obs = torch.from_numpy(rng.uniform(0, 220, 60).astype(np.float32))
    got = tlut.lut_log_weights_reference(qs, lut, parts, obs, norm_table=qs.subbin_table("cpu"))
    want = tlut.lut_log_weights_reference(q, lut, parts, obs, norm_table=q.norm_table("cpu"))
    assert torch.equal(got, want)


def _cloud(rng, kind, q, n=400):
    x = rng.uniform(0.0, W * RES, n)
    y = rng.uniform(0.0, H * RES, n)
    if kind == "off_map":
        x[::3] = rng.uniform(-1.0, -0.01, len(x[::3]))
        y[1::5] = H * RES + rng.uniform(0.01, 1.0, len(y[1::5]))
    theta = rng.uniform(-2 * math.pi, 2 * math.pi, n)
    return torch.from_numpy(np.stack([x, y, theta], 1).astype(np.float32))


@pytest.mark.parametrize("subbin", [False, True], ids=["K4", "K3+K4"])
@pytest.mark.parametrize("kind", ["random", "compact_row_map", "off_map"])
def test_window_keys_are_the_plans_keys_in_32_bits(kind, subbin):
    rng = np.random.default_rng(len(kind) + subbin)
    q = _query(120, subbin=subbin, dedup_slots=8)
    parts = _cloud(rng, kind, q)
    row_map = None
    if kind == "compact_row_map":
        row_map = torch.from_numpy(rng.integers(0, H * W // 2, H * W).astype(np.int32))
    keys, starts, fracs = tlut.window_keys(q, parts, row_map)
    want = tlut.dedup_keys(q, parts, row_map)
    assert keys.dtype == torch.int32 and want.dtype == torch.int64
    assert torch.equal(keys.to(torch.int64), want)
    row, b0, frac, oob = tlut.window_start(q, parts, row_map)
    assert (kind == "off_map") == bool(oob.any())
    assert torch.equal(starts, torch.where(oob, -1, row * q.row_stride + b0.to(torch.int64)))
    assert torch.equal(keys.to(torch.int64)[~oob], starts[~oob] // q.eps)
    if subbin:
        assert torch.equal(fracs[~oob], frac[~oob]) and bool((fracs[oob] == 0).all())
    else:
        assert fracs is None
    # a slot stages every entry a window reads from its subrow, lerp included
    reach = starts[~oob] % q.eps + int(q.beam_offsets.max()) + 1
    assert int(reach.max()) < q.slot_entries <= q.window_entries
    assert q.slot_entries * q.lut_dtype.itemsize % tlut.STAGE_ALIGN == 0


def test_window_keys_past_32_bits_need_int64():
    """A compact LUT with more than 2^31 - 1 subrows would have keys past
    int32 (dedup_plan's int64 keys show them). Such a LUT is over 1 TB and
    fits no card: the plain version and the wrappers refuse it."""
    q = _query(120, dedup_slots=8)
    parts = _cloud(np.random.default_rng(3), "random", q, 64)
    row_map = torch.full((H * W,), 900_000_000, dtype=torch.int32)
    row_map[::2] = 7
    with pytest.raises(ValueError, match="int32"):
        tlut.window_keys(q, parts, row_map)
    assert int(tlut.dedup_keys(q, parts, row_map).max()) > tlut.INT32_MAX
    huge = torch.zeros(1, dtype=torch.uint8).expand((tlut.INT32_MAX + 1) * q.eps)
    obs = torch.zeros(q.num_beams)
    with pytest.raises(ValueError, match="int32"):
        q.launch_window_keys(huge, parts, row_map)
    with pytest.raises(ValueError, match="int32"):
        q.launch_dedup(huge, parts, obs, row_map)
