"""The normaliser table of the port's LUT kernels (``log_norm_table``,
``LUTQuery.norm_table``) on the CPU.

The kernels read ``log norm(d)`` of the beam model from a table indexed
by the LUT entry instead of evaluating two erf and a log per beam term.
Here its plain PyTorch version is held to the analytic normaliser of
``lut_log_weights_reference`` for every entry value (exact in float32:
the same expressions on the same values), the plain likelihood evaluated
through the table is held to the analytic path (atol 1e-6) and, like it,
to the JAX package's Pallas query in interpret mode (atol 2e-3, the JAX
tests' own bound for this kernel).
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from monte_carlo_localization_tpu_torch.ops import lut_query as tlut
from test_torch_lut_query import BEAMS_60, BEAMS_200, H, W, _lut_rows, _particles, _queries

MODEL = dict(z_hit=0.8, z_short=0.01, z_max=0.07, z_rand=0.12, sigma_hit=8.0, inv_squash=1 / 2.2)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _query(max_range_px, dtype, **opts):
    t = tlut.suggest_theta_bins(BEAMS_60)
    stride = tlut.required_row_stride(t, BEAMS_60, np.dtype(dtype).itemsize)
    return tlut.LUTQuery(t, BEAMS_60, height=H, width=W, resolution=0.05, origin_x=0.0,
                         origin_y=0.0, max_range_px=max_range_px, row_stride=stride,
                         lut_dtype=dtype, device="cpu", **MODEL, **opts)


@pytest.mark.parametrize("max_range_px,dtype", [(200, np.uint8), (400, np.uint16), (198.4, np.uint8)],
                         ids=["u8_m200", "u16_m400", "fractional_m198.4"])
def test_table_equals_analytic_normaliser_for_every_entry_value(max_range_px, dtype):
    q = _query(max_range_px, dtype)
    table = tlut.log_norm_table(q)
    last = math.ceil(max_range_px)
    assert q.table_entries == last + 1 and tuple(table.shape) == (last + 1, 2)
    assert table.dtype == torch.float32
    # every value an entry of this dtype can take, through the index the kernels use
    entries = torch.arange(np.iinfo(dtype).max + 1)
    d = torch.clamp(entries.to(torch.float32), max=q.m)
    row = table[torch.clamp(entries, max=last)]
    assert torch.equal(row[:, 0], tlut._log_norm(q, d))
    assert torch.equal(row[:, 1], 1.0 / torch.clamp(d, min=1.0))
    assert bool(torch.isfinite(table).all())
    # the wrapper's table on CPU tensors is this plain version, made once
    assert torch.equal(q.norm_table("cpu"), table) and q.norm_table("cpu") is q.norm_table("cpu")
    assert q.table_launch_count == 0


def test_queries_without_a_table():
    assert _query(200, np.uint8, subbin=True).table_entries == 0
    assert _query(200, np.uint8, subbin=True).norm_table("cpu") is None
    past_cap = _query(tlut.MAX_TABLE_ENTRIES, np.uint16)  # ceil(m) + 1 entries: one too many
    assert past_cap.table_entries == 0 and past_cap.norm_table("cpu") is None
    assert _query(tlut.MAX_TABLE_ENTRIES - 1, np.uint16).table_entries == tlut.MAX_TABLE_ENTRIES
    with pytest.raises(ValueError, match="no normaliser table"):
        past_cap.launch_log_norm()
    with pytest.raises(ValueError, match="CUDA"):
        _query(200, np.uint8).launch_log_norm()


@pytest.mark.parametrize("compact", [False, True], ids=["dense", "row_map"])
@pytest.mark.parametrize("max_range_px", [120, 400], ids=["u8", "u16"])
@pytest.mark.parametrize("beams", [BEAMS_60, BEAMS_200], ids=["r60_K2", "r200_K1"])
def test_plain_likelihood_through_table_matches_analytic_and_pallas(beams, max_range_px, compact):
    """The parity cases of test_torch_lut_query.py, read through the table."""
    rng = np.random.default_rng(len(beams) * 7 + max_range_px + compact)
    n = 24
    jq, tq, t, stride = _queries(beams, n, max_range_px)
    if compact:
        n_rows = H * W // 2 + 1
        row_map = rng.integers(0, n_rows, size=H * W).astype(np.int32)
    else:
        n_rows, row_map = H * W, None
    lut = _lut_rows(rng, n_rows, stride, t, max_range_px).reshape(-1)
    parts = _particles(rng, n)
    obs = rng.uniform(0, max_range_px * 1.1, len(beams)).astype(np.float32)
    args = (torch.from_numpy(lut), torch.from_numpy(parts), torch.from_numpy(obs),
            None if row_map is None else torch.from_numpy(row_map))
    analytic = tlut.lut_log_weights_reference(tq, *args).numpy()
    tabled = tlut.lut_log_weights_reference(tq, *args, norm_table=tq.norm_table("cpu")).numpy()
    want = np.asarray(jq(jnp.asarray(lut), jnp.asarray(parts), jnp.asarray(obs),
                         row_map=None if row_map is None else jnp.asarray(row_map)))
    np.testing.assert_array_equal(tabled == -1e4, analytic == -1e4)
    np.testing.assert_allclose(tabled, analytic, rtol=0, atol=1e-6)
    np.testing.assert_allclose(tabled, want, rtol=0, atol=2e-3)


def test_entries_above_max_range_read_the_last_row():
    """u16 entries far past ceil(m) clip to m on both paths."""
    rng = np.random.default_rng(3)
    _, tq, t, stride = _queries(BEAMS_60, 8, 400)
    lut = rng.integers(0, 65536, size=H * W * stride).astype(np.uint16)
    parts = _particles(rng, 24)
    obs = rng.uniform(0, 440, 60).astype(np.float32)
    args = (torch.from_numpy(lut), torch.from_numpy(parts), torch.from_numpy(obs))
    analytic = tlut.lut_log_weights_reference(tq, *args)
    tabled = tlut.lut_log_weights_reference(tq, *args, norm_table=tlut.log_norm_table(tq))
    assert float((tabled - analytic).abs().max()) <= 1e-6


def test_table_needs_integer_entries():
    tq = _query(200, np.uint8, subbin=True)
    lut = torch.zeros(H * W * tq.row_stride, dtype=torch.uint8)
    parts = torch.from_numpy(_particles(np.random.default_rng(0), 8))
    with pytest.raises(ValueError, match="no integer table index"):
        tlut.lut_log_weights_reference(tq, lut, parts, torch.ones(60),
                                       norm_table=tlut.log_norm_table(tq))


def test_fleet_plain_likelihood_through_table_matches_analytic():
    rng = np.random.default_rng(4)
    t = tlut.suggest_theta_bins(BEAMS_60)
    stride = tlut.required_row_stride(t, BEAMS_60, 1)
    q = tlut.LUTQuery(t, BEAMS_60, height=H, width=W, resolution=0.05, origin_x=-0.3,
                      origin_y=0.2, max_range_px=120, row_stride=stride, num_members=3,
                      device="cpu", **MODEL)
    lut = torch.from_numpy(_lut_rows(rng, H * W, stride, t, 120).reshape(-1))
    parts = torch.from_numpy(_particles(rng, 24))
    obs = torch.from_numpy(rng.uniform(0, 130, (3, 60)).astype(np.float32))
    tables = q.fleet_tables(parts, obs)
    analytic = tlut.lut_log_weights_reference(q, lut, parts, obs, None, tables)
    tabled = tlut.lut_log_weights_reference(q, lut, parts, obs, None, tables,
                                            norm_table=q.norm_table("cpu"))
    assert float((tabled - analytic).abs().max()) <= 1e-6
