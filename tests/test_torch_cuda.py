"""The CUDA kernels (LUT likelihood with and without the sub-bin lerp, its
normaliser tables, unique-window LUT likelihood with its key kernel, mega
step) against their plain PyTorch versions, on a card. Skipped without one. This file imports no jax, so it also runs on a
GPU machine without the JAX package's dependencies:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerance: atol 1e-3. Both sides evaluate the same float32 expressions;
they differ by the kernel's fused multiply-adds, CUDA's expf/logf and
the order of the beam sum. The unique-window kernel must equal the LUT
kernel bit for bit. The mega step also resamples from a weight CDF
summed in another order, so at least 99% of its proposal rows must agree
within 1e-5 and the log weights within 1e-3 on those rows; its moment
sums hold relative 1e-4.
"""

import math

import numpy as np
import pytest
import torch

from monte_carlo_localization_tpu_torch.ops.lut_query import (
    LUTQuery,
    lut_dedup_reference,
    lut_log_weights_reference,
    required_row_stride,
    suggest_theta_bins,
)

pytestmark = pytest.mark.cuda
H, W, RES, OX, OY = 64, 80, 0.05, -1.0, 0.5


@pytest.fixture
def cuda():
    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _case(rng, beams, max_range_px, compact, n, device, **opts):
    dtype = np.uint8 if max_range_px <= 254 else np.uint16
    t = suggest_theta_bins(beams)
    stride = required_row_stride(t, beams, np.dtype(dtype).itemsize)
    q = LUTQuery(
        t, beams, height=H, width=W, resolution=RES, origin_x=OX, origin_y=OY,
        max_range_px=max_range_px, row_stride=stride, z_hit=0.8, z_short=0.01,
        z_max=0.07, z_rand=0.12, sigma_hit=8.0, inv_squash=1 / 2.2,
        lut_dtype=dtype, device=device, **opts,
    )
    n_rows = H * W // 3 + 1 if compact else H * W
    base = rng.integers(0, max_range_px + 1, (n_rows, t)).astype(dtype)
    lut = np.tile(base, (1, -(-stride // t)))[:, :stride].reshape(-1)
    row_map = rng.integers(0, n_rows, H * W).astype(np.int32) if compact else None
    x = rng.uniform(OX - 0.3, OX + W * RES + 0.3, n)  # some off the map
    y = rng.uniform(OY - 0.3, OY + H * RES + 0.3, n)
    theta = rng.uniform(-2 * math.pi, 2 * math.pi, n)
    parts = np.stack([x, y, theta], 1).astype(np.float32)
    obs = rng.uniform(0, max_range_px * 1.1, len(beams)).astype(np.float32)
    to = lambda a: None if a is None else torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return q, to(lut), to(parts), to(obs), to(row_map)


@pytest.mark.parametrize("compact", [False, True], ids=["dense", "row_map"])
@pytest.mark.parametrize("max_range_px", [200, 400], ids=["u8", "u16"])
@pytest.mark.parametrize("num_beams", [60, 1080])
def test_kernel_matches_plain_version(cuda, num_beams, max_range_px, compact):
    rng = np.random.default_rng(num_beams + max_range_px + compact)
    beams = (-0.75 * np.pi + np.arange(num_beams) * 1.5 * np.pi / (num_beams - 1)).astype(np.float32)
    q, lut, parts, obs, row_map = _case(rng, beams, max_range_px, compact, 4000, cuda)
    got = q(lut, parts, obs, row_map=row_map)
    want = lut_log_weights_reference(q, lut, parts, obs, row_map=row_map)
    torch.cuda.synchronize()
    assert q.launch_count == 1
    assert bool(((got == -1e4) == (want == -1e4)).all())
    assert 0 < int((want == -1e4).sum()) < 4000
    assert float((got - want).abs().max()) <= 1e-3


def _beams(num_beams):
    return (-0.75 * np.pi + np.arange(num_beams) * 1.5 * np.pi / max(num_beams - 1, 1)).astype(np.float32)


# shapes the kernel's layout makes edge cases: a lane group holds 16 lanes
# up to 64 beams and 32 past them, a block 8 or 16 groups, and a group
# takes up to as many consecutive particles as it has lanes
@pytest.mark.parametrize("n", [1, 7, 4001])
@pytest.mark.parametrize("num_beams", [1, 31, 33, 60, 64, 65])
def test_kernel_edge_shapes_match_plain_version(cuda, num_beams, n):
    rng = np.random.default_rng(100 * num_beams + n)
    for max_range_px, compact, subbin in ((200, False, False), (400, True, False), (200, True, True)):
        q, lut, parts, obs, row_map = _case(rng, _beams(num_beams), max_range_px, compact, n,
                                            cuda, subbin=subbin)
        if n == 4001:
            parts[:, 0].clamp_(OX + 0.1, OX + W * RES - 0.1)  # all on the map but a few
            parts[::97, 0] = OX - 1.0
        got = q(lut, parts, obs, row_map=row_map)
        want = lut_log_weights_reference(q, lut, parts, obs, row_map=row_map)
        torch.cuda.synchronize()
        assert bool(((got == -1e4) == (want == -1e4)).all())
        assert float((got - want).abs().max()) <= 1e-3


def test_kernel_many_particles_per_lane_group(cuda):
    """Enough particles that a lane group takes several: every particle
    still gets its own window and the ragged last block its own count."""
    rng = np.random.default_rng(31)
    for num_beams, n in ((60, 300_007), (1080, 70_001)):
        q, lut, parts, obs, row_map = _case(rng, _beams(num_beams), 200, True, n, cuda)
        got = q(lut, parts, obs, row_map=row_map)
        want = lut_log_weights_reference(q, lut, parts, obs, row_map=row_map)
        torch.cuda.synchronize()
        assert bool(((got == -1e4) == (want == -1e4)).all())
        assert float((got - want).abs().max()) <= 1e-3


def test_u16_entries_above_max_range_read_the_last_table_row(cuda):
    rng = np.random.default_rng(32)
    q, lut, parts, obs, row_map = _case(rng, _beams(60), 400, False, 4000, cuda)
    big = torch.from_numpy(rng.integers(401, 65536, lut.numel() // 3).astype(np.uint16)).to(cuda)
    lut.view(torch.int16)[::3][: big.numel()] = big.view(torch.int16)
    got = q(lut, parts, obs)
    want = lut_log_weights_reference(q, lut, parts, obs)
    torch.cuda.synchronize()
    assert q.table_entries == 401
    assert float((got - want).abs().max()) <= 1e-3


@pytest.mark.parametrize("num_beams", [60, 1080])
def test_range_past_the_table_cap_stays_analytic(cuda, num_beams):
    """max_range_px 2000 has no table: the LUT kernel, the unique-window
    kernel (bit-equal to it) and the mega step evaluate the normaliser."""
    from monte_carlo_localization_tpu_torch.ops.mega_step import mega_step_reference

    rng = np.random.default_rng(40 + num_beams)
    q, lut, parts, obs, row_map = _case(rng, _beams(num_beams), 2000, True, 4000, cuda,
                                        dedup_slots=8, block=64)
    assert q.table_entries == 0
    got = q.launch(lut, parts, obs, row_map)
    want = lut_log_weights_reference(q, lut, parts, obs, row_map=row_map)
    assert float((got - want).abs().max()) <= 1e-3
    assert torch.equal(q(lut, parts, obs, row_map=row_map), got) and q.dedup_launch_count == 1
    # the sub-bin lerp past the cap, and at a range that is not an integer
    for max_range_px in (2000, 198.4):
        qs, lut, parts, obs, row_map = _case(rng, _beams(num_beams), max_range_px, True, 4000,
                                             cuda, subbin=True, dedup_slots=8, block=64)
        assert qs.subbin_table_entries == 0
        got = qs.launch(lut, parts, obs, row_map)
        want = lut_log_weights_reference(qs, lut, parts, obs, row_map=row_map)
        assert float((got - want).abs().max()) <= 1e-3
        assert torch.equal(qs(lut, parts, obs, row_map=row_map), got)
    step, lut, parts, logw, noise, obs = _mega_case(rng, num_beams, 2000, 4000, cuda)
    scalars = torch.tensor([0.04, 0.03, 0.0, 0.81, 0, 0, 0, 0], dtype=torch.float32, device=cuda)
    out_p, out_w = torch.empty_like(parts), torch.empty_like(logw)
    sums = torch.empty(8, dtype=torch.float32, device=cuda)
    step(lut, parts, logw, noise, obs, scalars, out_p, out_w, sums)
    want_p, want_w, want_s = mega_step_reference(step, lut, parts, logw, noise, obs, scalars)
    rows = (out_p - want_p).abs().le(1e-5).all(dim=1)
    assert float(rows.float().mean()) >= 0.99
    assert float((out_w - want_w)[rows].abs().max()) <= 1e-3
    assert abs(float(sums[5] - want_s[5])) <= 1e-3


@pytest.mark.parametrize("max_range_px", [200, 400, 198.4, 2000], ids=["u8", "u16", "fractional", "past_cap"])
def test_norm_table_kernel_matches_plain_and_analytic(cuda, max_range_px):
    """The table the kernels read: within 2e-6 of its plain version (CUDA
    expf/logf and torch's differ by an ulp), and bit for bit the analytic
    device function at every entry value."""
    from monte_carlo_localization_tpu_torch.ops._cuda_build import load_library
    from monte_carlo_localization_tpu_torch.ops.lut_query import (
        MAX_TABLE_ENTRIES,
        _log_norm,
        log_norm_table,
    )

    rng = np.random.default_rng(33)
    q = _case(rng, _beams(60), max_range_px, False, 8, cuda)[0]
    assert load_library().libs["lut_likelihood"].mcl_max_table_entries() == MAX_TABLE_ENTRIES
    if max_range_px == 2000:
        assert q.table_entries == 0 and q.norm_table(cuda) is None
        return
    table = q.norm_table(cuda)
    assert q.table_launch_count == 1 and q.norm_table(cuda) is table
    plain = log_norm_table(q, cuda)
    assert table.shape == plain.shape == (math.ceil(max_range_px) + 1, 2)
    assert float((table[:, 0] - plain[:, 0]).abs().max()) <= 2e-6
    assert torch.equal(table[:, 1], plain[:, 1])
    d = torch.clamp(torch.arange(table.shape[0], dtype=torch.float32, device=cuda), max=q.m)
    assert torch.equal(q.launch_log_norm(d), table)
    frac = torch.rand(4096, device=cuda) * q.m
    want = _log_norm(q, frac)
    assert float((q.launch_log_norm(frac)[:, 0] - want).abs().max()) <= 2e-6


def test_subbin_kernel_on_whole_bin_headings_equals_table_kernel(cuda):
    """At headings on a whole bin the lerp's fraction is 0, so K3 reads
    K1's entries: the sub-bin table's integer nodes must give the integer
    table's bits."""
    rng = np.random.default_rng(34)
    for num_beams in (60, 1080):
        q, lut, parts, obs, row_map = _case(rng, _beams(num_beams), 200, True, 6000, cuda)
        qs = _case(rng, _beams(num_beams), 200, True, 8, cuda, subbin=True)[0]
        k = torch.from_numpy(rng.integers(-q.t_bins, q.t_bins, 6000).astype(np.float32)).to(cuda)
        theta = k / q.bin_scale
        bpos = theta * q.bin_scale
        keep = (bpos == torch.floor(bpos)) & (bpos == torch.round(bpos))
        assert int(keep.sum()) > 1000
        parts = parts[keep].contiguous()
        parts[:, 2] = theta[keep]
        got = qs(lut, parts, obs, row_map=row_map)
        want = q(lut, parts, obs, row_map=row_map)
        torch.cuda.synchronize()
        assert qs.subbin_table_launch_count == 1
        assert bool((want != -1e4).any())
        assert torch.equal(got, want)


@pytest.mark.parametrize("max_range_px", [200, 238, 400])
def test_subbin_table_kernel_matches_plain_and_the_integer_table(cuda, max_range_px):
    """The sub-bin table K3 reads: within 2e-6 of its plain version (CUDA
    expf/logf and torch's differ by an ulp; the segment coefficients come
    from those values in double), its integer nodes bit for bit the
    integer table of the same range, and read at any range within 1e-6 of
    the analytic device function (the table's 5.1e-7 budget and an ulp)."""
    from monte_carlo_localization_tpu_torch.ops._cuda_build import load_library
    from monte_carlo_localization_tpu_torch.ops.lut_query import (
        MAX_SUBBIN_ENTRIES,
        SUBBIN_STEPS,
        subbin_log_norm,
        subbin_norm_table,
    )

    lib = load_library().libs["lut_likelihood"]
    assert lib.mcl_max_subbin_entries() == MAX_SUBBIN_ENTRIES
    assert lib.mcl_subbin_steps() == SUBBIN_STEPS
    rng = np.random.default_rng(35)
    qs = _case(rng, _beams(60), max_range_px, False, 8, cuda, subbin=True)[0]
    q = _case(rng, _beams(60), max_range_px, False, 8, cuda)[0]
    table = qs.subbin_table(cuda)
    assert qs.subbin_table_launch_count == 1 and qs.subbin_table(cuda) is table
    plain = subbin_norm_table(qs, cuda)
    assert table.shape == plain.shape == (SUBBIN_STEPS * max_range_px + 1, 4)
    assert float((table - plain).abs().max()) <= 2e-6
    assert torch.equal(table[::SUBBIN_STEPS, 0], q.norm_table(cuda)[:, 0])
    d = torch.rand(100_000, device=cuda) * max_range_px
    d[:1000] *= 1e-3  # the first segment, past the short term's jump at 0
    assert float((subbin_log_norm(table, d) - qs.launch_log_norm(d)[:, 0]).abs().max()) <= 1e-6


@pytest.mark.parametrize("compact", [False, True], ids=["dense", "row_map"])
@pytest.mark.parametrize("max_range_px", [200, 400], ids=["u8", "u16"])
@pytest.mark.parametrize("num_beams", [60, 1080])
def test_subbin_kernel_matches_plain_version(cuda, num_beams, max_range_px, compact):
    rng = np.random.default_rng(7 + num_beams + max_range_px + compact)
    q, lut, parts, obs, row_map = _case(rng, _beams(num_beams), max_range_px, compact, 4000,
                                        cuda, subbin=True)
    parts[:2, 2] = torch.tensor([-2 * math.pi, 2 * math.pi], device=cuda)
    got = q(lut, parts, obs, row_map=row_map)
    want = lut_log_weights_reference(q, lut, parts, obs, row_map=row_map)
    torch.cuda.synchronize()
    assert q.launch_count == 1
    assert bool(((got == -1e4) == (want == -1e4)).all())
    assert 0 < int((want == -1e4).sum()) < 4000
    assert float((got - want).abs().max()) <= 1e-3


def _cloud(rng, kind, n):
    """converged: a few poses; uniform: every particle its own window;
    mixed: both, with particles off the map."""
    x0, y0 = OX + 0.5 * W * RES, OY + 0.5 * H * RES
    poses = np.array([[x0, y0, 0.3], [x0 + 0.4, y0 - 0.3, -1.2], [x0 - 0.7, y0, 2.5]])
    conv = poses[rng.integers(0, 3, n)]
    uni = np.stack([rng.uniform(OX, OX + W * RES, n), rng.uniform(OY, OY + H * RES, n),
                    rng.uniform(-math.pi, math.pi, n)], 1)
    if kind == "converged":
        parts = conv
    elif kind == "uniform":
        parts = uni
    else:
        pick = rng.uniform(size=n)
        parts = np.where((pick < 0.7)[:, None], conv, uni)
        parts[pick > 0.97, 0] = OX - 1.0
    return parts.astype(np.float32)


@pytest.mark.parametrize("subbin", [False, True], ids=["K4", "K3+K4"])
@pytest.mark.parametrize("kind", ["converged", "uniform", "mixed"])
def test_dedup_kernel_equals_lut_kernel(cuda, kind, subbin):
    rng = np.random.default_rng(11)
    n = 20000
    q, lut, _, obs, _ = _case(rng, _beams(60), 200, False, 8, cuda, subbin=subbin,
                              dedup_slots=16, block=160)
    parts = torch.from_numpy(_cloud(rng, kind, n)).to(cuda)
    got = q(lut, parts, obs)
    want = q.launch(lut, parts, obs)
    plain, overflow = lut_dedup_reference(q, lut, parts, obs)
    torch.cuda.synchronize()
    assert q.dedup_launch_count == 1 and q.launched_slots == 16
    assert torch.equal(got, want)
    assert float((got - plain).abs().max()) <= 1e-3
    assert int(q.last_overflow) == int(overflow)
    blocks = -(-n // 160)
    assert int(overflow) == {"converged": 0, "uniform": blocks}.get(kind, int(overflow))


@pytest.mark.parametrize("n", [1, 161, 100_000])
def test_dedup_kernel_equals_lut_kernel_at_edge_counts(cuda, n):
    """One particle, a chunk and one more, and config #4's count: bit for
    bit the LUT kernel, and the overflow count of dedup_plan on the same
    cloud."""
    from monte_carlo_localization_tpu_torch.ops.lut_query import dedup_plan

    rng = np.random.default_rng(n)
    for subbin in (False, True):
        q, lut, _, obs, row_map = _case(rng, _beams(60), 200, True, 8, cuda, subbin=subbin,
                                        dedup_slots=16, block=160)
        parts = torch.from_numpy(_cloud(rng, "mixed", n)).to(cuda)
        if n == 1:
            parts[0] = torch.tensor([OX + 1.0, OY + 1.0, 0.3], device=cuda)
        got = q.launch_dedup(lut, parts, obs, row_map)
        want = q.launch(lut, parts, obs, row_map)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        assert int(q.last_overflow) == int(dedup_plan(q, parts, row_map, q.launched_slots)[3])
        assert q.key_launch_count == q.dedup_launch_count == 1


@pytest.mark.parametrize("kind", ["random", "compact_row_map", "off_map"])
def test_window_key_kernel_equals_plain_version(cuda, kind):
    from monte_carlo_localization_tpu_torch.ops.lut_query import dedup_keys, window_keys

    rng = np.random.default_rng(len(kind))
    for subbin in (False, True):
        q, lut, parts, _, row_map = _case(rng, _beams(60), 200, kind == "compact_row_map", 5000,
                                          cuda, subbin=subbin, dedup_slots=16)
        if kind == "random":
            parts[:, 0].clamp_(OX + 0.05, OX + W * RES - 0.05)
            parts[:, 1].clamp_(OY + 0.05, OY + H * RES - 0.05)
        keys, starts, fracs, overflow = q.launch_window_keys(lut, parts, row_map)
        want = window_keys(q, parts, row_map)
        torch.cuda.synchronize()
        assert keys.dtype == torch.int32
        assert torch.equal(keys, want[0]) and torch.equal(starts, want[1])
        assert torch.equal(keys.to(torch.int64), dedup_keys(q, parts, row_map))
        assert (fracs is None) == (not subbin) and (fracs is None or torch.equal(fracs, want[2]))
        assert int(overflow) == 0
        assert bool((starts < 0).any()) == (kind != "random")


def test_dedup_shared_memory_opt_in_holds_in_any_order(cuda):
    """The dedup kernel opts each instantiation into all the shared memory
    a block may have: a launch that needs past 48 KB (1080 u16 beams, 16
    slots beside the beam stage and the table) after one that needs
    little, and two queries of one instantiation in turns, all launch and
    give the LUT kernel's bits."""
    rng = np.random.default_rng(13)
    big = _case(rng, _beams(1080), 400, True, 4000, cuda, dedup_slots=16, block=64)
    big2 = _case(rng, _beams(1080), 400, False, 3000, cuda, dedup_slots=8, block=96)
    small = _case(rng, _beams(60), 200, False, 4000, cuda, dedup_slots=4, block=64)
    assert big[0].slot_entries * 2 * 16 + 1080 * 8 + big[0].table_entries * 8 > 48 * 1024
    for q, lut, parts, obs, row_map in (small, big, small, big2, big, big2, small):
        got = q(lut, parts, obs, row_map=row_map)
        want = q.launch(lut, parts, obs, row_map)
        torch.cuda.synchronize()
        assert torch.equal(got, want)


def test_dedup_u16_1080_beams_needs_opt_in_shared_memory(cuda):
    rng = np.random.default_rng(12)
    q, lut, parts, obs, row_map = _case(rng, _beams(1080), 400, True, 4000, cuda,
                                        dedup_slots=16, block=64)
    assert q.window_entries * 2 * 16 > 48 * 1024
    got = q(lut, parts, obs, row_map=row_map)
    want = q.launch(lut, parts, obs, row_map=row_map)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_launch_rejects_what_the_kernel_does_not_take(cuda):
    rng = np.random.default_rng(0)
    beams = np.linspace(-2.35, 2.35, 60).astype(np.float32)
    q, lut, parts, obs, _ = _case(rng, beams, 200, False, 64, cuda)
    with pytest.raises(ValueError, match="dtype"):
        q(lut, parts.double(), obs)
    with pytest.raises(ValueError, match="contiguous"):
        q(lut, parts.t().contiguous().t(), obs)
    with pytest.raises(ValueError, match="shape"):
        q(lut, parts, obs[:10])
    with pytest.raises(ValueError, match="is on"):
        q(lut.cpu(), parts, obs)
    with pytest.raises(ValueError, match="dedup_slots"):
        q.launch_dedup(lut, parts, obs)
    qd = _case(rng, beams, 200, False, 64, cuda, dedup_slots=4)[0]
    shifted = torch.empty(lut.numel() + 1, dtype=lut.dtype, device=cuda)[1:]
    shifted.copy_(lut)
    with pytest.raises(ValueError, match="16 B boundary"):
        qd(shifted, parts, obs)
    assert q.launch_count == qd.dedup_launch_count == 0


def _mega_case(rng, num_beams, max_range_px, n, device):
    """A MegaStep on a random dense LUT, particles of which some lie off
    the map, sharply non-uniform log weights, noise and a scan."""
    from monte_carlo_localization_tpu_torch.ops.mega_step import MegaStep

    beams = (-0.75 * np.pi + np.arange(num_beams) * 1.5 * np.pi / (num_beams - 1)).astype(np.float32)
    dtype = np.uint8 if max_range_px <= 254 else np.uint16
    t = suggest_theta_bins(beams)
    stride = required_row_stride(t, beams, np.dtype(dtype).itemsize)
    step = MegaStep(
        t, beams, height=H, width=W, resolution=RES, origin_x=OX, origin_y=OY,
        max_range_px=max_range_px, row_stride=stride, z_hit=0.8, z_short=0.01,
        z_max=0.07, z_rand=0.12, sigma_hit=8.0, inv_squash=1 / 2.2,
        lut_dtype=dtype, device=device,
    )
    base = rng.integers(0, max_range_px + 1, (H * W, t)).astype(dtype)
    lut = np.tile(base, (1, -(-stride // t)))[:, :stride].reshape(-1)
    x = rng.uniform(OX - 0.3, OX + W * RES + 0.3, n)
    y = rng.uniform(OY - 0.3, OY + H * RES + 0.3, n)
    theta = rng.uniform(-np.pi, np.pi, n)
    parts = np.stack([x, y, theta], 1).astype(np.float32)
    logw = rng.normal(0.0, 3.0, n).astype(np.float32)
    noise = rng.normal(size=(n, 3)).astype(np.float32)
    obs = np.minimum(rng.uniform(0, max_range_px * 1.1, num_beams), max_range_px).astype(np.float32)
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return step, to(lut), to(parts), to(logw), to(noise), to(obs)


@pytest.mark.parametrize("motion", [[0.05, 0.0, 1.0, 0.37], [0.04, 0.03, 0.0, 0.81]],
                         ids=["straight", "arc"])
@pytest.mark.parametrize("max_range_px", [200, 400], ids=["u8", "u16"])
@pytest.mark.parametrize("num_beams", [60, 1080])
def test_mega_kernel_matches_plain_version(cuda, num_beams, max_range_px, motion):
    from monte_carlo_localization_tpu_torch.ops.mega_step import mega_step_reference

    n = 4000
    rng = np.random.default_rng(num_beams + max_range_px)
    step, lut, parts, logw, noise, obs = _mega_case(rng, num_beams, max_range_px, n, cuda)
    scalars = torch.tensor(motion + [0.0] * 4, dtype=torch.float32, device=cuda)
    out_p = torch.empty_like(parts)
    out_w = torch.empty_like(logw)
    sums = torch.empty(8, dtype=torch.float32, device=cuda)
    step(lut, parts, logw, noise, obs, scalars, out_p, out_w, sums)
    want_p, want_w, want_s = mega_step_reference(step, lut, parts, logw, noise, obs, scalars)
    torch.cuda.synchronize()
    grid, chunk, small = step.plan(n)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert step.launch_count == 1 and small and grid == -(-n // chunk) and grid <= 3 * sms
    rows = (out_p - want_p).abs().le(1e-5).all(dim=1)
    assert float(rows.float().mean()) >= 0.99
    assert float((out_w - want_w)[rows].abs().max()) <= 1e-3
    rel = ((sums[:5] - want_s[:5]).abs() / want_s[:5].abs().clamp(min=1e-30)).max()
    assert float(rel) <= 1e-4
    assert abs(float(sums[5] - want_s[5])) <= 1e-3
    assert bool((want_w + want_s[5] == -1e4).any())  # off-map rows were drawn


@pytest.mark.parametrize("n", [1, 100, 8192, 8193, 30_011], ids=lambda n: f"n{n}")
@pytest.mark.parametrize("num_beams", [60, 1080])
def test_mega_kernel_on_each_side_of_the_small_n_choice(cuda, num_beams, n):
    """Up to 8192 particles every block computes the weight CDF itself;
    past that the CDF runs across a cooperative grid. Both match the
    plain version, and a second launch on the same inputs gives the same
    bits (no float atomics, partials combined in block order)."""
    from monte_carlo_localization_tpu_torch.ops.mega_step import mega_step_reference

    rng = np.random.default_rng(num_beams + n)
    step, lut, parts, logw, noise, obs = _mega_case(rng, num_beams, 200, n, cuda)
    if n <= 100:
        parts[:, 0].clamp_(OX + 0.2, OX + W * RES - 0.2)
        parts[:, 1].clamp_(OY + 0.2, OY + H * RES - 0.2)
    scalars = torch.tensor([0.04, 0.03, 0.0, 0.81, 0, 0, 0, 0], dtype=torch.float32, device=cuda)
    outs = []
    for _ in range(2):
        out_p, out_w = torch.empty_like(parts), torch.empty_like(logw)
        sums = torch.empty(8, dtype=torch.float32, device=cuda)
        step(lut, parts, logw, noise, obs, scalars, out_p, out_w, sums)
        outs.append((out_p, out_w, sums))
    want_p, want_w, want_s = mega_step_reference(step, lut, parts, logw, noise, obs, scalars)
    torch.cuda.synchronize()
    grid, chunk, small = step.plan(n)
    assert small == (n <= 8192) and grid == -(-n // chunk) and chunk % (16 if num_beams <= 64 else 8) == 0
    for a, b in zip(outs[0], outs[1]):
        assert torch.equal(a, b)
    out_p, out_w, sums = outs[0]
    rows = (out_p - want_p).abs().le(1e-5).all(dim=1)
    assert float(rows.float().mean()) >= 0.99
    assert float((out_w - want_w)[rows].abs().max()) <= 1e-3
    # each sum against the sum of its absolute terms: S_wsin and S_wcos
    # cancel (0.0008 of a total 2.3 in one of these cases), so an error of
    # 1e-7 is 1e-4 of the sum itself
    ww = torch.exp(want_w.double())
    terms = torch.stack([want_p[:, 0].double().abs(), want_p[:, 1].double().abs(),
                         torch.sin(want_p[:, 2].double()).abs(),
                         torch.cos(want_p[:, 2].double()).abs(), torch.ones_like(ww)])
    rel = (sums[:5] - want_s[:5]).abs().double() / (terms * ww).sum(dim=1)
    assert float(rel.max()) <= 1e-4
    assert abs(float(sums[5] - want_s[5])) <= 1e-3


def test_mega_debug_phases_stop_where_they_say(cuda):
    from monte_carlo_localization_tpu_torch.ops.mega_step import mega_step_reference

    rng = np.random.default_rng(5)
    step, lut, parts, logw, noise, obs = _mega_case(rng, 60, 200, 4000, cuda)
    scalars = torch.tensor([0.05, 0.0, 1.0, 0.37, 0, 0, 0, 0], dtype=torch.float32, device=cuda)
    want_p, want_w, want_s = mega_step_reference(step, lut, parts, logw, noise, obs, scalars)
    out_p, sums = torch.empty_like(parts), torch.empty(8, dtype=torch.float32, device=cuda)
    out_w = torch.full_like(logw, 7.0)
    step.launch(lut, parts, logw, noise, obs, scalars, out_p, out_w, sums, debug_phases="pro_only")
    assert bool((out_w == 7.0).all()) and float((out_p - want_p).abs().max()) <= 1e-5
    step.launch(lut, parts, logw, noise, obs, scalars, out_p, out_w, sums, debug_phases="no_epi")
    assert float((out_w - (want_w + want_s[5])).abs().max()) <= 1e-3  # not yet shifted
    step.launch(lut, parts, logw, noise, obs, scalars, out_p, out_w, sums)
    assert float((out_w - want_w).abs().max()) <= 1e-3


def test_mega_one_stepper_serves_changing_particle_counts(cuda):
    """The grid, the workspace layout and the form of phase 1 change with
    n; the ticket that hands the epilogue to the last block must start at
    0 whatever ran before."""
    from monte_carlo_localization_tpu_torch.ops.mega_step import mega_step_reference

    rng = np.random.default_rng(9)
    step, lut, parts, logw, noise, obs = _mega_case(rng, 60, 200, 30_000, cuda)
    scalars = torch.tensor([0.04, 0.03, 0.0, 0.81, 0, 0, 0, 0], dtype=torch.float32, device=cuda)
    # 8192, 4000, 8192: a smaller count's plan must not take away the
    # shared memory the larger one was opted into
    for n in (30_000, 4000, 100, 8192, 30_000, 16, 4000, 8192):
        args = (lut, parts[:n], logw[:n], noise[:n], obs, scalars)
        out_p, out_w = torch.empty_like(parts[:n]), torch.empty_like(logw[:n])
        sums = torch.empty(8, dtype=torch.float32, device=cuda)
        step(*args, out_p, out_w, sums)
        want_p, want_w, want_s = mega_step_reference(step, *args)
        rows = (out_p - want_p).abs().le(1e-5).all(dim=1)
        assert float(rows.float().mean()) >= 0.99, n
        assert float((out_w - want_w)[rows].abs().max()) <= 1e-3, n
        assert abs(float(sums[4] - want_s[4])) <= 1e-4 * float(want_s[4]), n
        assert abs(float(sums[5] - want_s[5])) <= 1e-3, n


def test_mega_two_steppers_share_the_kernel(cuda):
    """Two steppers of one beam layout run one kernel instantiation: what
    one of them plans (its shared-memory opt-in at its particle count)
    must leave the other's cached plan launchable."""
    from monte_carlo_localization_tpu_torch.ops.mega_step import mega_step_reference

    scalars = torch.tensor([0.04, 0.03, 0.0, 0.81, 0, 0, 0, 0], dtype=torch.float32, device=cuda)
    cases = [_mega_case(np.random.default_rng(s), 60, 200, n, cuda) for s, n in ((3, 8192), (4, 4000))]
    for step, lut, parts, logw, noise, obs in cases + cases[:1]:
        args = (lut, parts, logw, noise, obs, scalars)
        out_p, out_w = torch.empty_like(parts), torch.empty_like(logw)
        sums = torch.empty(8, dtype=torch.float32, device=cuda)
        step(*args, out_p, out_w, sums)
        want_p, want_w, want_s = mega_step_reference(step, *args)
        rows = (out_p - want_p).abs().le(1e-5).all(dim=1)
        assert float(rows.float().mean()) >= 0.99
        assert float((out_w - want_w)[rows].abs().max()) <= 1e-3
        assert abs(float(sums[4] - want_s[4])) <= 1e-4 * float(want_s[4])


def test_mega_launch_rejects_what_the_kernel_does_not_take(cuda):
    rng = np.random.default_rng(1)
    step, lut, parts, logw, noise, obs = _mega_case(rng, 60, 200, 64, cuda)
    scalars = torch.zeros(8, dtype=torch.float32, device=cuda)
    out_p, out_w = torch.empty_like(parts), torch.empty_like(logw)
    sums = torch.empty(8, dtype=torch.float32, device=cuda)
    with pytest.raises(ValueError, match="input buffers"):
        step(lut, parts, logw, noise, obs, scalars, parts, out_w, sums)
    with pytest.raises(ValueError, match="shape"):
        step(lut, parts, logw, noise[:10], obs, scalars, out_p, out_w, sums)
    with pytest.raises(ValueError, match="dtype"):
        step(lut, parts, logw.double(), noise, obs, scalars, out_p, out_w, sums)
    with pytest.raises(ValueError, match="debug_phases"):
        step.launch(lut, parts, logw, noise, obs, scalars, out_p, out_w, sums, debug_phases="x")
    assert step.launch_count == 0


def test_seeded_chains_agree_bit_for_bit_with_and_without_dedup(cuda):
    """At 50k particles the classic step is reproducible on the card (the
    weight CDF is a doubling scan, not torch.cumsum), and the
    unique-window kernel changes no bit of the trajectory."""
    from monte_carlo_localization_tpu_torch import MCLConfig, ParticleFilter
    from monte_carlo_localization_tpu_torch.mapping import map_from_occupancy

    occ = np.zeros((120, 160), np.int8)
    occ[[0, -1], :] = occ[:, [0, -1]] = 100
    occ[40:50, 60:90] = occ[80:95, 20:30] = 100
    gm = map_from_occupancy(occ, resolution=0.05, origin=(0.0, 0.0, 0.0), device=cuda)
    beams = _beams(60)
    scans = np.tile(np.linspace(0.5, 4.0, 60, dtype=np.float32), (5, 1))
    actions = np.tile(np.float32([0.02, 0.0, 0.01]), (5, 1))
    poses = []
    for slots in (0, 0, 16):
        pf = ParticleFilter(gm, MCLConfig(max_particles=50_000, pallas_dedup_slots=slots),
                            beam_angles=beams)
        _, p = pf.step_many(pf.init_global(seed=3), actions, scans)
        poses.append(p.cpu())
        assert (pf.likelihood.dedup_launch_count, pf.likelihood.launch_count) == (
            (5, 0) if slots else (0, 5))
    assert torch.equal(poses[0], poses[1]) and torch.equal(poses[0], poses[2])


# fleet cases: (map shapes, members, particles per member, map_of,
# member_base, compact, max_range_px, subbin); npm 4001 and 1003 are not
# multiples of 8, so a block of 8 warps would straddle two members
FLEET_CASES = {
    "3_members_2_maps": ([(64, 80), (40, 120)], 3, 4000, [0, 1, 0], 0, False, 200, False),
    "shared_map_of": ([(64, 80), (40, 120)], 8, 1003, [1, 1, 0, 1, 0, 0, 1, 1], 0, False, 200, False),
    "compact": ([(64, 80), (40, 120)], 3, 4000, [1, 0, 1], 0, True, 200, False),
    "u16": ([(64, 80), (40, 120)], 3, 4001, [0, 1, 1], 0, False, 400, False),
    "subbin": ([(64, 80), (40, 120)], 3, 4000, [0, 1, 0], 0, True, 200, True),
    "member_base": ([(64, 80), (40, 120)], 2, 1003, [0, 0, 1, 0, 1], 2, False, 200, False),
    # members smaller than a block, than a lane group's share, and of one particle
    "npm_7": ([(64, 80), (40, 120)], 9, 7, [0, 1, 0, 1, 1, 0, 0, 1, 0], 0, False, 200, False),
    "npm_1": ([(64, 80), (40, 120)], 40, 1, [0, 1] * 20, 0, True, 200, False),
    "ragged_many": ([(64, 80), (40, 120)], 5, 70_001, [0, 1, 0, 1, 1], 0, False, 400, False),
}


def _fleet_case(rng, maps, f, npm, map_of, member_base, compact, max_range_px, subbin, device):
    """A fleet LUTQuery over random tight LUT blocks of maps with their own
    origins, particles of which some lie off their member's map, and one
    scan per member. Returns (query, lut, particles, obs, row_map, fleet
    keyword arguments)."""
    beams = _beams(60)
    dtype = np.uint8 if max_range_px <= 254 else np.uint16
    itemsize = np.dtype(dtype).itemsize
    t = suggest_theta_bins(beams)
    stride = required_row_stride(t, beams, itemsize)
    eps = 512 // itemsize
    q = LUTQuery(
        t, beams, height=max(h for h, _ in maps), width=max(w for _, w in maps),
        resolution=RES, origin_x=0.0, origin_y=0.0, max_range_px=max_range_px,
        row_stride=stride, z_hit=0.8, z_short=0.01, z_max=0.07, z_rand=0.12, sigma_hit=8.0,
        inv_squash=1 / 2.2, lut_dtype=dtype, subbin=subbin, num_members=f,
        per_member_maps=True, device=device,
    )
    ox = rng.uniform(-2, 2, len(maps)).astype(np.float32)
    oy = rng.uniform(-2, 2, len(maps)).astype(np.float32)
    blocks, bases, rmaps, rbases, at, rat = [], [], [], [], 0, 0
    for h, w in maps:
        rows = h * w // 3 + 1 if compact else h * w
        blocks.append(rng.integers(0, max_range_px + 1, rows * stride).astype(dtype))
        bases.append(at)
        at += rows * (stride // eps)
        if compact:
            rmaps.append(rng.integers(0, rows, h * w).astype(np.int32))
            rbases.append(rat)
            rat += h * w
    members = np.arange(f) + member_base
    mi = np.asarray(map_of)[members]
    parts = np.zeros((f, npm, 3), np.float32)
    for k in range(f):
        h, w = maps[mi[k]]
        parts[k, :, 0] = rng.uniform(ox[mi[k]] - 0.3, ox[mi[k]] + w * RES + 0.3, npm)
        parts[k, :, 1] = rng.uniform(oy[mi[k]] - 0.3, oy[mi[k]] + h * RES + 0.3, npm)
        parts[k, :, 2] = rng.uniform(-2 * math.pi, 2 * math.pi, npm)
    obs = rng.uniform(0, max_range_px * 1.1, (f, 60)).astype(np.float32)
    to = lambda a: None if a is None else torch.from_numpy(np.ascontiguousarray(a)).to(device)
    fleet = dict(member_base=member_base, origins=(to(ox), to(oy)),
                 map_of=to(np.asarray(map_of, np.int32)), dims=to(np.array(maps, np.int32)),
                 lut_bases=to(np.array(bases, np.int32)),
                 row_map_bases=to(np.array(rbases, np.int32)) if compact else None)
    row_map = to(np.concatenate(rmaps)) if compact else None
    return q, to(np.concatenate(blocks)), to(parts.reshape(-1, 3)), to(obs), row_map, fleet


@pytest.mark.parametrize("case", list(FLEET_CASES))
def test_fleet_kernel_matches_plain_version(cuda, case):
    rng = np.random.default_rng(len(case))
    q, lut, parts, obs, row_map, fleet = _fleet_case(rng, *FLEET_CASES[case], cuda)
    got = q(lut, parts, obs, row_map=row_map, **fleet)
    want = lut_log_weights_reference(q, lut, parts, obs, row_map,
                                     q.fleet_tables(parts, obs, row_map, **fleet))
    torch.cuda.synchronize()
    assert q.fleet_launch_count == 1 and q.launch_count == 0
    assert bool(((got == -1e4) == (want == -1e4)).all())
    assert 0 < int((want == -1e4).sum()) < parts.shape[0]
    assert float((got - want).abs().max()) <= 1e-3


@pytest.mark.parametrize("compact", [False, True], ids=["dense", "row_map"])
@pytest.mark.parametrize("subbin", [False, True], ids=["K1", "K3"])
def test_one_member_fleet_kernel_equals_single_kernel(cuda, subbin, compact):
    rng = np.random.default_rng(21)
    q, lut, parts, obs, row_map = _case(rng, _beams(60), 200, compact, 4001, cuda, subbin=subbin)
    fq = LUTQuery(q.t_bins, _beams(60), height=H, width=W, resolution=RES, origin_x=OX,
                  origin_y=OY, max_range_px=200, row_stride=q.row_stride, z_hit=0.8,
                  z_short=0.01, z_max=0.07, z_rand=0.12, sigma_hit=8.0, inv_squash=1 / 2.2,
                  subbin=subbin, per_member_maps=True, device=cuda)
    origins = (torch.tensor([OX], device=cuda), torch.tensor([OY], device=cuda))
    fleet = dict(origins=origins, lut_bases=torch.zeros(1, dtype=torch.int32, device=cuda),
                 row_map_bases=torch.zeros(1, dtype=torch.int32, device=cuda) if compact else None)
    got = fq(lut, parts, obs[None], row_map=row_map, **fleet)
    want = q.launch(lut, parts, obs, row_map)
    torch.cuda.synchronize()
    assert fq.fleet_launch_count == 1
    assert torch.equal(got, want)


def test_fleet_filter_one_launch_per_correction(cuda):
    """A stacked two-map fleet on the card: one fleet-kernel launch per
    correction, reproducible seeded chains, every member near its pose."""
    from monte_carlo_localization_tpu_torch import MCLConfig
    from monte_carlo_localization_tpu_torch.mapping import map_from_occupancy
    from monte_carlo_localization_tpu_torch.ops.raycast import cast_rays_dda
    from monte_carlo_localization_tpu_torch.parallel import FleetFilter, stack_maps

    maps = []
    for h, w, origin in ((120, 160, (0.0, 0.0, 0.0)), (90, 200, (-2.0, 1.0, 0.0))):
        occ = np.zeros((h, w), np.int8)
        occ[[0, -1], :] = occ[:, [0, -1]] = 100
        occ[40:50, 60:90] = occ[70:85, 20:30] = 100
        maps.append(map_from_occupancy(occ, resolution=0.05, origin=origin, device=cuda))
    asg = np.arange(6) % 2
    poses0 = np.float32([[3.0, 3.5, 0.3], [1.0, 3.0, 0.1]])[asg]
    beams = torch.as_tensor(_beams(60), device=cuda)
    scans = torch.stack([
        cast_rays_dda(maps[a], torch.stack([torch.full_like(beams, float(p[0])),
                                            torch.full_like(beams, float(p[1])), p[2] + beams], 1))
        for a, p in zip(asg, poses0)]).cpu().numpy()
    ff = FleetFilter(stack_maps(maps), 6, MCLConfig(max_particles=4000), beam_angles=_beams(60),
                     map_assignment=asg)
    runs = []
    for _ in range(2):
        _, poses = ff.step_many(ff.init_pose(poses0, seed=1), np.zeros((5, 6, 3)),
                                np.stack([scans] * 5))
        runs.append(poses.cpu())
    assert ff.likelihood.fleet_launch_count == 10 and ff.likelihood.launch_count == 0
    assert torch.equal(runs[0], runs[1])
    err = np.linalg.norm(runs[0][-1, :, :2].numpy() - poses0[:, :2], axis=1)
    assert err.max() < 0.25, err


def test_probe_kernels_match_their_plain_versions(cuda):
    """Every probe of tools/mega_probe.py through its Hopper kernel: each
    probe's own checks, the kernel against its plain version (Philox bits
    and the staged writes bit for bit, and the curand oracle), and every
    probe kernel launched."""
    from monte_carlo_localization_tpu_torch.ops.probes import Probes
    from monte_carlo_localization_tpu_torch.tools.mega_probe import PROBES

    pr = Probes()
    calls = [c for name in PROBES for c in PROBES[name](pr, cuda)]
    torch.cuda.synchronize()
    assert all(n > 0 for n in pr.launch_count.values()), pr.launch_count
    assert max(c.max_abs_err for c in calls if c.kernel != "scan_resample") <= 1e-5
    assert max(c.rows_off for c in calls) < 0.01
    assert max(c.max_abs_err for c in calls if not c.rows_off) <= 1e-3


def test_probe_scan_resample_sizes_and_refusals(cuda):
    from monte_carlo_localization_tpu_torch.ops.probes import Probes, scan_resample_reference

    pr = Probes()
    rng = np.random.default_rng(3)
    for n in (1, 1000, 4096, 8192):  # one to eight elements per thread
        w = torch.from_numpy(rng.uniform(0.1, 1.0, n).astype(np.float32)).to(cuda)
        parts = torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32)).to(cuda)
        got = pr.scan_resample("front", w=w, parts=parts, u0=0.5)
        want = scan_resample_reference("front", w=w, parts=parts, u0=0.5)
        rows = (got == want).all(dim=1)
        assert float(rows.float().mean()) >= 0.99
        assert torch.equal(pr.scan_resample("scan", w=w), scan_resample_reference("scan", w=w))
    with pytest.raises(ValueError, match="1..8192"):
        pr.scan_resample("scan", w=torch.ones(8193, device=cuda))
    with pytest.raises(ValueError, match="needs parts"):
        pr.scan_resample("front", w=torch.ones(64, device=cuda))
    with pytest.raises(ValueError, match="dtype"):
        pr.gather_rows(torch.ones((4, 8), dtype=torch.float64, device=cuda),
                       torch.zeros(2, dtype=torch.int32, device=cuda))


MAIN_PATH_N = (4_000, 100_000, 1_000_000)


@pytest.mark.parametrize("slots, rows, lanes", [
    *[(n, n, 4) for n in MAIN_PATH_N],  # the ancestor gather, 16 B rows
    (16, 64, 128),  # probe_smem's own shape
    (1, 513, 4), (7, 513, 4), (1001, 513, 8), (4097, 513, 128), (300_007, 513, 4),  # ragged
])
def test_gather_rows_kernel_bits(cuda, slots, rows, lanes):
    """The gather equals its plain version bit for bit at the main path's
    counts, the probe's shape and S no multiple of a block or a grid
    stride; a row outside [0, rows) reads as 0; one launch a call; the
    form as first ported agrees and is not counted."""
    from monte_carlo_localization_tpu_torch.ops.probes import Probes, gather_rows_reference

    rng = np.random.default_rng(slots)
    hbm = torch.from_numpy(rng.normal(size=(rows, lanes)).astype(np.float32)).to(cuda)
    y0_np = np.sort(rng.integers(0, rows, slots)).astype(np.int32)
    y0 = torch.from_numpy(y0_np).to(cuda)
    pr = Probes()
    got = pr.gather_rows(hbm, y0)
    torch.cuda.synchronize()
    assert torch.equal(got, gather_rows_reference(hbm, y0))
    assert pr.launch_count["gather_rows"] == 1
    assert torch.equal(pr.gather_rows_as_ported(hbm, y0), got)
    assert pr.launch_count["gather_rows"] == 1
    off = y0.clone()
    off[::5] = rows  # past the table
    off[1::7] = -3
    want = torch.where(((off >= 0) & (off < rows))[:, None],
                       hbm[off.long().clamp(0, rows - 1)], torch.zeros((), device=cuda))
    assert torch.equal(pr.gather_rows(hbm, off), want)
    assert pr.launch_count["gather_rows"] == 2
    shape = pr.stream_shape("gather_rows", slots, lanes)
    props = torch.cuda.get_device_properties(cuda)
    assert 1 <= shape["grid"] <= props.multi_processor_count * 8 and shape["threads"] == 256


@pytest.mark.parametrize("count", [
    *[3 * n for n in MAIN_PATH_N],  # the (N, 3) motion noise
    4 * 32 * 128,  # probe_rng's own count
    2, 6, 4002, 30_000_006,  # an odd last pair; more groups than the grid's threads
])
def test_philox_normals_kernel(cuda, count):
    """The normals within 1e-5 of their plain version, the Philox words
    equal to the plain version's and to curand's Philox4_32_10, at the
    main path's counts, the probe's and counts with an odd last pair;
    one launch a call; the form as first ported gives the same words."""
    from monte_carlo_localization_tpu_torch.ops.probes import Probes, philox_normals_reference

    seed = (12345, 678)
    pr = Probes()
    out, bits = pr.philox_normals(seed, count, cuda, with_bits=True)
    torch.cuda.synchronize()
    assert pr.launch_count["philox_normals"] == 1
    plain, words = philox_normals_reference(seed, count, cuda)
    assert torch.equal(bits.long() & 0xFFFFFFFF, words)
    assert float((out - plain).abs().max()) <= 1e-5
    calls = min(256, count // 2)
    assert torch.equal(bits[:calls], pr.curand_philox_words(seed, calls, cuda))
    assert torch.equal(pr.philox_normals(seed, count, cuda), out)
    ported, ported_bits = pr.philox_normals_as_ported(seed, count, cuda, with_bits=True)
    assert torch.equal(ported_bits, bits) and float((ported - plain).abs().max()) <= 1e-5
    assert pr.launch_count["philox_normals"] == 2
    with pytest.raises(ValueError, match="even"):
        pr.philox_normals(seed, count + 1, cuda)


def test_philox_normals_terms_bound_over_every_input(cuda):
    """The normals kernel's r and cos against the plain version's over all
    2^24 inputs each: their worst case keeps every normal within the
    probe's 1e-5, and neither term is off by more than 1e-6."""
    from monte_carlo_localization_tpu_torch.ops.probes import Probes
    from monte_carlo_localization_tpu_torch.tools.mega_probe import normals_error_bound

    bound = normals_error_bound(Probes(), cuda)
    assert bound["bound"] <= 1e-5, bound
    assert bound["r_max_abs_err"] <= 1e-6 and bound["cos_max_abs_err"] <= 1e-6, bound
    assert 7.4 < bound["r_max"] < 7.5


def _knife_edges(res: float, max_px: int, seed: int, extra: int = 20000) -> np.ndarray:
    half = ((np.arange(max_px + 1) + 0.5) * res).astype(np.float32)
    up, down = np.nextafter(half, np.float32(np.inf)), np.nextafter(half, np.float32(0))
    rest = np.random.default_rng(seed).uniform(0, 1.05 * max_px * res, extra).astype(np.float32)
    return np.concatenate([half, up, down, rest])


def test_division_sites_on_the_card_are_the_cpu_bits(cuda, monkeypatch):
    """Every division by a Python number in the port runs as IEEE
    division on the card: ``div`` itself, ``to_pixel_index`` on
    half-pixel knife edges, ``reconstruct_velocity`` with afwd over
    [0, 1], and the quotients the plain normaliser and the analytic
    sensor model hand to erf, each ``torch.equal`` to the CPU."""
    from monte_carlo_localization_tpu_torch.models import sensor as sensor_mod
    from monte_carlo_localization_tpu_torch.models.motion import reconstruct_velocity
    from monte_carlo_localization_tpu_torch.models.sensor import SensorModel
    from monte_carlo_localization_tpu_torch.ops import lut_query
    from monte_carlo_localization_tpu_torch.utils.geometry import div

    res, m = 0.05, 240
    r = torch.from_numpy(_knife_edges(res, m, 0))
    for c in (res, 5.0, 8.0 * 2**0.5):
        assert torch.equal(div(r.to(cuda), c).cpu(), div(r, c))
        assert torch.equal(div(r.double().to(cuda), c).cpu(), div(r.double(), c))
    assert torch.equal(SensorModel.create(m, res, device=cuda).to_pixel_index(r.to(cuda)).cpu(),
                       SensorModel.create(m, res, device="cpu").to_pixel_index(r))
    rng = np.random.default_rng(1)
    n = 20000
    fwd = (rng.uniform(0, 1, n) * rng.choice([-1, 1], n)).astype(np.float32)
    act = torch.from_numpy(np.stack([fwd, np.zeros(n, np.float32),
                                     rng.uniform(-0.5, 0.5, n).astype(np.float32)], 1))
    for got, want in zip(reconstruct_velocity(act.to(cuda)), reconstruct_velocity(act)):
        assert torch.equal(got.cpu(), want)

    def recorder(module, name):
        seen, real = [], getattr(module, name)

        def record(x, *args, **kwargs):
            seen.append(x.cpu())
            return real(x, *args, **kwargs)

        monkeypatch.setattr(module, name, record)
        return seen

    beams = np.linspace(-2.3, 2.3, 60).astype(np.float32)
    t = suggest_theta_bins(beams)
    q = LUTQuery(t, beams, height=8, width=8, resolution=res, origin_x=0.0, origin_y=0.0,
                 max_range_px=m, row_stride=required_row_stride(t, beams, 1), z_hit=0.8,
                 z_short=0.01, z_max=0.07, z_rand=0.12, sigma_hit=8.0, inv_squash=1 / 2.2,
                 device="cpu")
    d = torch.clamp(torch.from_numpy(_knife_edges(1.0, m, 2)) - 0.5, 0, m)
    seen = recorder(lut_query, "_erf_as")
    for fn in (lut_query._log_norm, lut_query._log_norm_right):
        fn(q, d.to(cuda))
        fn(q, d)
    assert len(seen) == 8
    for k in (0, 1, 4, 5):
        assert torch.equal(seen[k], seen[k + 2])
    seen = recorder(sensor_mod.torch.special, "erf")
    rd = torch.from_numpy(rng.integers(0, m + 1, (2, 16, 60)).astype(np.float32))
    s_card, s_cpu = SensorModel.create(m, res, device=cuda), SensorModel.create(m, res, device="cpu")
    s_card.log_prob_analytic(rd[0].to(cuda), rd[1].to(cuda))
    s_cpu.log_prob_analytic(rd[0], rd[1])
    assert torch.equal(seen[0], seen[2]) and torch.equal(seen[1], seen[3])


STAGED_ARGS = (0.37, -1.3, 2.1, 0.5)  # a, b, c, add: FMA contraction would show


@pytest.mark.parametrize("per_step", (1, 8, 128, 1000))
@pytest.mark.parametrize("steps", (1, 7, 8, 9, 32, 100))
def test_staged_writes_kernel_bits(cuda, steps, per_step):
    """The kernel is bit-equal to its plain version at every size one
    CTA's shared memory holds, and refuses the others."""
    from monte_carlo_localization_tpu_torch.ops.probes import (
        MAX_STAGED,
        Probes,
        staged_writes_reference,
    )

    pr = Probes()
    if steps * per_step > MAX_STAGED:
        with pytest.raises(ValueError, match="shared memory"):
            pr.staged_writes(steps, per_step, *STAGED_ARGS, cuda)
        return
    got = pr.staged_writes(steps, per_step, *STAGED_ARGS, cuda)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), staged_writes_reference(steps, per_step, *STAGED_ARGS))
    assert pr.launch_count["staged_writes"] == 1
    shape = pr.staged_shape(steps, per_step)
    assert shape["grid"] == 1 and 32 <= shape["threads"] <= 256
    assert shape["smem"] >= 4 * steps * per_step


def test_staged_writes_twice_on_two_streams_and_in_a_graph(cuda):
    """Nothing outlives a launch: two launches in a row, launches on two
    streams at once and replays of a captured launch all give the
    plain version's bits."""
    from monte_carlo_localization_tpu_torch.ops.probes import Probes, staged_writes_reference

    pr = Probes()
    cases = [(8, 128, 1.0, 0.0, 1.0, 0.0), (32, 8, 16.0, 2.0, 0.0, 1.0),
             (9, 1000, *STAGED_ARGS)]
    wants = [staged_writes_reference(*c) for c in cases]
    for c, want in zip(cases, wants):
        first, second = pr.staged_writes(*c, cuda), pr.staged_writes(*c, cuda)
        assert torch.equal(first.cpu(), want) and torch.equal(second.cpu(), want)
    streams = torch.cuda.Stream(), torch.cuda.Stream()
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    outs = []
    for _ in range(20):
        for k, s in zip((0, 2), streams):
            with torch.cuda.stream(s):
                outs.append((k, pr.staged_writes(*cases[k], cuda)))
    torch.cuda.synchronize()
    for k, out in outs:
        assert torch.equal(out.cpu(), wants[k])
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = [pr.staged_writes(*c, cuda) for c in cases]
    for _ in range(3):
        for out in captured:
            out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        for out, want in zip(captured, wants):
            assert torch.equal(out.cpu(), want)


@pytest.mark.parametrize("n", [1, 5, 1000, 4095, 4096, 8192, "misaligned"])
def test_scan_roll_col_kernels_bits(cuda, n):
    """scan, roll and col bit-equal to their plain versions on the card at
    one to 8192 elements, and on a base 4 B off a 16 B boundary (w[1:] of
    a 4097-float buffer): the scalar path of the same kernels. The f64
    sums of uniform(0.1, 1) floats are exact at n <= 8192, so any order
    gives the plain scan's bits."""
    from monte_carlo_localization_tpu_torch.ops.probes import Probes, scan_resample_reference

    pr = Probes()
    rng = np.random.default_rng(7)
    to = lambda a: torch.from_numpy(a).to(cuda)  # noqa: E731
    if n == "misaligned":
        w = to(rng.uniform(0.1, 1.0, 4097).astype(np.float32))[1:]
        parts = to(rng.normal(size=3 * 4096 + 1).astype(np.float32))[1:].view(4096, 3)
        assert w.data_ptr() % 16 == 4 and parts.data_ptr() % 16 == 4
        assert w.is_contiguous() and parts.is_contiguous()
    else:
        w = to(rng.uniform(0.1, 1.0, n).astype(np.float32))
        parts = to(rng.normal(size=(n, 3)).astype(np.float32))
    for part, kw in (("scan", dict(w=w)), ("roll", dict(w=w)), ("col", dict(parts=parts))):
        got = pr.scan_resample(part, **kw)
        assert torch.equal(got, scan_resample_reference(part, **kw)), part
        if part != "col":
            assert torch.equal(got.cpu(), scan_resample_reference(part, w=w.cpu())), part
    assert pr.launch_count["scan_resample"] == 3
    if n == 4096:
        assert pr.scan_shape("scan", n) == dict(grid=1, threads=512, per=8, smem=0)
        assert pr.scan_shape("roll", n) == dict(grid=8, threads=128, per=4, smem=0)
        assert pr.scan_shape("col", n) == dict(grid=8, threads=128, per=4, smem=0)


SWEEP_CASES = [  # (h, w, t, stride, max_range_px, compact)
    (146, 288, 90, 90, 240, False), (146, 288, 90, 1024, 240, False),
    (200, 160, 120, 1024, 60, True), (200, 160, 120, 1536, 400, True),
    (64, 64, 64, 512, 300, False),
    # config #1's unpadded stride (rows not 4 B aligned) at the largest u8
    # range (C = 255 fills a lane); u16 at the u16 golden trace's 507 px
    (146, 288, 1439, 1439, 254, False), (200, 160, 120, 1024, 507, True),
    (120, 300, 90, 1024, 507, False),
]


def _sweep_occ(h, w, seed):
    rng = np.random.default_rng(seed)
    occ = np.zeros((h, w), bool)
    occ[[0, -1], :] = occ[:, [0, -1]] = True
    for _ in range(6):
        r, c = rng.integers(4, h - 12), rng.integers(4, w - 12)
        occ[r:r + rng.integers(2, 9), c:c + rng.integers(2, 9)] = True
    return occ


@pytest.mark.parametrize("h, w, t, stride, mrp, compact", SWEEP_CASES,
                         ids=[f"{c[0]}x{c[1]}-T{c[2]}-s{c[3]}-{c[4]}px-{'compact' if c[5] else 'dense'}"
                              for c in SWEEP_CASES])
def test_range_lut_sweep_kernel_equals_plain(cuda, h, w, t, stride, mrp, compact):
    """The sweep kernel bit for bit its plain version on the card and on
    the CPU (dense and compact, u8 and u16, stride T and padded)."""
    from monte_carlo_localization_tpu_torch.mapping import clearance_field
    from monte_carlo_localization_tpu_torch.mapping.range_lut_device import (
        build_compact_range_lut_device,
        build_range_lut_device,
        shear_groups,
    )
    from monte_carlo_localization_tpu_torch.ops.range_lut_sweep import sweep

    occ = _sweep_occ(h, w, h + stride)
    dev_occ = torch.from_numpy(occ).to(cuda)
    before = sweep.launch_count
    if compact:
        clr = clearance_field(occ, mrp + 4)
        dt = np.uint8 if mrp <= 254 else np.uint16

        def build(o, plain=False):
            return build_compact_range_lut_device(o, clr, t, mrp, stride, lut_dtype=dt,
                                                  plain=plain)[0]
    else:
        def build(o, plain=False):
            return build_range_lut_device(o, t, mrp, stride, plain=plain)
    got = build(dev_occ)
    torch.cuda.synchronize()
    assert sweep.launch_count - before == len(shear_groups(h, w, t, stride))
    assert torch.equal(got, build(dev_occ, plain=True))
    assert torch.equal(got.cpu(), build(torch.from_numpy(occ)))


def _chunk_start_occ(h, w, t, stride, mrp, device):
    """Occupied cells (every fifth of a line) on the lines each group's
    chunks start at, and one line before and after, in sweep order."""
    from monte_carlo_localization_tpu_torch.mapping.range_lut_device import shear_groups
    from monte_carlo_localization_tpu_torch.ops.range_lut_sweep import sweep

    occ = np.zeros((h, w), bool)
    itemsize = 1 if mrp <= 254 else 2
    for g in shear_groups(h, w, t, stride):
        p_len, q_len = (h, w) if g.row_major else (w, h)
        plan = sweep.plan(p_len, q_len, g.bins, itemsize, mrp, device)
        assert plan["chunks"] > 1
        for first in range(plan["lines"], p_len, plan["lines"]):
            for i in (first - 1, first, first + 1):
                if 0 <= i < p_len:
                    p = i if g.forward else p_len - 1 - i
                    if g.row_major:
                        occ[p, p % 5::5] = True
                    else:
                        occ[p % 5::5, p] = True
    return occ


@pytest.mark.parametrize("kind", ["chunk_starts", "chunk_starts_u16", "empty"])
def test_range_lut_sweep_kernel_edges(cuda, kind):
    """The redesigned kernel's edges, bit for bit its plain version:
    occupied cells exactly at the chunk starts and one line either side,
    in u8 and u16 (partial tiles at the runs' ends, stride 1024 for 90
    bins); an empty map at 254 px, where every chain runs to the map's
    edge, past C, and every warm-up starts saturated."""
    from monte_carlo_localization_tpu_torch.mapping.range_lut_device import (
        build_range_lut_device,
        shear_groups,
    )
    from monte_carlo_localization_tpu_torch.ops.range_lut_sweep import sweep

    if kind == "empty":
        h, w, t, stride, mrp = 300, 280, 64, 512, 254
        occ = np.zeros((h, w), bool)
    else:
        h, w, t, stride = 260, 300, 90, 1024
        mrp = 20 if kind == "chunk_starts" else 300
        occ = _chunk_start_occ(h, w, t, stride, mrp, cuda)
    dev_occ = torch.from_numpy(occ).to(cuda)
    before = sweep.launch_count
    got = build_range_lut_device(dev_occ, t, mrp, stride)
    torch.cuda.synchronize()
    assert sweep.launch_count - before == len(shear_groups(h, w, t, stride))
    assert torch.equal(got, build_range_lut_device(dev_occ, t, mrp, stride, plain=True))
    if kind == "empty":
        assert int(got.max()) == mrp  # chains saturate


def test_range_lut_sweep_kernel_longest_line(cuda):
    """A line of MAX_LINE_CELLS cells (one word a cell, D in shared
    memory) bit for bit the plain version on the CPU; one cell more keeps
    D in global memory, every group still through the kernel, bit for bit
    the same."""
    from monte_carlo_localization_tpu_torch.mapping.range_lut_device import (
        build_range_lut_device,
        shear_groups,
    )
    from monte_carlo_localization_tpu_torch.ops.range_lut_sweep import (
        MAX_LINE_CELLS,
        line_words,
        sweep,
    )

    assert line_words(MAX_LINE_CELLS) == 1
    assert not sweep.plan(4, MAX_LINE_CELLS, np.arange(2), 1, 20, cuda)["global_d"]
    occ = np.zeros((4, MAX_LINE_CELLS), bool)
    occ[1, ::997] = occ[3, 5::1301] = True
    got = build_range_lut_device(torch.from_numpy(occ).to(cuda), 8, 20, 8)
    assert torch.equal(got.cpu(), build_range_lut_device(torch.from_numpy(occ), 8, 20, 8))
    assert sweep.plan(4, MAX_LINE_CELLS + 1, np.arange(2), 1, 20, cuda)["global_d"]
    longer = np.zeros((4, MAX_LINE_CELLS + 1), bool)
    longer[2, 7::1009] = True
    before = sweep.launch_count
    got = build_range_lut_device(torch.from_numpy(longer).to(cuda), 8, 20, 8)
    assert sweep.launch_count - before == len(shear_groups(4, MAX_LINE_CELLS + 1, 8))
    assert torch.equal(got.cpu(), build_range_lut_device(torch.from_numpy(longer), 8, 20, 8))


@pytest.mark.parametrize("mrp", [20, 300], ids=["u8", "u16"])
def test_range_lut_sweep_kernel_global_d(cuda, monkeypatch, mrp):
    """Rows past MAX_LINE_CELLS (D in global memory) over enough lines for
    chunks with warm-ups, bit for bit the plain version on the CPU; with
    the scratch cut to one block, that block loops over every (tile,
    chunk) item, bit for bit the same."""
    from monte_carlo_localization_tpu_torch.mapping.range_lut_device import (
        build_range_lut_device,
        shear_groups,
    )
    from monte_carlo_localization_tpu_torch.ops import range_lut_sweep
    from monte_carlo_localization_tpu_torch.ops.range_lut_sweep import (
        MAX_LINE_CELLS,
        d_bytes,
        sweep,
    )

    h, w, t = 200, MAX_LINE_CELLS + 40, 256
    occ = _sweep_occ(h, w, 9)
    want = build_range_lut_device(torch.from_numpy(occ), t, mrp, t)
    dev_occ = torch.from_numpy(occ).to(cuda)
    rows = next(g for g in shear_groups(h, w, t, t) if g.row_major)
    itemsize = 1 if mrp < 255 else 2
    plan = sweep.plan(h, w, rows.bins, itemsize, mrp, cuda)
    assert plan["global_d"] and plan["chunks"] > 1 and plan["warm_lines"] > 0
    before = sweep.launch_count
    got = build_range_lut_device(dev_occ, t, mrp, t)
    assert sweep.launch_count - before == len(shear_groups(h, w, t, t))
    assert torch.equal(got.cpu(), want)
    monkeypatch.setattr(range_lut_sweep, "SCRATCH_BYTES", d_bytes(w, plan["words"]))
    plan = sweep.plan(h, w, rows.bins, itemsize, mrp, cuda)
    assert plan["grid"] == 1 < plan["blocks"]
    assert torch.equal(build_range_lut_device(dev_occ, t, mrp, t).cpu(), want)


def test_range_lut_sweep_member_blocks_in_one_buffer(cuda):
    """Two members' blocks written in place at their row bases through
    GridMap.with_member_compact_luts and with_member_luts on the card equal
    the same fleet's LUTs on the CPU, where the native builder builds them."""
    from monte_carlo_localization_tpu_torch.mapping import map_from_occupancy
    from monte_carlo_localization_tpu_torch.parallel import stack_maps

    def fleet(device):
        return stack_maps([
            map_from_occupancy(np.where(_sweep_occ(h, w, h), 100, 0).astype(np.int8),
                               resolution=0.05, max_range_meters=mr, device=device)
            for h, w, mr in ((120, 90, 3.0), (80, 140, 3.0))])

    on_card, on_host = fleet(cuda), fleet("cpu")
    for attach in (lambda g: g.with_member_compact_luts(90, 1024, 512),
                   lambda g: g.with_member_luts(90, 1024, 512, use_cache=False)):
        card, host = attach(on_card), attach(on_host)
        assert card.lut_route == "kernel" and host.lut_route == "native"
        for field in ("range_lut", "lut_row_map", "lut_member_base", "lut_row_map_base"):
            a, b = getattr(card, field), getattr(host, field)
            assert (a is None and b is None) or torch.equal(a.cpu(), b), field


def test_range_lut_sweep_raises_without_its_library(cuda, monkeypatch):
    """A map on the card never falls back to the host builder: a missing
    kernel library or a failed build raises."""
    from monte_carlo_localization_tpu_torch.mapping import map_from_occupancy
    from monte_carlo_localization_tpu_torch.ops import _cuda_build

    gm = map_from_occupancy(np.where(_sweep_occ(64, 64, 1), 100, 0).astype(np.int8),
                            resolution=0.05, max_range_meters=2.0, device=cuda)
    built = _cuda_build.load_library()
    libs = {k: v for k, v in built.libs.items() if k != "range_lut_sweep"}
    monkeypatch.setattr(_cuda_build, "load_library",
                        lambda: _cuda_build.BuiltLibrary(libs, built.paths, 0.0, ""))
    with pytest.raises(RuntimeError, match="range_lut_sweep kernel library was not built"):
        gm.with_range_lut(90)

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(_cuda_build, "load_library", no_nvcc)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        gm.with_compact_range_lut(90, 512)


@pytest.mark.parametrize("method", ["lut", "sphere", "dda"])
def test_methods_on_the_card_match_the_cpu(cuda, method):
    """sphere, dda and lut on the card against the CPU on the same draws:
    poses within 1e-3 and 99% of rows within 1e-4 (cos/sin may differ by
    an ulp between the two, which can move a grazing ray by one cell)."""
    from monte_carlo_localization_tpu_torch import MCLConfig, MCLState, ParticleFilter
    from monte_carlo_localization_tpu_torch.mapping import map_from_occupancy
    from monte_carlo_localization_tpu_torch.ops.raycast import cast_rays_dda

    occ = np.where(_sweep_occ(120, 160, 3), 100, 0).astype(np.int8)
    cfg = MCLConfig(max_particles=512, raycast_method=method, lut_theta_bins=360)
    beams = _beams(60)
    pfs = {d: ParticleFilter(map_from_occupancy(occ, resolution=0.05, max_range_meters=4.0,
                                                device=d), cfg, beam_angles=beams)
           for d in ("cpu", cuda)}
    if method == "lut":
        assert pfs[cuda].grid_map.lut_route == "kernel"
        assert torch.equal(pfs[cuda].grid_map.range_lut.cpu(), pfs["cpu"].grid_map.range_lut)
    truth = np.float32([3.0, 2.5, 0.4])
    bt = torch.from_numpy(beams)
    q = torch.stack([torch.full_like(bt, 3.0), torch.full_like(bt, 2.5), 0.4 + bt], 1)
    scans = np.stack([cast_rays_dda(pfs["cpu"].grid_map, q).numpy()] * 3)
    rng = np.random.default_rng(5)
    parts = (truth + rng.normal(0, 0.1, (512, 3))).astype(np.float32)
    u0 = rng.uniform(size=3).astype(np.float32)
    noise = rng.normal(size=(3, 512, 3)).astype(np.float32)
    actions = np.float32([[0.03, 0.0, 0.01]] * 3)
    out = {}
    for d, pf in pfs.items():
        st = MCLState.from_numpy(parts, np.zeros(512, np.float32), seed=0, device=d)
        st, poses = pf.step_many(st, actions, scans, u0=u0, noise=noise)
        out[d] = (poses.cpu().numpy(), st.particles.cpu().numpy())
    np.testing.assert_allclose(out[cuda][0], out["cpu"][0], rtol=0, atol=1e-3)
    rows = np.all(np.abs(out[cuda][1] - out["cpu"][1]) <= 1e-4, axis=1)
    assert rows.mean() >= 0.99, rows.mean()


def test_long_lines_on_the_card_equal_the_native_builder(cuda):
    """A card map with rows past MAX_LINE_CELLS builds by the kernel (D in
    global memory for its rows), every group one launch, and its dense
    and compact LUTs equal the native host builder's bit for bit."""
    from monte_carlo_localization_tpu_torch import native
    from monte_carlo_localization_tpu_torch.mapping import corridor_world
    from monte_carlo_localization_tpu_torch.mapping.range_lut import build_range_lut
    from monte_carlo_localization_tpu_torch.mapping.range_lut_device import shear_groups
    from monte_carlo_localization_tpu_torch.native import native_build_compact_range_lut
    from monte_carlo_localization_tpu_torch.ops.range_lut_sweep import MAX_LINE_CELLS, sweep

    if not native.available():
        pytest.skip("no C++ toolchain for the native oracle")
    gm = corridor_world(height=24, width=MAX_LINE_CELLS + 300, corridor_half_width=6,
                        max_range_meters=1.5, device=cuda)
    host = gm.occupied.cpu().numpy()
    groups = len(shear_groups(gm.height, gm.width, 90, 90))
    before = sweep.launch_count
    dense = gm.with_range_lut(90, use_cache=False)
    assert dense.lut_route == "kernel" and sweep.launch_count - before == groups
    want = build_range_lut(host, 90, gm.max_range_px, backend="native")
    assert torch.equal(dense.range_lut.cpu(), torch.from_numpy(np.asarray(want).reshape(-1)))
    compact = gm.with_compact_range_lut(90, 512)
    assert compact.lut_route == "kernel"
    want = native_build_compact_range_lut(host, 90, gm.max_range_px,
                                          compact.lut_row_map.cpu().numpy(), 512)
    assert torch.equal(compact.range_lut.cpu(), torch.from_numpy(want.reshape(-1)))


def test_fleet_node_on_the_card_matches_the_cpu(cuda):
    """A ``FleetNode`` on the card against one on the CPU, both fed the
    same draws: poses within 1e-3 at every synchronous correction and 99%
    of particle rows within 1e-4; the card's corrections each launch the
    fleet kernel once."""
    from monte_carlo_localization_tpu_torch import MCLConfig
    from monte_carlo_localization_tpu_torch.mapping import map_from_occupancy
    from monte_carlo_localization_tpu_torch.ops.raycast import cast_rays_dda
    from monte_carlo_localization_tpu_torch.parallel import stack_maps
    from monte_carlo_localization_tpu_torch.runtime import FleetNode

    f, n, beams = 4, 256, _beams(60)
    occs = [np.where(_sweep_occ(96, 112, s), 100, 0).astype(np.int8) for s in (3, 4)]
    asg = np.arange(f, dtype=np.int32) % 2
    poses = np.float64([[2.0, 2.2, 0.3], [3.1, 2.6, -0.4], [2.4, 3.0, 1.2], [3.5, 1.8, 2.5]])
    cpu_maps = [map_from_occupancy(o, resolution=0.05, max_range_meters=4.0, device="cpu")
                for o in occs]
    scans = []
    for i, p in enumerate(poses):
        bt = torch.from_numpy(beams)
        q = torch.stack([torch.full_like(bt, p[0]), torch.full_like(bt, p[1]), p[2] + bt], 1)
        scans.append(cast_rays_dda(cpu_maps[asg[i]], q.float()).numpy())
    rng = np.random.default_rng(9)
    cloud = (np.repeat(poses[:, None], n, 1) + rng.normal(0, 0.05, (f, n, 3))).astype(np.float32)
    steps = [dict(u0=rng.uniform(size=f).astype(np.float32),
                  noise=rng.normal(size=(f, n, 3)).astype(np.float32)) for _ in range(6)]

    class Draws:
        def __init__(self):
            self.steps = iter(steps)

        def init(self, kind, seed, p):
            return cloud, np.zeros((f, n), np.float32)

        def step(self):
            return next(self.steps)

    nodes = {}
    for d in ("cpu", cuda):
        maps = [map_from_occupancy(o, resolution=0.05, max_range_meters=4.0, device=d)
                for o in occs]
        node = nodes[d] = FleetNode(stack_maps(maps), f, MCLConfig(max_particles=n),
                                    map_assignment=asg, rng_seed=0, draws=Draws())
        node.initialize_pose(poses)
        for m in range(f):
            node.on_scan(m, scans[m], beam_angles=beams)
            node.on_odometry(m, *poses[m], 0.2, 0.1, stamp=0.0)
        node.update(now=0.0)
    q = nodes[cuda].filter.likelihood
    q.fleet_launch_count = 0
    for i in range(6):
        got = {d: node.update(now=0.05 * (i + 1)) for d, node in nodes.items()}
        np.testing.assert_allclose(got[cuda], got["cpu"], rtol=0, atol=1e-3)
        rows = np.all(np.abs(nodes[cuda].state.particles.cpu().numpy()
                             - nodes["cpu"].state.particles.numpy()) <= 1e-4, axis=2)
        assert rows.mean() >= 0.99, (i, rows.mean())
    assert q.fleet_launch_count == 6 and q.launch_count == 0
    assert nodes[cuda].filter.map.lut_route == "kernel"
