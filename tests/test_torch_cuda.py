"""The CUDA kernels (LUT likelihood with and without the sub-bin lerp,
unique-window LUT likelihood, mega step) against their plain PyTorch
versions, on a card. Skipped without one. This file imports no jax, so it also runs on a
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
    return (-0.75 * np.pi + np.arange(num_beams) * 1.5 * np.pi / (num_beams - 1)).astype(np.float32)


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
    assert step.launch_count == 1 and step.grid_blocks() >= 132
    rows = (out_p - want_p).abs().le(1e-5).all(dim=1)
    assert float(rows.float().mean()) >= 0.99
    assert float((out_w - want_w)[rows].abs().max()) <= 1e-3
    rel = ((sums[:5] - want_s[:5]).abs() / want_s[:5].abs().clamp(min=1e-30)).max()
    assert float(rel) <= 1e-4
    assert abs(float(sums[5] - want_s[5])) <= 1e-3
    assert bool((want_w + want_s[5] == -1e4).any())  # off-map rows were drawn


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
