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
