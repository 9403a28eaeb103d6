"""The CUDA kernels (LUT likelihood, mega step) against their plain
PyTorch versions, on a card. Skipped without one. This file imports no jax, so it also runs on a
GPU machine without the JAX package's dependencies:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerance: atol 1e-3. Both sides evaluate the same float32 expressions;
they differ by the kernel's fused multiply-adds, CUDA's expf/logf and
the order of the beam sum. The mega step also resamples from a weight CDF
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


def _case(rng, beams, max_range_px, compact, n, device):
    dtype = np.uint8 if max_range_px <= 254 else np.uint16
    t = suggest_theta_bins(beams)
    stride = required_row_stride(t, beams, np.dtype(dtype).itemsize)
    q = LUTQuery(
        t, beams, height=H, width=W, resolution=RES, origin_x=OX, origin_y=OY,
        max_range_px=max_range_px, row_stride=stride, z_hit=0.8, z_short=0.01,
        z_max=0.07, z_rand=0.12, sigma_hit=8.0, inv_squash=1 / 2.2,
        lut_dtype=dtype, device=device,
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
    assert q.launch_count == 0


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
