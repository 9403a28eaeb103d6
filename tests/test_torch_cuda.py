"""The CUDA LUT-likelihood kernel against its plain PyTorch version, on a
card. Skipped without one. This file imports no jax, so it also runs on a
GPU machine without the JAX package's dependencies:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerance: atol 1e-3. Both sides evaluate the same float32 expressions;
they differ by the kernel's fused multiply-adds, CUDA's expf/logf and
the order of the beam sum.
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
