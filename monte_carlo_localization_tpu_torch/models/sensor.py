"""4-component beam sensor model, as in the JAX package's
``models/sensor.py``.

``table[r, d] = P(observed r px | expected d px)`` mixes a Gaussian hit
term, a short-reading ramp, a max-range spike and a uniform floor,
column-normalized over r (:func:`build_sensor_table`, numpy, float64).
Likelihoods are log-space sums over beams times ``1/squash_factor``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from monte_carlo_localization_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device
from monte_carlo_localization_tpu_torch.utils.geometry import div

_LOG_TINY = 1e-35  # guards log(0) for impossible table entries


def build_sensor_table(
    max_range_px: int,
    z_hit: float = 0.80,
    z_short: float = 0.01,
    z_max: float = 0.07,
    z_rand: float = 0.12,
    sigma_hit: float = 8.0,
) -> np.ndarray:
    """Column-normalized (W, W) mixture table, W = max_range_px + 1; rows
    index the observed range r, columns the expected range d."""
    w = max_range_px + 1
    r = np.arange(w, dtype=np.float64)[:, None]
    d = np.arange(w, dtype=np.float64)[None, :]
    z = r - d

    table = z_hit * np.exp(-(z * z) / (2.0 * sigma_hit * sigma_hit)) / (
        sigma_hit * np.sqrt(2.0 * np.pi)
    )
    with np.errstate(divide="ignore", invalid="ignore"):
        short = 2.0 * z_short * (d - r) / d
    table += np.where((r < d) & (d > 0), short, 0.0)
    table[max_range_px, :] += z_max
    table[:max_range_px, :] += z_rand / max_range_px

    norm = table.sum(axis=0, keepdims=True)
    norm = np.where(norm > 0, norm, 1.0)
    return (table / norm).astype(np.float32)


@dataclass(frozen=True)
class SensorModel:
    """The log LUT on a device plus the model's static coefficients."""

    log_table: torch.Tensor  # (W, W) float32
    max_range_px: int
    resolution: float
    inv_squash_factor: float
    z_hit: float = 0.80
    z_short: float = 0.01
    z_max: float = 0.07
    z_rand: float = 0.12
    sigma_hit: float = 8.0

    @classmethod
    def create(
        cls,
        max_range_px: int,
        resolution: float,
        z_hit: float = 0.80,
        z_short: float = 0.01,
        z_max: float = 0.07,
        z_rand: float = 0.12,
        sigma_hit: float = 8.0,
        squash_factor: float = 2.2,
        device: torch.device | str = DEFAULT_DEVICE,
    ) -> "SensorModel":
        device = resolve_device(device)
        table = build_sensor_table(max_range_px, z_hit, z_short, z_max, z_rand, sigma_hit)
        return cls(
            log_table=torch.from_numpy(np.log(np.maximum(table, _LOG_TINY))).to(device),
            max_range_px=max_range_px,
            resolution=resolution,
            inv_squash_factor=1.0 / squash_factor,
            z_hit=z_hit,
            z_short=z_short,
            z_max=z_max,
            z_rand=z_rand,
            sigma_hit=sigma_hit,
        )

    def to_pixel_index(self, ranges_m: torch.Tensor) -> torch.Tensor:
        """meters -> clipped, rounded pixel index (int32).

        The float px value is clipped at max_range_px first, then rounded
        as floor(x + 0.5) (the reference's std::round on these
        non-negative values). NaN and +inf go to the max bin.
        """
        m = float(self.max_range_px)
        px = div(ranges_m, self.resolution)
        px = torch.nan_to_num(px, nan=m, posinf=m, neginf=0.0)
        px = torch.clamp(px, 0.0, m)
        return torch.floor(px + 0.5).to(torch.int32)

    def log_likelihood(
        self,
        observed_m: torch.Tensor,
        expected_m: torch.Tensor,
        mode: str = "analytic",
    ) -> torch.Tensor:
        """Per-particle squashed log likelihood of the (R,) scan against
        (..., R) expected ranges in meters: ``"table"`` gathers from the
        log LUT, ``"analytic"`` evaluates the same mixture in closed form."""
        obs_px = self.to_pixel_index(observed_m).to(torch.float32)
        return self.log_likelihood_px(obs_px, expected_m, mode)

    def log_likelihood_px(
        self,
        obs_px: torch.Tensor,
        expected_m: torch.Tensor,
        mode: str = "analytic",
    ) -> torch.Tensor:
        """:meth:`log_likelihood` of an observation already binned by
        :meth:`to_pixel_index` (float32 pixel indices, broadcast against
        ``expected_m``)."""
        exp_px = self.to_pixel_index(expected_m)
        if mode == "table":
            w = self.max_range_px + 1
            idx = obs_px.to(torch.int64) * w + exp_px.to(torch.int64)
            logp = self.log_table.reshape(-1)[idx]
            return self.inv_squash_factor * torch.sum(logp, dim=-1)
        if mode != "analytic":
            raise ValueError(f"Unknown sensor mode: {mode!r}")
        logp = self.log_prob_analytic(obs_px, exp_px.to(torch.float32))
        return self.inv_squash_factor * torch.sum(logp, dim=-1)

    def log_prob_analytic(self, r_px: torch.Tensor, d_px: torch.Tensor) -> torch.Tensor:
        """log P(observed r | expected d) for integer pixel bins, closed
        form: the unnormalized mixture plus a per-column normalizer with a
        continuity-corrected Gaussian sum (exact erf)."""
        m = float(self.max_range_px)
        z = r_px - d_px
        inv2s2 = 1.0 / (2.0 * self.sigma_hit * self.sigma_hit)
        gauss_coef = 1.0 / (self.sigma_hit * math.sqrt(2.0 * math.pi))
        p = self.z_hit * gauss_coef * torch.exp(-(z * z) * inv2s2)
        p = p + torch.where(
            r_px < d_px,
            2.0 * self.z_short * (d_px - r_px) / torch.clamp(d_px, min=1.0),
            0.0,
        )
        p = p + torch.where(r_px >= m, self.z_max, 0.0)
        p = p + torch.where(r_px < m, self.z_rand / m, 0.0)

        sq2 = math.sqrt(2.0) * self.sigma_hit
        gauss_sum = 0.5 * (
            torch.special.erf(div(m - d_px + 0.5, sq2))
            - torch.special.erf(div(-d_px - 0.5, sq2))
        )
        norm = (
            self.z_hit * gauss_sum
            + torch.where(d_px > 0, self.z_short * (d_px + 1.0), 0.0)
            + self.z_max
            + self.z_rand
        )
        return torch.log(torch.clamp(p, min=_LOG_TINY)) - torch.log(norm)
