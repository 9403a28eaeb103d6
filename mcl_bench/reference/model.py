"""The MCL correction by its definition: systematic resampling over the
float32 CDF of the weights, the arc motion model with Gaussian noise, the
four-part beam model over the LUT's expected ranges, the max shift and
the weighted-mean pose.

Precision: the filter's state is float32, and so are the resampler's CDF
(a float64 prefix sum rounded to float32), the motion model and the
float32 address math (cell and heading bin); the beam model, its sum and
the pose are taken in float64 here. ``low=True`` is the control: the
weights, the CDF, the beam model and the pose in bfloat16, the next
precision below the configuration's float32.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from mcl_bench.reference.lut import RangeOracle, beam_offsets, theta_bins
from mcl_bench.reference.mapio import RefMap

OOB_LOG_WEIGHT = -1e4
LOG_TINY = 1e-35
LOW = torch.bfloat16


@dataclass(frozen=True)
class Params:
    """The configuration's numbers the correction reads."""

    num_particles: int
    z_hit: float
    z_short: float
    z_max: float
    z_rand: float
    sigma_hit: float
    squash_factor: float
    dispersion: tuple[float, float, float]
    angle_step: int

    @classmethod
    def of(cls, mcl: dict) -> "Params":
        return cls(
            num_particles=int(mcl["max_particles"]),
            z_hit=float(mcl["z_hit"]), z_short=float(mcl["z_short"]),
            z_max=float(mcl["z_max"]), z_rand=float(mcl["z_rand"]),
            sigma_hit=float(mcl["sigma_hit"]), squash_factor=float(mcl["squash_factor"]),
            dispersion=(float(mcl["motion_dispersion_x"]), float(mcl["motion_dispersion_y"]),
                        float(mcl["motion_dispersion_theta"])),
            angle_step=int(mcl["angle_step"]),
        )


def _div(x: torch.Tensor, c: float) -> torch.Tensor:
    """IEEE x / c in x's precision (a 0-d divisor, not a reciprocal multiply)."""
    return x / torch.tensor(c, dtype=x.dtype, device=x.device)


def wrap(a):
    return torch.atan2(torch.sin(a), torch.cos(a))


def angle_gap(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    d = (a.double() - b.double()) % (2.0 * math.pi)
    return torch.minimum(d, 2.0 * math.pi - d)


class Reference:
    """One map, one beam set and one configuration's correction."""

    def __init__(self, ref_map: RefMap, beam_angles: np.ndarray, params: Params, device):
        self.map, self.p, self.dev = ref_map, params, torch.device(device)
        beams = np.asarray(beam_angles, np.float32)[:: params.angle_step]
        self.t = theta_bins(beams)
        self.base, off = beam_offsets(beams, self.t)
        self.offsets = torch.as_tensor(off, device=self.dev)
        self.oracle = RangeOracle(ref_map.occupied, self.t, ref_map.max_range_px, self.dev)
        self.free = torch.as_tensor(ref_map.free_cells, device=self.dev)

    # ----- draws and start -----
    def generator(self, seed: int) -> torch.Generator:
        g = torch.Generator(device=self.dev)
        g.manual_seed(int(seed))
        return g

    def init_cloud(self, kind: str, g: torch.Generator, pose=None) -> torch.Tensor:
        """(N, 3) float32: Gaussian around ``pose`` (0.5 m, 0.4 rad), or
        uniform over the free cells with a uniform heading."""
        n = self.p.num_particles
        if kind == "pose":
            pose = torch.as_tensor(pose, dtype=torch.float32, device=self.dev)
            e = torch.randn((n, 3), generator=g, dtype=torch.float32, device=self.dev)
            return torch.stack([pose[0] + e[:, 0] * 0.5, pose[1] + e[:, 1] * 0.5,
                                wrap(pose[2] + e[:, 2] * 0.4)], dim=1)
        idx = torch.randint(0, len(self.map.free_cells), (n,), generator=g, device=self.dev)
        cells = self.free[idx]
        x = cells[:, 1].to(torch.float32) * self.map.resolution + self.map.origin_x
        y = cells[:, 0].to(torch.float32) * self.map.resolution + self.map.origin_y
        th = torch.rand(n, generator=g, dtype=torch.float32, device=self.dev) * (2.0 * math.pi)
        return torch.stack([x, y, th], dim=1)

    def step_draws(self, g: torch.Generator) -> tuple[torch.Tensor, torch.Tensor]:
        """One correction's (u0, noise (N, 3)): the offset, then the noise."""
        u0 = torch.rand((), generator=g, device=self.dev)
        noise = torch.randn((self.p.num_particles, 3), generator=g, dtype=torch.float32,
                            device=self.dev)
        return u0, noise

    # ----- the correction's stages -----
    def ancestors(self, log_weights: torch.Tensor, u0: torch.Tensor, low: bool = False):
        """Source index of each output slot: slot s takes the first j with
        N * cdf[j] - u0 >= s, the CDF a float64 prefix sum (by doubling)
        of the float32 softmax, rounded to float32."""
        n = log_weights.shape[0]
        lw = log_weights.to(LOW) if low else log_weights.to(torch.float32)
        w = torch.softmax(lw, dim=0)
        if low:
            cdf = torch.cumsum(w, dim=0)
        else:
            a = torch.zeros(2 * n, dtype=torch.float64, device=self.dev)
            a[n:] = w
            b = torch.zeros_like(a)
            s = 1
            while s < n:
                torch.add(a[n:], a[n - s:2 * n - s], out=b[n:])
                a, b = b, a
                s *= 2
            cdf = a[n:].to(torch.float32)
        g = n * cdf - u0.to(cdf.dtype)
        slots = torch.arange(n, device=self.dev, dtype=torch.float64)
        idx = torch.searchsorted(g[:-1].double().contiguous(), slots, side="left")
        return torch.clamp(idx, max=n - 1)

    @staticmethod
    def _arc(action: torch.Tensor):
        """(ds, dtheta, straight) of a displacement action: dt and the
        velocities reconstructed by the upstream heuristic; float32."""
        act = action.to(torch.float32)[None, :]
        fwd, dth = act[..., 0], act[..., 2]
        afwd = torch.abs(fwd)
        dt_m = torch.clamp(torch.where(afwd < 0.1, _div(afwd, 1.0), _div(afwd, 5.0)), 0.001, 0.1)
        moving = afwd > 0.001
        dt = torch.where(moving, dt_m, 0.01)
        v = torch.where(moving, fwd / dt, 0.0)
        om = torch.where(torch.abs(dth) > 0.001, dth / dt, 0.0)
        return v * dt, om * dt, torch.abs(om) < 1e-6

    def motion(self, particles: torch.Tensor, action: torch.Tensor, noise: torch.Tensor):
        """The arc motion model: exact arc in its chord form, then Gaussian
        noise per axis; float32."""
        ds, dtheta, straight = self._arc(action)
        x, y, th = particles[:, 0], particles[:, 1], particles[:, 2]
        safe = torch.where(torch.abs(dtheta) < 1e-12, 1.0, dtheta)
        chord = ds * (2.0 * torch.sin(dtheta / 2.0) / safe)
        mid = th + dtheta / 2.0
        nx = torch.where(straight, x + ds * torch.cos(th), x + chord * torch.cos(mid))
        ny = torch.where(straight, y + ds * torch.sin(th), y + chord * torch.sin(mid))
        nth = torch.where(straight, th, th + dtheta)
        dx, dy, dthn = self.p.dispersion
        return torch.stack([nx + noise[:, 0] * dx, ny + noise[:, 1] * dy,
                            wrap(nth + noise[:, 2] * dthn)], dim=-1)

    def unmove(self, particles: torch.Tensor, action: torch.Tensor, noise: torch.Tensor):
        """The particles each was moved from, by ``motion`` under
        ``action`` and ``noise``: the noise taken off, the arc undone;
        float64."""
        ds, dtheta, straight = self._arc(action)
        ds, dtheta = ds.double(), dtheta.double()
        p, nz = particles.double(), noise.double()
        dx, dy, dthn = self.p.dispersion
        nx, ny = p[:, 0] - nz[:, 0] * dx, p[:, 1] - nz[:, 1] * dy
        th = torch.where(straight, p[:, 2] - nz[:, 2] * dthn, p[:, 2] - nz[:, 2] * dthn - dtheta)
        safe = torch.where(torch.abs(dtheta) < 1e-12, 1.0, dtheta)
        chord = ds * (2.0 * torch.sin(dtheta / 2.0) / safe)
        mid = th + dtheta / 2.0
        x = torch.where(straight, nx - ds * torch.cos(th), nx - chord * torch.cos(mid))
        y = torch.where(straight, ny - ds * torch.sin(th), ny - chord * torch.sin(mid))
        return torch.stack([x, y, wrap(th)], dim=-1)

    def obs_px(self, ranges_m: np.ndarray) -> torch.Tensor:
        """A scan's beams (every ``angle_step``-th range) in pixels: clipped
        to the max range, rounded half up; NaN and inf read as max."""
        m = float(self.map.max_range_px)
        r = torch.as_tensor(np.asarray(ranges_m, np.float32)[:: self.p.angle_step],
                            device=self.dev)
        px = torch.nan_to_num(_div(r, self.map.resolution), nan=m, posinf=m, neginf=0.0)
        return torch.floor(torch.clamp(px, 0.0, m) + 0.5).to(torch.float64)

    def windows(self, particles: torch.Tensor):
        """(cell row, cell col, heading bin, off map) by float32 address math:
        truncating cell, heading bin rounded half to even, shifted by the
        beam set's base bin."""
        x, y, th = (particles[:, i].to(torch.float32) for i in range(3))
        gm = self.map
        gx = _div(x - gm.origin_x, gm.resolution).to(torch.int32)
        gy = _div(y - gm.origin_y, gm.resolution).to(torch.int32)
        h, w = gm.shape
        oob = (gx < 0) | (gx >= w) | (gy < 0) | (gy >= h)
        b0 = torch.round(th * (self.t / (2.0 * math.pi))).to(torch.int64) + self.base
        return gy.clamp(0, h - 1), gx.clamp(0, w - 1), b0 % self.t, oob

    def loglik(self, particles: torch.Tensor, obs_px: torch.Tensor, low: bool = False):
        """Squashed log likelihood of each particle (float64; bfloat16
        with ``low``), -1e4 off the map."""
        gy, gx, b0, oob = self.windows(particles)
        bins = (b0[:, None] + self.offsets[None, :]) % self.t
        d = self.oracle.entries(gy[:, None].expand_as(bins), gx[:, None].expand_as(bins), bins)
        dt = LOW if low else torch.float64
        p = self.p
        m = float(self.map.max_range_px)
        obs = torch.clamp(obs_px.to(dt), max=m)[None, :]
        d = torch.clamp(d.to(dt), max=m)
        z = obs - d
        prob = p.z_hit / (p.sigma_hit * math.sqrt(2.0 * math.pi)) * torch.exp(
            -(z * z) / (2.0 * p.sigma_hit ** 2))
        prob = prob + torch.where(obs < d, 2.0 * p.z_short * (d - obs) / torch.clamp(d, min=1.0),
                                  0.0)
        prob = prob + torch.where(obs >= m, p.z_max, 0.0) + torch.where(obs < m, p.z_rand / m, 0.0)
        sq2 = math.sqrt(2.0) * p.sigma_hit
        erf = torch.special.erf
        gauss = 0.5 * (erf((m - d + 0.5) / sq2) - erf((-d - 0.5) / sq2))
        norm = p.z_hit * gauss + torch.where(d > 0, p.z_short * (d + 1.0), 0.0) + p.z_max + p.z_rand
        logp = torch.log(torch.clamp(prob, min=LOG_TINY)) - torch.log(norm)
        lw = logp.sum(dim=1) / p.squash_factor
        return torch.where(oob, torch.tensor(OOB_LOG_WEIGHT, dtype=dt, device=self.dev), lw)

    @staticmethod
    def shifted(lw: torch.Tensor) -> torch.Tensor:
        return lw - lw.max()

    @staticmethod
    def pose(particles: torch.Tensor, lw: torch.Tensor) -> torch.Tensor:
        """Weighted mean x, y and circular-mean heading, in lw's precision."""
        w = torch.softmax(lw, dim=0)
        pt = particles.to(lw.dtype)
        s = torch.sum(w * torch.sin(pt[:, 2]))
        c = torch.sum(w * torch.cos(pt[:, 2]))
        return torch.stack([torch.sum(w * pt[:, 0]), torch.sum(w * pt[:, 1]), torch.atan2(s, c)])

    def correct(self, particles, log_weights, action, obs_px, u0, noise, low: bool = False):
        """One correction: (particles (N, 3) float32, shifted log weights,
        pose)."""
        prop = self.motion(particles[self.ancestors(log_weights, u0, low)], action, noise)
        lw = self.shifted(self.loglik(prop, obs_px, low))
        return prop, lw, self.pose(prop, lw)
