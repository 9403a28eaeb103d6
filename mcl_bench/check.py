"""The comparison that decides ``correct``.

For a sample of the window's filter calls (drawn from the seed, kept by
``generator.Recorder``) the reference takes the state the call started
from and works out the rest again: the episode's draws from its seed
(the node's seed stream, then the state's generator, a ``rand(())`` and
a ``randn((N, 3))`` a correction), the actions from the trace and the
tick times, the scans' pixels and the LUT entries the particles read.
A replayed chunk keeps its 62 middle states inside its graph, and a
chain of the reference's own corrections does not stay with the
program's past a few: its float64 log weights sit a rounding from the
program's float32 ones, a systematic resample turns that into a
neighbouring source every other correction, and one such source changes
the next CDF enough to move hundreds. So a call is checked at its ends,
each correction from the program's own state there. The numbers, each
the widest over the sampled calls:

* ``init_gap``: an episode's start cloud against the reference's from
  the same seed (m and rad; the log weights too);
* ``stream_mismatches``: sampled calls whose generator state at the call
  is not the reference's for that point of the episode (a count): a
  chunk that draws for fewer or more corrections than it runs moves the
  next chunk's start;
* ``first_pose_gap``: the pose of a call's first correction against the
  reference's correction of the state the call started from;
* ``particle_gap`` (a call of one correction, a tick): the particles it
  left against that correction's;
* ``copies_gap`` (a call of several, a chunk): its last correction
  against a systematic resample of the particles before it, which the
  reference recovers from the particles left (``Comparison.copies_gap``);
* ``loglik_gap``: the log weights a call left (max-shifted) against the
  beam model of its particles;
* ``pose_gap``: the pose a call returned last against the weighted mean
  of the particles it left, under the reference's weights.

``control=True`` puts the reference, computed in bfloat16, in the
program's place for the same calls: it must come out not correct.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from mcl_bench.reference.mapio import (
    latest_scan,
    load_map,
    load_trace,
    scan_actions,
    tick_action,
)
from mcl_bench.reference.model import LOW, Params, Reference, angle_gap

NUMBERS = ("init_gap", "stream_mismatches", "first_pose_gap", "particle_gap", "copies_gap",
           "loglik_gap", "pose_gap")
# neighbouring slots whose undone particles lie closer than this (m, rad)
# share a source: float32 rounding of the motion is ~1e-5 at 100 m, the
# motion noise between two sources ~1e-2
SAME_SOURCE = 1e-4


def episode_seeds(node_seed: int, count: int) -> list[int]:
    """The seed of each episode's start: the node's own stream (a numpy
    Generator on its seed, one ``integers(2**31)`` a start)."""
    rng = np.random.default_rng(node_seed)
    return [int(rng.integers(2**31)) for _ in range(count)]


def pose_gap(a, b) -> float:
    a, b = torch.as_tensor(np.asarray(a, np.float64)), torch.as_tensor(np.asarray(b, np.float64))
    return max(float(torch.max(torch.abs(a[:2] - b[:2]))), float(angle_gap(a[2], b[2])))


def particle_gap(a: torch.Tensor, b: torch.Tensor) -> float:
    xy = torch.max(torch.abs(a[:, :2].double() - b[:, :2].double()))
    return max(float(xy), float(torch.max(angle_gap(a[:, 2], b[:, 2]))))


class Comparison:
    def __init__(self, cfg: dict, mode: str, node_seed: int, device, paths):
        mcl = cfg["mcl"]
        self.cfg, self.mode, self.node_seed, self.dev = cfg, mode, node_seed, torch.device(device)
        self.trace = load_trace(paths(cfg["trace"]))
        self.ref = Reference(load_map(paths(cfg["map"]), float(mcl["max_range"])),
                             self.trace.beam_angles, Params.of(mcl), device)
        self.actions = scan_actions(self.trace)

    def _start(self, g):
        pose = np.asarray(self.trace.truth_pose[0], np.float64)
        return self.ref.init_cloud(self.cfg["start"], g, pose)

    def _stream(self, episode: int, step: int):
        """The episode's generator, advanced past its start and ``step``
        corrections."""
        g = self.ref.generator(episode_seeds(self.node_seed, episode + 1)[episode])
        self._start(g)
        for _ in range(step):
            self.ref.step_draws(g)
        return g

    def _obs(self, scan_index: int) -> torch.Tensor:
        return self.ref.obs_px(self.trace.scan_ranges[scan_index])

    def start_numbers(self, starts, control: bool) -> float:
        gap = 0.0
        for episode, state in starts:
            g = self.ref.generator(episode_seeds(self.node_seed, episode + 1)[episode])
            want = self._start(g)
            if control:
                got, lw = want.to(LOW).float(), torch.zeros(len(want), device=self.dev)
            else:
                got, lw = state.particles.to(self.dev), state.log_weights.to(self.dev)
            gap = max(gap, particle_gap(got, want), float(torch.max(torch.abs(lw))))
        return gap

    def call_numbers(self, rec, control: bool) -> dict:
        ref = self.ref
        g = self._stream(rec.episode, rec.step)
        same_stream = rec.generator_state is None or torch.equal(
            g.get_state(), rec.generator_state.to(g.get_state().device))
        draws = [ref.step_draws(g) for _ in range(rec.steps)]
        if self.mode == "replay":
            acts = torch.as_tensor(self.actions[rec.step:rec.step + rec.steps], device=self.dev)
            obs = [self._obs(rec.step + k) for k in range(rec.steps)]
        else:
            act = tick_action(self.trace, rec.tau, rec.dt).astype(np.float32)
            acts = torch.as_tensor(act, device=self.dev)[None, :]
            obs = [self._obs(latest_scan(self.trace, rec.tau))]
        p_in = rec.state_in.particles.to(self.dev)
        lw_in = rec.state_in.log_weights.to(self.dev)
        if control:
            parts, lw, poses = p_in, lw_in, []
            for k in range(rec.steps):
                parts, lw, pose = ref.correct(parts, lw, acts[k], obs[k], *draws[k], low=True)
                poses.append(pose.double().cpu().numpy())
            out_p, out_lw, poses = parts, lw.float(), np.stack(poses)
        else:
            out_p = rec.state_out.particles.to(self.dev)
            out_lw = rec.state_out.log_weights.to(self.dev)
            poses = rec.poses.detach().cpu().numpy().astype(np.float64).reshape(rec.steps, 3)
        first_p, _, first_pose = ref.correct(p_in, lw_in, acts[0], obs[0], *draws[0])
        lw_ref = ref.shifted(ref.loglik(out_p, obs[-1]))
        nums = {
            "stream_mismatches": 0.0 if same_stream else 1.0,
            "first_pose_gap": pose_gap(poses[0], first_pose.cpu().numpy()),
            "loglik_gap": float(torch.max(torch.abs(out_lw.double() - lw_ref))),
            "pose_gap": pose_gap(poses[-1], ref.pose(out_p, lw_ref).cpu().numpy()),
        }
        if rec.steps == 1:
            nums["particle_gap"] = particle_gap(out_p, first_p)
        else:
            nums["copies_gap"] = self.copies_gap(out_p, acts[-1], draws[-1][1], obs[-2])
        return nums

    def copies_gap(self, particles, action, noise, parent_obs) -> float:
        """How far the last correction of a call is from a systematic
        resample of the particles before it. Its particles, with the
        correction's own noise taken off and its motion undone, give the
        sources: equal in runs of neighbouring slots, one source a run.
        Systematic resampling gives source j c_j copies with
        |c_j - N w_j| < 1, w_j its weight under the scan before (the beam
        model, up to the normaliser of the N particles, of which the D
        sources carry at least D / N and at most all). The widest
        |c_j - N w_j| at the best normaliser in that range."""
        ref = self.ref
        n = particles.shape[0]
        src = ref.unmove(particles, action, noise)
        step = torch.maximum(torch.max(torch.abs(src[1:, :2] - src[:-1, :2]), dim=1).values,
                             angle_gap(src[1:, 2], src[:-1, 2]))
        new = torch.cat([torch.ones(1, dtype=torch.bool, device=self.dev), step > SAME_SOURCE])
        starts = torch.nonzero(new).flatten()
        copies = torch.diff(torch.cat([starts, torch.tensor([n], device=self.dev)])).double()
        raw = ref.loglik(self.exact_sources(src[starts], particles[starts], action,
                                            noise[starts]), parent_obs)
        e = torch.exp(raw - raw.max())
        lo, hi = math.log(len(starts) / float(e.sum())), math.log(n / float(e.sum()))
        for _ in range(100):  # max_j |c_j - a e_j| is convex in a
            m1, m2 = lo + (hi - lo) / 3, hi - (hi - lo) / 3
            f1 = float(torch.max(torch.abs(copies - math.exp(m1) * e)))
            f2 = float(torch.max(torch.abs(copies - math.exp(m2) * e)))
            lo, hi = (lo, m2) if f1 <= f2 else (m1, hi)
        return float(torch.max(torch.abs(copies - math.exp(0.5 * (lo + hi)) * e)))

    def exact_sources(self, approx, moved, action, noise) -> torch.Tensor:
        """The float32 particles, within two float32 steps of ``approx`` on
        each axis, that ``motion`` takes to ``moved`` bit for bit (the
        nearest such; ``approx`` rounded where none does): undoing the
        motion in float64 lands a step or two off, and a step across a
        cell's or a heading bin's edge reads another LUT window."""
        base = approx.to(torch.float32)
        up1, down1 = torch.nextafter(base, base + 1), torch.nextafter(base, base - 1)
        up2, down2 = torch.nextafter(up1, up1 + 1), torch.nextafter(down1, down1 - 1)
        choices = torch.stack([base, up1, down1, up2, down2])  # (5, D, 3), nearest first
        idx = torch.cartesian_prod(*[torch.arange(5, device=self.dev)] * 3)  # (125, 3)
        idx = idx[torch.argsort(idx.sum(dim=1), stable=True)]
        cand = torch.stack([choices[idx[:, a], :, a] for a in range(3)], dim=-1)  # (125, D, 3)
        fwd = self.ref.motion(cand.reshape(-1, 3), action, noise.repeat(len(idx), 1))
        hit = torch.all(fwd.reshape(cand.shape) == moved[None], dim=-1)  # (125, D)
        first = torch.argmax(hit.to(torch.int8), dim=0)  # 0 (base) where none hits
        return cand[first, torch.arange(cand.shape[1], device=self.dev)]

    def numbers(self, records, starts, control: bool = False) -> dict:
        out = dict.fromkeys(NUMBERS, 0.0)
        out["init_gap"] = self.start_numbers(starts, control)
        for rec in records:
            for k, v in self.call_numbers(rec, control).items():
                out[k] = out[k] + v if k == "stream_mismatches" else max(out[k], v)
        return out


def verdict(numbers: dict, limits: dict) -> tuple[bool, list[str]]:
    """(every number within its limit, the lines that say so)."""
    ok, lines = True, []
    for name, limit in limits.items():
        value = numbers[name]
        good = bool(np.isfinite(value)) and value <= limit
        ok &= good
        lines.append(f"{name} {value!r} limit {limit!r}{'' if good else ' FAIL'}")
    return ok, lines
