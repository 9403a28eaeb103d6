"""A whole run of a cell on the CPU (the look for a card skipped, the
program's plain kernels, few particles) comes out correct, and comes out
not correct with the timed path broken underneath it: a step that
returns its state unchanged, a pose taken over half the particles, a
pose altered where it is produced, and inside a replayed chunk every
correction given the first one's action, no resample after the first
correction, or the first correction's draws used again; and the control,
the reference in bfloat16 in the program's place, fails the cell's
limits.

The basement cells share every path these runs take; their 5.13 GB LUT
is a card's to build, so they are proved on the card (PERF.md)."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from mcl_bench import run, spec
from mcl_bench.check import verdict

CELLS = ("track_replay", "track_live")
SEED = 2**31 + 11
torch.set_num_threads(1)


@pytest.fixture
def few_particles(monkeypatch):
    config = spec.config

    def small(name):
        cfg = config(name)
        cfg["mcl"]["max_particles"] = 256
        return cfg

    monkeypatch.setattr(spec, "config", small)


def _run(cell: str, capsys) -> dict:
    rc = run.main(["--workload", cell, "--seed", str(SEED), "--seconds", "0.05", "--trace", "0"],
                  require_card=False, device="cpu")
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _unchanged(monkeypatch):
    from monte_carlo_localization_tpu_torch.filter.core import ParticleFilter

    step, step_many = ParticleFilter.step, ParticleFilter.step_many

    def still(self, state, *args, **kwargs):
        return state, step(self, state, *args, **kwargs)[1]

    def still_many(self, state, *args, **kwargs):
        return state, step_many(self, state, *args, **kwargs)[1]

    monkeypatch.setattr(ParticleFilter, "step", still)
    monkeypatch.setattr(ParticleFilter, "step_many", still_many)


def _half(monkeypatch):
    from monte_carlo_localization_tpu_torch.filter import core

    pose = core.expected_pose

    def half(particles, log_weights):
        n = particles.shape[-2] // 2
        return pose(particles[..., :n, :], log_weights[..., :n])

    monkeypatch.setattr(core, "expected_pose", half)


def _altered(monkeypatch):
    from monte_carlo_localization_tpu_torch.filter import core

    pose = core.expected_pose

    def moved(particles, log_weights):
        return pose(particles, log_weights) + torch.tensor([0.01, 0.0, 0.0])

    monkeypatch.setattr(core, "expected_pose", moved)


def _first_action(monkeypatch):
    from monte_carlo_localization_tpu_torch.filter.core import ParticleFilter

    step_many = ParticleFilter.step_many

    def first(self, state, actions, *args, **kwargs):
        a = np.asarray(actions)
        return step_many(self, state, np.repeat(a[:1], len(a), axis=0), *args, **kwargs)

    monkeypatch.setattr(ParticleFilter, "step_many", first)


def _one_resample(monkeypatch):
    from monte_carlo_localization_tpu_torch.filter import core

    resample, step_many = core.resample_indices, core.ParticleFilter.step_many
    calls = [0]

    def chunk(self, *args, **kwargs):
        calls[0] = 0
        return step_many(self, *args, **kwargs)

    def once(log_weights, *args, **kwargs):
        calls[0] += 1
        if calls[0] > 1:
            return torch.arange(log_weights.shape[-1], device=log_weights.device)
        return resample(log_weights, *args, **kwargs)

    monkeypatch.setattr(core.ParticleFilter, "step_many", chunk)
    monkeypatch.setattr(core, "resample_indices", once)


def _first_draws(monkeypatch):
    from monte_carlo_localization_tpu_torch.filter.core import ParticleFilter

    step_many, step = ParticleFilter.step_many, ParticleFilter._step
    first = {}

    def chunk(self, *args, **kwargs):
        first.clear()
        return step_many(self, *args, **kwargs)

    def again(self, state, *args, **kwargs):
        gen = state.generator
        if "state" in first:
            gen.set_state(first["state"])
        else:
            first["state"] = gen.get_state()
        return step(self, state, *args, **kwargs)

    monkeypatch.setattr(ParticleFilter, "step_many", chunk)
    monkeypatch.setattr(ParticleFilter, "_step", again)


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell, few_particles, capsys):
    line = _run(cell, capsys)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    assert "setup_s" in line["metrics"]
    assert all(v["value"] <= v["limit"] for v in line["checks"].values())


@pytest.mark.parametrize("fault", [_unchanged, _half, _altered],
                         ids=["state_unchanged", "half_the_particles", "pose_altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_step_comes_out_not_correct(cell, fault, few_particles, monkeypatch, capsys):
    fault(monkeypatch)
    line = _run(cell, capsys)
    assert line["correct"] is False
    assert any(v["value"] > v["limit"] for v in line["checks"].values())


@pytest.mark.parametrize("fault", [_first_action, _one_resample, _first_draws],
                         ids=["first_action_throughout", "one_resample_a_chunk",
                              "first_draws_again"])
def test_a_chunk_broken_past_its_first_correction_comes_out_not_correct(
        fault, few_particles, monkeypatch, capsys):
    fault(monkeypatch)
    line = _run("track_replay", capsys)
    assert line["correct"] is False
    assert line["checks"]["copies_gap"]["value"] > line["checks"]["copies_gap"]["limit"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_the_cells_limits(cell, few_particles):
    c = spec.cell(spec.benchmark(), cell)
    cfg, traffic = spec.config(c["config"]), spec.traffic(c["traffic"])
    limits = spec.limits(cell)["limits"]
    drv = spec.driver(traffic)
    for seed in (SEED, SEED + 1, SEED + 2):
        session = drv.Session(cfg, traffic, seed, "cpu", spec.data_path)
        session.warm()
        session.run(0.05)
        records, starts = session.samples()
        cmp_ = drv.Comparison(cfg, traffic["mode"], seed, "cpu", spec.data_path)
        assert verdict(cmp_.numbers(records, starts), limits)[0]
        assert not verdict(cmp_.numbers(records, starts, control=True), limits)[0]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ("track_replay", "global_replay", "track_live", "global_live"))
def test_the_control_fails_at_the_cells_own_size_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cell's own size")
    c = spec.cell(spec.benchmark(), cell)
    cfg, traffic = spec.config(c["config"]), spec.traffic(c["traffic"])
    limits = spec.limits(cell)["limits"]
    drv = spec.driver(traffic)
    session = drv.Session(cfg, traffic, SEED, "cuda", spec.data_path)
    session.warm()
    cmp_ = drv.Comparison(cfg, traffic["mode"], SEED, "cuda", spec.data_path)
    for seed in (SEED, SEED + 1, SEED + 2):
        from mcl_bench.calibrate import reseed

        reseed(session, seed)
        session.run(1.0)
        records, starts = session.samples()
        cmp_.node_seed = seed
        assert verdict(cmp_.numbers(records, starts), limits)[0]
        control = cmp_.numbers(records, starts, control=True)
        assert not verdict(control, limits)[0], control
        assert np.isfinite(list(control.values())).all()
