"""The port's multi-process fleet (``parallel/multihost.py``) and its
dry runs, as JAX ``tests/test_multihost.py:22-100`` holds the JAX
package's: real OS processes joined over gloo on the CPU, each owning
fleet members, feeding only its own scans and gathering the pose table.

A fleet over a 1-D fleet mesh of two processes is held to JAX's
``FleetFilter(mesh=)`` on two of conftest's virtual devices, on JAX's
per-member draws (``split(key, 3)``: u0 from the second key, the motion
noise from the third), with poses within 1e-3 and at least 99% of
particle rows within 1e-4 (``tests/test_torch_fleet.py``'s gates). The
spawned processes import this module without JAX (it is imported
inside the JAX-side helpers only) and run :func:`_fleet_rank`, which
runs the dry run's process body too and reports whether any JAX module
was loaded, and which ``Programs`` calls the steps made: a 1-D fleet mesh
calls no collective in a correction, so each step is one program (a CUDA
graph on a card), over gloo too."""

import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from monte_carlo_localization_tpu_torch import MCLConfig
from monte_carlo_localization_tpu_torch.mapping import box_world, map_from_occupancy
from monte_carlo_localization_tpu_torch.parallel import (
    FleetState,
    MultiHostFleet,
    multihost_mesh,
)
from monte_carlo_localization_tpu_torch.parallel.multihost import run_dryrun, spawn

BEAMS = np.linspace(-2.35, 2.35, 60).astype(np.float32)
MAP_KW = dict(resolution=0.05, origin=(-1.0, 0.5, 0.0), max_range_meters=6.0)
F, N, STEPS = 4, 64, 3


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _occupancy():
    rng = np.random.default_rng(21)
    occ = np.zeros((64, 80), np.int8)
    occ[:3, :] = occ[-3:, :] = occ[:, :3] = occ[:, -3:] = 100
    for _ in range(4):
        r, c = rng.integers(8, 50, 2)
        occ[r:r + 5, c:c + 7] = 100
    return occ


def test_multihost_dryrun_two_processes(capsys):
    run_dryrun(2, timeout_s=240.0)
    out = capsys.readouterr().out
    assert "MULTIHOST DRYRUN OK (2 processes)" in out and out.count("pose table ok") == 2


def _rendezvous_rank() -> None:
    """A spawned process: one all-reduce over the group, then its
    rendezvous address and whether it joined as a store client."""
    t = torch.ones(1)
    dist.all_reduce(t)
    print(f"RANK {dist.get_rank()} SUM {int(t.item())} COORD {os.environ['MCL_MH_COORD']} "
          f"CLIENT {os.environ.get('TORCHELASTIC_USE_AGENT_STORE')}", flush=True)


def test_spawn_holds_its_rendezvous_port(monkeypatch):
    """``spawn``'s rendezvous store listens in the spawning process from
    before the first rank starts, and the ranks join it as clients: no
    port is probed free and left for rank 0 to bind later, when another
    process may hold it (the race of concurrent spawns under xdist)."""
    import monte_carlo_localization_tpu_torch.parallel.multihost as mh

    def probe():
        raise AssertionError("spawn probed a free port for a rank to bind later")

    monkeypatch.setattr(mh, "_free_port", probe)
    outs = spawn("tests.test_torch_multihost:_rendezvous_rank", 2, timeout_s=240.0)
    lines = [ln.split() for out in outs for ln in out.splitlines() if ln.startswith("RANK")]
    assert sorted(ln[1] for ln in lines) == ["0", "1"]
    assert {ln[3] for ln in lines} == {"2"} and {ln[7] for ln in lines} == {"True"}
    assert len({ln[5] for ln in lines}) == 1


def test_multihost_dryrun_three_processes(capsys):
    """An odd process count: nothing in the mesh, scatter or gather
    assumes a power of two."""
    run_dryrun(3, timeout_s=240.0)
    assert capsys.readouterr().out.count("pose table ok") == 3


def test_multihost_api_single_process():
    """Outside a process group the same API runs on one process: every
    member local, scatter_local the whole table, gather_poses every
    member."""
    from monte_carlo_localization_tpu_torch.runtime.trace import HostRaycaster

    gm = box_world(height=120, width=160, device="cpu")
    beams = np.linspace(-np.pi / 2, np.pi / 2, 12).astype(np.float32)
    mh = MultiHostFleet(gm, fleet_size=4, config=MCLConfig(max_particles=64, raycast_method="lut",
                                                           lut_theta_bins=180),
                        beam_angles=beams)
    assert mh.mesh is None and mh.process_count == 1 and list(mh.local_members) == [0, 1, 2, 3]
    truths = np.stack([np.array([3.013 + 0.15 * m, 2.517 + 0.1 * m, 0.1 * m], np.float32)
                       for m in range(4)])
    caster = HostRaycaster(gm)
    scans = mh.scatter_local(np.stack([caster.scan(p, beams) for p in truths]))
    actions = mh.scatter_local(np.zeros((4, 3), np.float32))
    state = mh.init_pose(truths, seed=4)
    for _ in range(3):
        state, poses = mh.step(state, actions, scans)
    table = mh.gather_poses(poses)
    assert table.shape == (4, 3)
    assert np.linalg.norm(table[:, :2] - truths[:, :2], axis=1).max() < 0.5
    with pytest.raises(ValueError, match="local rows"):
        mh.scatter_local(np.zeros((3, 3), np.float32))


def test_multihost_fleet_with_dedup_slots_builds(monkeypatch):
    """``pallas_dedup_slots`` on a fleet of four in one process: the query
    resolves the slots to 0, as the JAX fleet does, and a step runs the
    fleet form of the likelihood, not the dedup path."""
    from monte_carlo_localization_tpu_torch.ops import lut_query as tlut

    gm = map_from_occupancy(_occupancy(), **MAP_KW, device="cpu")
    mh = MultiHostFleet(gm, F, MCLConfig(max_particles=N, raycast_method="lut_pallas",
                                         pallas_dedup_slots=4), beam_angles=BEAMS)
    q = mh.fleet.likelihood
    assert q.fleet and q.dedup_slots == 0
    monkeypatch.setattr(tlut, "lut_dedup_reference",
                        lambda *a, **k: pytest.fail("a fleet reached the dedup path"))
    poses0 = np.float32([[1.0, 1.2, 0.3], [1.5, 0.9, 0.1], [1.2, 1.4, -0.5], [1.1, 1.6, 2.0]])
    scans = np.random.default_rng(3).uniform(0.3, 5.0, (F, 60)).astype(np.float32)
    state, poses = mh.step(mh.init_pose(poses0, seed=1), mh.scatter_local(np.zeros((F, 3))),
                           mh.scatter_local(scans))
    assert mh.gather_poses(poses).shape == (F, 3)
    assert q.fleet_launch_count == q.dedup_launch_count == 0


def test_multihost_fleet_size_must_divide(fleet_runs):
    assert "must divide over 2 processes" in fleet_runs["outs"][0]["divide_error"]


def test_multihost_mesh_is_process_major(fleet_runs):
    """The load-bearing mesh property: ranks enumerate process-major, so
    block-split members stay on their process."""
    for r, out in enumerate(fleet_runs["outs"]):
        assert out["mesh"] == [0, 1] and out["members"] == [2 * r, 2 * r + 1]


def test_fleet_over_a_fleet_mesh_tracks_jax_on_its_draws(fleet_runs):
    ref, outs = fleet_runs["jax"], fleet_runs["outs"]
    for r, out in enumerate(outs):
        np.testing.assert_array_equal(out["table"][-1], np.concatenate(
            [o["poses"][-1] for o in outs]))  # every process gathers the same table
        members = out["members"]
        np.testing.assert_allclose(out["poses"], ref["poses"][:, members], rtol=0, atol=1e-3)
        for k in range(STEPS):
            row_ok = np.all(np.abs(out["particles"][k] - ref["particles"][k][members]) <= 1e-4,
                            axis=2)
            assert row_ok.mean() >= 0.99, f"rank {r} step {k}: {row_ok.mean():.3f} rows equal"
        assert out["fleet_launches"] == 0  # CPU tensors: the plain version


def test_stacked_map_fleet_over_a_fleet_mesh_keeps_its_rows(fleet_runs):
    """Over a fleet mesh the ``lut`` path keeps only its members' maps:
    its draws, rows and poses are the one-process fleet's."""
    init, rows, poses = _stacked_lut_fleet(fleet_runs["inp"], None)
    for out in fleet_runs["outs"]:
        m = out["members"]
        np.testing.assert_array_equal(out["stacked_init"], init[m])
        np.testing.assert_array_equal(out["stacked_particles"], rows[m])
        np.testing.assert_allclose(out["stacked_poses"], poses[m], rtol=0, atol=1e-6)


def test_a_fleet_over_a_fleet_mesh_steps_through_its_programs(fleet_runs):
    """No collective in a correction: each process's step is the unmeshed
    fleet's program (a graph on a card), over gloo too."""
    for out in fleet_runs["outs"]:
        assert out["program_calls"] == ["fleet_step"] * STEPS


def test_spawned_processes_import_no_jax(fleet_runs):
    assert all(out["jax_modules"] == [] for out in fleet_runs["outs"])


def test_dryrun_multichip_four_processes():
    from monte_carlo_localization_tpu_torch.tools.dryrun_multichip import dryrun_multichip

    out = dryrun_multichip(4, timeout_s=240.0)
    assert "dryrun_multichip(4) OK" in out and "fallback bitwise" in out


# ---------------------------------------------------------------------------
# the meshed fleet: JAX in this process, the port in two spawned ones
# ---------------------------------------------------------------------------


def _stacked_lut_fleet(inp, mesh):
    """A fleet of one map a member (a stacked map) under ``lut``, on
    ``mesh`` or on one process: its ``init_global`` rows, then its rows
    and poses after STEPS corrections on the given draws from a given
    cloud."""
    from monte_carlo_localization_tpu_torch.parallel import FleetFilter, stack_maps

    occ_b = np.full((64, 80), 100, np.int8)
    occ_b[3:-3, 3:-3] = 0
    maps = [map_from_occupancy(o, **MAP_KW, device="cpu") for o in (inp["occ"], occ_b)]
    ff = FleetFilter(stack_maps([maps[m % 2] for m in range(F)]), F,
                     MCLConfig(max_particles=N, raycast_method="lut", lut_theta_bins=90),
                     beam_angles=BEAMS, mesh=mesh)
    init = ff.init_global(seed=2).particles.numpy()
    state = FleetState.from_numpy(inp["p0"], inp["lw0"], seed=0, device="cpu")
    if mesh is not None:
        state = ff.place_state(state)
    for k in range(STEPS):
        state, poses = ff.step(state, inp["actions"][k], inp["scans"], u0=inp["u0"][k],
                               noise=inp["noise"][k])
    return init, state.particles.numpy(), poses.numpy()


def _fleet_rank():
    from monte_carlo_localization_tpu_torch.parallel.multihost import _dryrun_child
    from tests.test_torch_sharded import program_calls

    _dryrun_child()  # the dry run's own process body, under the same jax check
    io = Path(os.environ["MCL_TEST_IO"])
    inp = dict(np.load(io / "in.npz"))
    gm = map_from_occupancy(inp["occ"], **MAP_KW, device="cpu")
    mh = MultiHostFleet(gm, F, MCLConfig(max_particles=N, raycast_method="lut_pallas"),
                        beam_angles=BEAMS)
    state = mh.fleet.place_state(FleetState.from_numpy(inp["p0"], inp["lw0"], seed=0,
                                                       device="cpu"))
    mine = list(mh.local_members)
    poses, rows, tables = [], [], []
    with program_calls() as calls:  # a 1-D fleet mesh: one program a step, over gloo too
        for k in range(STEPS):
            state, p = mh.step(state, mh.scatter_local(inp["actions"][k][mine]),
                               mh.scatter_local(inp["scans"][mine]),
                               u0=inp["u0"][k][mine], noise=inp["noise"][k][mine])
            poses.append(p.numpy())
            rows.append(state.particles.numpy())
            tables.append(mh.gather_poses(p))
    stacked_init, stacked_rows, stacked_poses = _stacked_lut_fleet(inp, mh.mesh)
    try:
        MultiHostFleet(gm, F + 1, MCLConfig(max_particles=N, raycast_method="lut"))
        divide_error = ""
    except ValueError as e:
        divide_error = str(e)
    result = dict(
        poses=np.stack(poses), particles=np.stack(rows), table=np.stack(tables),
        members=mine, mesh=mh.mesh.mesh.tolist(), divide_error=divide_error,
        program_calls=[key[0] for key in calls],
        fleet_launches=mh.fleet.likelihood.fleet_launch_count,
        stacked_init=stacked_init, stacked_particles=stacked_rows, stacked_poses=stacked_poses,
        jax_modules=sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
                           or m.startswith("monte_carlo_localization_tpu.")),
    )
    np.save(io / f"out{dist.get_rank()}.npy", np.asarray(result, dtype=object),
            allow_pickle=True)


def _jax_fleet(occ, scans, actions):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from monte_carlo_localization_tpu.config import MCLConfig as JMCLConfig
    from monte_carlo_localization_tpu.mapping import map_from_occupancy as j_map
    from monte_carlo_localization_tpu.parallel import FleetFilter as JFleetFilter

    jff = JFleetFilter(j_map(occ, **MAP_KW), fleet_size=F,
                       config=JMCLConfig(max_particles=N, raycast_method="lut_pallas"),
                       beam_angles=BEAMS, mesh=Mesh(np.array(jax.devices()[:2]), ("fleet",)))
    poses0 = np.float32([[1.0, 1.2, 0.3], [1.5, 0.9, 0.1], [1.2, 1.4, -0.5], [1.1, 1.6, 2.0]])
    js = jff.init_pose(poses0, seed=1)
    ref = dict(p0=np.asarray(js.particles), lw0=np.asarray(js.log_weights))
    u0, noise, poses, rows = [], [], [], []
    for k in range(STEPS):
        draws = [jax.random.split(key, 3) for key in js.keys]
        u0.append(np.float32([float(jax.random.uniform(kr, ())) for _, kr, _ in draws]))
        noise.append(np.stack([np.asarray(jax.random.normal(km, (N, 3), jnp.float32))
                               for _, _, km in draws]))
        js, p = jff.step(js, actions[k], scans)
        poses.append(np.asarray(p))
        rows.append(np.asarray(js.particles))
    ref.update(u0=np.stack(u0), noise=np.stack(noise), poses=np.stack(poses),
               particles=np.stack(rows))
    return ref


@pytest.fixture(scope="module")
def fleet_runs(tmp_path_factory):
    from tests.conftest import synth_scan

    from monte_carlo_localization_tpu.mapping import map_from_occupancy as j_map

    occ = _occupancy()
    jm = j_map(occ, **MAP_KW)
    truths = np.float32([[1.05, 1.15, 0.32], [1.45, 0.95, 0.12], [1.25, 1.35, -0.48],
                         [1.15, 1.55, 2.02]])
    scans = np.stack([synth_scan(jm, t, BEAMS) for t in truths])
    actions = np.stack([np.tile(np.float32([0.04, 0.0, 0.02]) * (k + 1), (F, 1))
                        for k in range(STEPS)])
    ref = _jax_fleet(occ, scans, actions)
    io = tmp_path_factory.mktemp("multihost")
    inp = dict(occ=occ, scans=scans, actions=actions, p0=ref["p0"], lw0=ref["lw0"],
               u0=ref["u0"], noise=ref["noise"])
    np.savez(io / "in.npz", **inp)
    spawn("tests.test_torch_multihost:_fleet_rank", 2, timeout_s=240.0,
          env={"MCL_TEST_IO": str(io)})
    outs = [np.load(io / f"out{r}.npy", allow_pickle=True).item() for r in range(2)]
    return dict(jax=ref, outs=outs, inp=inp)


def test_single_process_mesh_is_none():
    assert not dist.is_initialized() and multihost_mesh() is None
