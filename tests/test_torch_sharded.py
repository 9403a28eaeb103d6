"""The port's sharded filter (``parallel/sharded.py``) and its bucketed
distributed resampler against the JAX package's, over spawned gloo CPU
processes (one process a shard).

The JAX side runs in this process under ``shard_map`` on the first D of
conftest's 8 virtual CPU devices; the port's side runs in D processes
spawned by ``parallel/multihost.py`` ``spawn``, which import this module
without JAX (JAX is imported inside the JAX-side helpers only) and run
:func:`_rank_main`. Inputs go to the processes, and their rows come
back, as npz files.

Gates:
- the distributed resampler on JAX's own f32 CDF segments and u0, in the
  four cases of JAX ``tests/test_parallel.py:248-317`` (balanced,
  moderate imbalance, extreme imbalance, single source): rows bit for bit
  JAX's, the overflow flag JAX's, and, without overflow, ``torch.equal``
  to the port's all-gather inversion of the same CDF;
- the filter with ``bucketed`` and ``allgather`` resampling: ``torch.equal``
  over four corrections; the fringe-overflow fallback ``torch.equal`` to
  ``allgather``; ``step_many`` equal to chained steps;
- ``step_many`` chunks with a one-slot fringe from JAX's cloud on JAX's
  draws, where a correction after the first overflows: the chunk, run
  again through the all-gather, ``torch.equal`` to the ``allgather`` mode
  and to single steps, and within the single steps' tolerances of JAX;
  the next chunk, on the generators' own draws, equal too; one overflow
  read a chunk;
- the filter on JAX's draws (u0, and each shard's motion noise from
  ``fold_in(k_motion, shard)``, as ``filter/mega.py:146-156`` rebuilds
  them): poses within 1e-3 and at least 99% of particle rows within 1e-4
  of JAX's ``ShardedParticleFilter`` (``tests/test_torch_filter.py:112``);
- weights normalized globally; the validation errors are JAX's;
- a checkpoint written at D = 2 resumes at D = 1 through ``place=``;
- at D = 4, a fleet over a 2 x 2 fleet x particle mesh keeps every
  particle row of the one-process fleet on the same draws, with poses
  within 1e-5, and runs eagerly (its gloo particle axis copies through
  the host): no ``Programs`` call.
"""

import contextlib
import dataclasses
import os
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from monte_carlo_localization_tpu_torch import MCLConfig, MCLState
from monte_carlo_localization_tpu_torch.mapping import map_from_occupancy
from monte_carlo_localization_tpu_torch.ops.resample import (
    distributed_systematic_resample_rows,
    systematic_invert_cdf_window,
)
from monte_carlo_localization_tpu_torch.parallel import (
    FleetFilter,
    FleetState,
    ShardedParticleFilter,
)
from monte_carlo_localization_tpu_torch.parallel.collectives import Collectives, world_mesh
from monte_carlo_localization_tpu_torch.parallel.multihost import spawn
from monte_carlo_localization_tpu_torch.runtime.checkpoint import load_state, save_state
from monte_carlo_localization_tpu_torch.utils.graphs import Programs

BEAMS = np.linspace(-2.35, 2.35, 60).astype(np.float32)
STEPS = 3
N_LOCAL = 32  # particles a shard under lut_pallas
FLEET, FLEET_N = 4, 32  # the 2 x 2 mesh fleet at D = 4


def _occupancy():
    rng = np.random.default_rng(11)
    occ = np.zeros((96, 96), np.int8)
    occ[:3, :] = occ[-3:, :] = occ[:, :3] = occ[:, -3:] = 100
    for _ in range(10):
        r, c = rng.integers(8, 80, 2)
        occ[r:r + 6, c:c + 6] = 100
    return occ


MAP_KW = dict(resolution=0.05, origin=(0.0, 0.0, 0.0), max_range_meters=6.0)


def _resample_cases(d):
    """JAX's four cases (``tests/test_parallel.py:248-317``) at D shards:
    (particles, log weights, fringe)."""
    cases = {}
    rng = np.random.default_rng(0)
    cases["balanced"] = (rng.normal(size=(1024, 3)), rng.normal(size=1024), 64)
    rng = np.random.default_rng(1)
    shard_of = np.arange(1024) // (1024 // d)
    cases["moderate"] = (rng.normal(size=(1024, 3)),
                         0.1 * shard_of + rng.normal(scale=0.5, size=1024), 1024 // d)
    rng = np.random.default_rng(2)
    lw = np.full(512, -100.0)
    lw[-(512 // d):] = 0.0
    cases["extreme"] = (rng.normal(size=(512, 3)), lw, 8)
    rng = np.random.default_rng(3)
    lw = np.full(256, -100.0)
    lw[37] = 0.0
    cases["single"] = (rng.normal(size=(256, 3)), lw, 256 // d)
    return {k: (p.astype(np.float32), w.astype(np.float32), f) for k, (p, w, f) in cases.items()}


@contextlib.contextmanager
def program_calls():
    """The keys of every ``Programs`` call made inside (a spy on the class)."""
    calls, real = [], Programs.__call__

    def spy(self, key, *args, **kwargs):
        calls.append(key)
        return real(self, key, *args, **kwargs)

    Programs.__call__ = spy
    try:
        yield calls
    finally:
        Programs.__call__ = real


# ---------------------------------------------------------------------------
# the port's side: one spawned process a shard
# ---------------------------------------------------------------------------


def _rank_main():
    io = Path(os.environ["MCL_TEST_IO"])
    inp = dict(np.load(io / "in.npz"))
    d, rank = dist.get_world_size(), dist.get_rank()
    mesh = world_mesh("p")
    comm = Collectives.of_mesh(mesh, "p")
    out = {}

    for name in _resample_cases(d):
        particles, cdf = inp[f"{name}_particles"], inp[f"{name}_cdf"]
        u0, fringe = torch.tensor(inp["u0"]), int(inp[f"{name}_fringe"])
        n = particles.shape[0]
        rows = slice(rank * (n // d), (rank + 1) * (n // d))
        local_p, local_cdf = torch.from_numpy(particles[rows]), torch.from_numpy(cdf[rows])
        got, overflow = distributed_systematic_resample_rows(local_p, local_cdf, u0, n, comm,
                                                             d, fringe)
        src = systematic_invert_cdf_window(torch.from_numpy(cdf), u0, n, rank * (n // d), n // d)
        out[f"{name}_bucketed"] = comm.all_gather(got).numpy()
        out[f"{name}_allgather"] = comm.all_gather(torch.from_numpy(particles)[src.long()]).numpy()
        out[f"{name}_overflow"] = np.asarray(bool(overflow))

    gm = map_from_occupancy(inp["occ"], **MAP_KW, device="cpu")
    n_total = N_LOCAL * d
    cfg = MCLConfig(max_particles=n_total, raycast_method="lut_pallas")
    spf = ShardedParticleFilter(gm, cfg, mesh=mesh, beam_angles=BEAMS)
    assert spf.shard == rank and spf.n_local == N_LOCAL

    # on JAX's draws, from JAX's initial cloud
    state = spf.place_state(MCLState.from_numpy(inp["p0"], inp["lw0"], seed=0, device="cpu"))
    poses, quality, rows_k = [], [], []
    for k in range(STEPS):
        state, pose = spf.step(state, inp["actions"][k], inp["scans"][k], u0=inp["draw_u0"][k],
                               noise=inp["draw_noise"][k])
        poses.append(pose.numpy())
        quality.append(spf.log_quality(state))
        rows_k.append(spf.gather_state(state).particles.numpy())
    out.update(jaxdraws_poses=np.stack(poses), jaxdraws_quality=np.float32(quality),
               jaxdraws_particles=np.stack(rows_k),
               jaxdraws_kernel_launches=np.asarray(spf.likelihood.launch_count))
    whole = spf.gather_state(state)
    out["final_log_weights"] = whole.log_weights.numpy()
    out["final_pose"] = poses[-1]

    # bucketed against allgather, on the filter's own draws
    for mode in ("bucketed", "allgather"):
        f = ShardedParticleFilter(gm, cfg.replace(sharded_resample=mode), mesh=mesh,
                                  beam_angles=BEAMS)
        s = f.init_global(seed=5)
        ps = []
        for k in range(4):
            s, p = f.step(s, inp["actions"][k % STEPS], inp["scans"][k % STEPS])
            ps.append(p.numpy())
        whole = f.gather_state(s)
        out[f"{mode}_particles"] = whole.particles.numpy()
        out[f"{mode}_log_weights"] = whole.log_weights.numpy()
        out[f"{mode}_poses"] = np.stack(ps)
        out[f"{mode}_overflow_reads"] = np.asarray(f.overflow_reads)
        if mode == "bucketed" and rank == 0:
            save_state(io / "d2.npz", whole, iters=4)

    # the fringe overflow: all the mass on the last shard, a one-slot fringe
    for mode, fringe in (("bucketed", 1), ("allgather", 0)):
        f = ShardedParticleFilter(gm, cfg.replace(sharded_resample=mode, sharded_fringe=fringe),
                                  mesh=mesh, beam_angles=BEAMS)
        whole = f.gather_state(f.init_global(seed=6))
        lw = torch.full((n_total,), -80.0)
        lw[n_total - N_LOCAL:] = 0.0
        s, p = f.step(f.place_state(dataclasses.replace(whole, log_weights=lw)),
                      np.zeros(3, np.float32), inp["scans"][0])
        out[f"fallback_{mode}_particles"] = f.gather_state(s).particles.numpy()
        out[f"fallback_{mode}_pose"] = p.numpy()
        out[f"fallback_{mode}_count"] = np.asarray(f.fallbacks)

    # step_many against chained steps
    a = spf.init_global(seed=7)
    a, many = spf.step_many(a, inp["actions"], inp["scans"])
    b = spf.init_global(seed=7)
    chained = []
    for k in range(STEPS):
        b, p = spf.step(b, inp["actions"][k], inp["scans"][k])
        chained.append(p)
    out["many_equal"] = np.asarray(torch.equal(many, torch.stack(chained))
                                   and torch.equal(a.particles, b.particles)
                                   and torch.equal(a.log_weights, b.log_weights))

    # chunks with a one-slot fringe: JAX's draws from JAX's cloud, where a
    # correction after the first overflows (its chunk runs again through
    # the all-gather), then a chunk on the generators' own draws; against
    # the all-gather mode and against single steps
    fringe = cfg.replace(sharded_fringe=1)
    for mode in ("bucketed", "allgather"):
        f = ShardedParticleFilter(gm, fringe.replace(sharded_resample=mode), mesh=mesh,
                                  beam_angles=BEAMS)
        s = f.place_state(MCLState.from_numpy(inp["p0"], inp["lw0"], seed=0, device="cpu"))
        s, first = f.step_many(s, inp["actions"], inp["scans"], u0=inp["draw_u0"],
                               noise=inp["draw_noise"])
        rows = f.gather_state(s).particles.numpy()
        reads = [f.overflow_reads]
        s, second = f.step_many(s, inp["actions"], inp["scans"])
        reads.append(f.overflow_reads)
        whole = f.gather_state(s)
        out.update({f"chunk_{mode}_first_poses": first.numpy(),
                    f"chunk_{mode}_first_particles": rows,
                    f"chunk_{mode}_poses": torch.cat([first, second]).numpy(),
                    f"chunk_{mode}_particles": whole.particles.numpy(),
                    f"chunk_{mode}_log_weights": whole.log_weights.numpy(),
                    f"chunk_{mode}_reads": np.asarray(reads),
                    f"chunk_{mode}_fallbacks": np.asarray(f.fallbacks)})
    f = ShardedParticleFilter(gm, fringe, mesh=mesh, beam_angles=BEAMS)
    s = f.place_state(MCLState.from_numpy(inp["p0"], inp["lw0"], seed=0, device="cpu"))
    fallbacks, poses = [], []
    for k in range(STEPS):
        s, p = f.step(s, inp["actions"][k], inp["scans"][k], u0=inp["draw_u0"][k],
                      noise=inp["draw_noise"][k])
        fallbacks.append(f.fallbacks)
        poses.append(p)
    out.update(steps_fallbacks=np.asarray(fallbacks), steps_poses=torch.stack(poses).numpy(),
               steps_particles=f.gather_state(s).particles.numpy())

    try:
        ShardedParticleFilter(gm, MCLConfig(max_particles=8 * d + 1), mesh=mesh)
        out["divide_error"] = np.asarray("")
    except ValueError as e:
        out["divide_error"] = np.asarray(str(e))

    if d == 4:
        # a fleet over a 2 x 2 fleet x particle mesh on given draws
        from torch.distributed.device_mesh import init_device_mesh

        mesh2d = init_device_mesh("cpu", (2, 2), mesh_dim_names=("fleet", "p"))
        ff = FleetFilter(gm, FLEET, MCLConfig(max_particles=FLEET_N, raycast_method="lut"),
                         beam_angles=BEAMS, mesh=mesh2d, particle_axis="p")
        fs = ff.place_state(FleetState.from_numpy(inp["fleet_p0"], inp["fleet_lw0"], seed=0,
                                                  device="cpu"))
        fposes = []
        with program_calls() as calls:  # gloo particle axis: eager, not a program
            for k in range(STEPS):
                fs, fp = ff.step(fs, np.tile(inp["actions"][k], (FLEET, 1)),
                                 np.tile(inp["scans"][k], (FLEET, 1)), u0=inp["fleet_u0"][k],
                                 noise=inp["fleet_noise"][k])
                fposes.append(fp.numpy())
        out.update(fleet_members=np.asarray(ff.local_members),
                   fleet_columns=np.asarray(ff.local_particles),
                   fleet_particles=fs.particles.numpy(), fleet_poses=np.stack(fposes),
                   fleet_program_calls=np.asarray(len(calls)))
    np.savez(io / f"out{rank}.npz", **out)


# ---------------------------------------------------------------------------
# the JAX side and the runs
# ---------------------------------------------------------------------------


def _jax_resample(particles, logw, d, fringe, u0):
    """JAX's bucketed and all-gather rows of one case under ``shard_map``,
    with the f32 CDF segments they inverted."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P

    from monte_carlo_localization_tpu.ops.resample import (
        distributed_systematic_resample_rows as j_rows,
    )
    from monte_carlo_localization_tpu.ops.resample import systematic_invert_cdf_window as j_inv

    mesh = Mesh(np.array(jax.devices()[:d]), ("p",))
    n = len(particles)

    def local(p, lw, u):
        shard = jax.lax.axis_index("p")
        m = jax.lax.pmax(jnp.max(lw), "p")
        w_local = jnp.exp(lw - m)
        w = w_local / jax.lax.psum(jnp.sum(w_local), "p")
        local_cdf = jnp.cumsum(w)
        totals = jax.lax.all_gather(local_cdf[-1], "p")
        gcl = local_cdf + jnp.where(jnp.arange(d) < shard, totals, 0.0).sum()
        rows_b, overflow = j_rows(p, gcl, u, n, "p", d, fringe)
        all_p = jax.lax.all_gather(p, "p").reshape(n, -1)
        all_cdf = jax.lax.all_gather(gcl, "p").reshape(-1)
        return rows_b, all_p[j_inv(all_cdf, u, n, shard * (n // d), n // d)], overflow, gcl

    f = jax.jit(jax.shard_map(local, mesh=mesh, in_specs=(P("p"), P("p"), P()),
                              out_specs=(P("p"), P("p"), P(), P("p")), check_vma=False))
    rows_b, rows_ref, overflow, gcl = f(jnp.asarray(particles), jnp.asarray(logw),
                                        jnp.float32(u0))
    return np.asarray(rows_b), np.asarray(rows_ref), bool(overflow), np.asarray(gcl)


def _jax_filter(occ, d, actions, scans):
    """JAX's sharded filter from ``init_global(seed=3)``, with each
    correction's draws rebuilt from its key."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from monte_carlo_localization_tpu.config import MCLConfig as JMCLConfig
    from monte_carlo_localization_tpu.mapping import map_from_occupancy as j_map
    from monte_carlo_localization_tpu.parallel import ShardedParticleFilter as JSharded

    spf = JSharded(j_map(occ, **MAP_KW),
                   JMCLConfig(max_particles=N_LOCAL * d, raycast_method="lut_pallas"),
                   mesh=Mesh(np.array(jax.devices()[:d]), ("p",)), beam_angles=BEAMS)
    js = spf.init_global(seed=3)
    ref = dict(p0=np.asarray(js.particles), lw0=np.asarray(js.log_weights))
    u0, noise, poses, quality, rows = [], [], [], [], []
    for k in range(STEPS):
        _, kr, km = jax.random.split(js.key, 3)
        u0.append(float(jax.random.uniform(kr, ())))
        noise.append(np.concatenate([
            np.asarray(jax.random.normal(jax.random.fold_in(km, s), (N_LOCAL, 3), jnp.float32))
            for s in range(d)]))
        js, pose = spf.step(js, actions[k], scans[k])
        poses.append(np.asarray(pose))
        quality.append(spf.log_quality(js))
        rows.append(np.asarray(js.particles))
    with pytest.raises(ValueError) as e:
        JSharded(j_map(occ, **MAP_KW), JMCLConfig(max_particles=8 * d + 1),
                 mesh=Mesh(np.array(jax.devices()[:d]), ("p",)))
    ref.update(draw_u0=np.float32(u0), draw_noise=np.stack(noise), poses=np.stack(poses),
               quality=np.float32(quality), particles=np.stack(rows), divide_error=str(e.value))
    return ref


def _fleet_inputs():
    rng = np.random.default_rng(12)
    p0 = (np.float32([2.4, 2.4, 0.5]) + rng.normal(0, 0.2, (FLEET, FLEET_N, 3))).astype(np.float32)
    return dict(fleet_p0=p0, fleet_lw0=rng.normal(size=(FLEET, FLEET_N)).astype(np.float32),
                fleet_u0=rng.random((STEPS, FLEET)).astype(np.float32),
                fleet_noise=rng.normal(size=(STEPS, FLEET, FLEET_N, 3)).astype(np.float32))


@pytest.fixture(scope="module")
def scenario():
    from tests.conftest import synth_scan

    from monte_carlo_localization_tpu.mapping import map_from_occupancy as j_map

    occ = _occupancy()
    truth = np.float32([2.4, 2.4, 0.5])
    scan = synth_scan(j_map(occ, **MAP_KW), truth, BEAMS)
    rng = np.random.default_rng(4)
    scans = np.stack([scan + rng.normal(0, 0.02, 60).astype(np.float32) for _ in range(STEPS)])
    actions = np.float32([[0.02 * (k + 1), 0.0, 0.01] for k in range(STEPS)])
    return dict(occ=occ, scans=scans, actions=actions)


def _run(d, scenario, tmp):
    jax_ref = _jax_filter(scenario["occ"], d, scenario["actions"], scenario["scans"])
    inp = dict(scenario, u0=np.float32(0.377), p0=jax_ref["p0"], lw0=jax_ref["lw0"],
               draw_u0=jax_ref["draw_u0"], draw_noise=jax_ref["draw_noise"], **_fleet_inputs())
    jax_resample = {}
    for name, (particles, logw, fringe) in _resample_cases(d).items():
        rows_b, rows_ref, overflow, gcl = _jax_resample(particles, logw, d, fringe, 0.377)
        jax_resample[name] = dict(bucketed=rows_b, allgather=rows_ref, overflow=overflow)
        inp.update({f"{name}_particles": particles, f"{name}_cdf": gcl,
                    f"{name}_fringe": np.asarray(fringe)})
    io = tmp / f"d{d}"
    io.mkdir()
    np.savez(io / "in.npz", **inp)
    spawn("tests.test_torch_sharded:_rank_main", d, timeout_s=240.0,
          env={"MCL_TEST_IO": str(io)})
    outs = [dict(np.load(io / f"out{r}.npz")) for r in range(d)]
    return dict(inp=inp, jax=jax_ref, jax_resample=jax_resample, outs=outs, io=io)


@pytest.fixture(scope="module")
def runs(scenario, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded")
    return {d: _run(d, scenario, tmp) for d in (2, 4)}


CASES = ["balanced", "moderate", "extreme", "single"]


@pytest.mark.parametrize("d", [2, 4])
@pytest.mark.parametrize("case", CASES)
def test_distributed_resampler_bitwise_equal_to_jax(runs, d, case):
    out, ref = runs[d]["outs"][0], runs[d]["jax_resample"][case]
    assert bool(out[f"{case}_overflow"]) == ref["overflow"]
    np.testing.assert_array_equal(out[f"{case}_bucketed"], ref["bucketed"])
    np.testing.assert_array_equal(out[f"{case}_allgather"], ref["allgather"])
    if case == "extreme":
        assert ref["overflow"], "all the mass on the last shard must overflow an 8-slot fringe"
    else:
        assert not ref["overflow"]
        np.testing.assert_array_equal(out[f"{case}_bucketed"], out[f"{case}_allgather"])
    if case == "single":
        np.testing.assert_array_equal(out[f"{case}_bucketed"],
                                      np.tile(runs[d]["inp"][f"{case}_particles"][37], (256, 1)))


@pytest.mark.parametrize("d", [2, 4])
def test_bucketed_equals_allgather(runs, d):
    out = runs[d]["outs"][0]
    for what in ("particles", "log_weights", "poses"):
        assert torch.equal(torch.from_numpy(out[f"bucketed_{what}"]),
                           torch.from_numpy(out[f"allgather_{what}"])), what
    assert int(out["bucketed_overflow_reads"]) == 4 and int(out["allgather_overflow_reads"]) == 0


@pytest.mark.parametrize("d", [2, 4])
def test_overflow_fallback_equals_allgather(runs, d):
    out = runs[d]["outs"][0]
    assert int(out["fallback_bucketed_count"]) == 1 and int(out["fallback_allgather_count"]) == 0
    assert torch.equal(torch.from_numpy(out["fallback_bucketed_particles"]),
                       torch.from_numpy(out["fallback_allgather_particles"]))
    assert torch.equal(torch.from_numpy(out["fallback_bucketed_pose"]),
                       torch.from_numpy(out["fallback_allgather_pose"]))


@pytest.mark.parametrize("d", [2, 4])
def test_step_many_equals_steps(runs, d):
    assert all(bool(o["many_equal"]) for o in runs[d]["outs"])


@pytest.mark.parametrize("d", [2, 4])
def test_a_chunk_overflowing_mid_way_equals_allgather_and_steps(runs, d):
    """A one-slot fringe: the first correction stays in its window, a later
    one overflows, and the chunk, run again through the all-gather, is the
    all-gather mode's and the single steps' bit for bit; the next chunk,
    on the generators' own draws, is equal too (both generators were set
    back before the re-run)."""
    out = runs[d]["outs"][0]
    steps = out["steps_fallbacks"]
    assert steps[0] == 0 and steps[-1] >= 1, f"no overflow after the first correction: {steps}"
    for what in ("poses", "particles", "log_weights"):
        assert torch.equal(torch.from_numpy(out[f"chunk_bucketed_{what}"]),
                           torch.from_numpy(out[f"chunk_allgather_{what}"])), what
    assert torch.equal(torch.from_numpy(out["chunk_bucketed_first_poses"]),
                       torch.from_numpy(out["steps_poses"]))
    assert torch.equal(torch.from_numpy(out["chunk_bucketed_first_particles"]),
                       torch.from_numpy(out["steps_particles"]))


@pytest.mark.parametrize("d", [2, 4])
def test_the_overflow_flag_is_read_once_a_chunk(runs, d):
    for out in runs[d]["outs"]:
        assert out["chunk_bucketed_reads"].tolist() == [1, 2]
        assert out["chunk_allgather_reads"].tolist() == [0, 0]
        assert 1 <= int(out["chunk_bucketed_fallbacks"]) <= 2
        assert int(out["chunk_allgather_fallbacks"]) == 0


@pytest.mark.parametrize("d", [2, 4])
def test_a_chunk_tracks_jax_on_its_draws(runs, d):
    """The overflowing chunk on JAX's draws against JAX's sharded filter,
    with the single steps' tolerances."""
    ref, out = runs[d]["jax"], runs[d]["outs"][0]
    np.testing.assert_allclose(out["chunk_bucketed_first_poses"], ref["poses"], rtol=0,
                               atol=1e-3)
    row_ok = np.all(np.abs(out["chunk_bucketed_first_particles"] - ref["particles"][-1]) <= 1e-4,
                    axis=1)
    assert row_ok.mean() >= 0.99, f"{row_ok.mean():.3f} rows equal"


@pytest.mark.parametrize("d", [2, 4])
def test_filter_tracks_jax_on_its_draws(runs, d):
    ref, outs = runs[d]["jax"], runs[d]["outs"]
    for r, out in enumerate(outs):  # every rank holds the global pose
        np.testing.assert_allclose(out["jaxdraws_poses"], ref["poses"], rtol=0, atol=1e-3,
                                   err_msg=f"rank {r}")
        np.testing.assert_allclose(out["jaxdraws_quality"], ref["quality"], rtol=0, atol=1e-3)
    for k in range(STEPS):
        row_ok = np.all(np.abs(outs[0]["jaxdraws_particles"][k] - ref["particles"][k]) <= 1e-4,
                        axis=1)
        assert row_ok.mean() >= 0.99, f"step {k}: {row_ok.mean():.3f} rows equal"
    assert int(outs[0]["jaxdraws_kernel_launches"]) == 0  # CPU tensors: the plain version


@pytest.mark.parametrize("d", [2, 4])
def test_weights_normalized_globally(runs, d):
    from monte_carlo_localization_tpu_torch.filter.core import expected_pose

    out = runs[d]["outs"][0]
    lw = torch.from_numpy(out["final_log_weights"])
    assert lw.shape == (N_LOCAL * d,) and float(lw.max()) == 0.0
    assert abs(float(torch.softmax(lw, 0).sum()) - 1.0) < 1e-5
    pose = expected_pose(torch.from_numpy(out["jaxdraws_particles"][-1]), lw)
    np.testing.assert_allclose(out["final_pose"], pose.numpy(), rtol=0, atol=1e-5)


def test_validation_errors_are_jax_s(runs):
    import jax

    from monte_carlo_localization_tpu.config import MCLConfig as JMCLConfig
    from monte_carlo_localization_tpu.mapping import map_from_occupancy as j_map
    from monte_carlo_localization_tpu.parallel import ShardedParticleFilter as JSharded

    for d in (2, 4):
        msg = str(runs[d]["outs"][0]["divide_error"])
        assert msg == runs[d]["jax"]["divide_error"] and "must divide evenly" in msg
    occ = _occupancy()
    n = 8 * len(jax.devices())
    with pytest.raises(ValueError, match="sharded_resample") as je:
        JSharded(j_map(occ, **MAP_KW), JMCLConfig(max_particles=n, sharded_resample="ring"))
    with pytest.raises(ValueError, match="sharded_resample") as te:
        ShardedParticleFilter(map_from_occupancy(occ, **MAP_KW, device="cpu"),
                              MCLConfig(max_particles=n, sharded_resample="ring"))
    assert str(te.value) == str(je.value)


def test_checkpoint_at_two_shards_resumes_at_one(runs, scenario):
    gm = map_from_occupancy(scenario["occ"], **MAP_KW, device="cpu")
    spf = ShardedParticleFilter(gm, MCLConfig(max_particles=2 * N_LOCAL,
                                              raycast_method="lut_pallas"), beam_angles=BEAMS)
    assert spf.num_devices == 1 and spf.mesh is None
    state, meta = load_state(runs[2]["io"] / "d2.npz", place=spf.place_state, device="cpu")
    out = runs[2]["outs"][0]
    assert meta["iters"] == 4
    assert torch.equal(state.particles, torch.from_numpy(out["bucketed_particles"]))
    assert torch.equal(state.log_weights, torch.from_numpy(out["bucketed_log_weights"]))
    state, pose = spf.step(state, scenario["actions"][0], scenario["scans"][0])
    assert state.particles.shape == (2 * N_LOCAL, 3) and bool(torch.isfinite(pose).all())
    with pytest.raises(ValueError, match="expects 64"):
        spf.place_state(MCLState.from_numpy(np.zeros((10, 3)), np.zeros(10), 0, device="cpu"))


def test_fleet_on_a_fleet_by_particle_mesh_keeps_the_rows(runs, scenario):
    inp = runs[4]["inp"]
    gm = map_from_occupancy(scenario["occ"], **MAP_KW, device="cpu")
    ff = FleetFilter(gm, FLEET, MCLConfig(max_particles=FLEET_N, raycast_method="lut"),
                     beam_angles=BEAMS)
    fs = FleetState.from_numpy(inp["fleet_p0"], inp["fleet_lw0"], seed=0, device="cpu")
    poses = []
    for k in range(STEPS):
        fs, p = ff.step(fs, np.tile(inp["actions"][k], (FLEET, 1)),
                        np.tile(inp["scans"][k], (FLEET, 1)), u0=inp["fleet_u0"][k],
                        noise=inp["fleet_noise"][k])
        poses.append(p.numpy())
    poses = np.stack(poses)
    seen = np.zeros((FLEET, FLEET_N), bool)
    for out in runs[4]["outs"]:
        assert int(out["fleet_program_calls"]) == 0  # a gloo particle axis runs eagerly
        m, c = out["fleet_members"], out["fleet_columns"]
        assert len(m) == 2 and len(c) == FLEET_N // 2
        np.testing.assert_array_equal(out["fleet_particles"], fs.particles.numpy()[m][:, c])
        np.testing.assert_allclose(out["fleet_poses"], poses[:, m], rtol=0, atol=1e-5)
        seen[np.ix_(m, c)] = True
    assert seen.all()
