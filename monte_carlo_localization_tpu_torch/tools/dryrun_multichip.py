"""The port's multi-process dry run, the twin of the JAX package's
``__graft_entry__.py`` ``dryrun_multichip``: N OS processes on the CPU,
joined over gloo, drive every mesh path once at tiny shapes:

1. a fleet over a 2-D fleet x particle mesh (the ``lut`` method);
2. the sharded filter over all N processes;
3. the sharded filter with the LUT likelihood per shard (``lut_pallas``;
   its plain version on the CPU);
4. a fleet over a 1-D fleet mesh with the LUT likelihood per process;
5. the bucketed resampler's fringe overflow: all the mass on the last
   shard with a one-slot fringe must trip the overflow flag, and the
   all-gather fallback must give the rows and pose of the ``allgather``
   filter bit for bit.

Run from the root of a checkout:

    python -m monte_carlo_localization_tpu_torch.tools.dryrun_multichip 4
"""

from __future__ import annotations

import dataclasses
import sys

import numpy as np
import torch
import torch.distributed as dist

from monte_carlo_localization_tpu_torch.parallel.multihost import spawn


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"dryrun_multichip: {msg}")


def _child() -> None:
    from torch.distributed.device_mesh import init_device_mesh

    from monte_carlo_localization_tpu_torch.config import MCLConfig
    from monte_carlo_localization_tpu_torch.mapping import random_obstacle_world
    from monte_carlo_localization_tpu_torch.parallel import FleetFilter, ShardedParticleFilter
    from monte_carlo_localization_tpu_torch.parallel.collectives import world_mesh

    n = dist.get_world_size()
    gm = random_obstacle_world(height=160, width=160, num_obstacles=10, seed=0, device="cpu")
    beams = np.linspace(-2.0, 2.0, 16).astype(np.float32)
    scan = np.full((16,), 3.0, np.float32)

    # 1: fleet x particle 2-D mesh
    f_ax = 2 if n % 2 == 0 and n >= 2 else 1
    p_ax = n // f_ax
    mesh2d = init_device_mesh("cpu", (f_ax, p_ax), mesh_dim_names=("fleet", "p"))
    fleet_size = max(f_ax, 2)
    ff = FleetFilter(gm, fleet_size, MCLConfig(max_particles=16 * p_ax, raycast_method="lut"),
                     beam_angles=beams, mesh=mesh2d, fleet_axis="fleet", particle_axis="p")
    state = ff.init_global(seed=0)
    state, poses = ff.step(state, np.zeros((fleet_size, 3), np.float32),
                           np.tile(scan, (fleet_size, 1)))
    _check(bool(torch.isfinite(poses).all()), f"2-D fleet poses {poses}")

    # 2: the sharded filter over every process
    mesh1d = world_mesh("p")
    spf = ShardedParticleFilter(gm, MCLConfig(max_particles=32 * n, raycast_method="lut"),
                                mesh=mesh1d, beam_angles=beams)
    s, pose = spf.step(spf.init_global(seed=1), np.zeros(3), scan)
    _check(bool(torch.isfinite(pose).all()), f"sharded pose {pose}")

    # 3: the LUT likelihood per shard
    spf_k = ShardedParticleFilter(gm, MCLConfig(max_particles=8 * n, raycast_method="lut_pallas"),
                                  mesh=mesh1d, beam_angles=beams)
    s, pose = spf_k.step(spf_k.init_global(seed=2), np.zeros(3), scan)
    _check(spf_k.likelihood is not None and bool(torch.isfinite(pose).all()),
           f"sharded lut_pallas pose {pose}")

    # 4: a fleet over a 1-D fleet mesh with the LUT likelihood per process
    ff_k = FleetFilter(gm, 2 * n, MCLConfig(max_particles=32, raycast_method="lut_pallas"),
                       beam_angles=beams, mesh=world_mesh("fleet"))
    fs, fposes = ff_k.step(ff_k.init_global(seed=3), np.zeros((2 * n, 3), np.float32),
                           np.tile(scan, (2 * n, 1)))
    _check(fposes.shape == (2, 3) and bool(torch.isfinite(fposes).all()),
           f"meshed fleet poses {fposes}")

    # 5: fringe overflow -> the all-gather fallback, bit for bit
    n_total = 32 * n
    out = {}
    for mode, fringe in (("bucketed", 1), ("allgather", 0)):
        spf_f = ShardedParticleFilter(
            gm, MCLConfig(max_particles=n_total, raycast_method="lut", sharded_resample=mode,
                          sharded_fringe=fringe),
            mesh=mesh1d, beam_angles=beams,
        )
        st = spf_f.init_global(seed=4)
        lw = torch.full((n_total,), -80.0)
        lw[n_total - n_total // n:] = 0.0  # all the mass on the last shard
        st = spf_f.place_state(dataclasses.replace(spf_f.gather_state(st), log_weights=lw))
        st, fb_pose = spf_f.step(st, np.zeros(3), scan, u0=0.5)
        out[mode] = (st.particles, fb_pose, spf_f.fallbacks)
    if n > 1:
        _check(out["bucketed"][2] == 1, "the one-slot fringe did not trip the overflow flag")
    _check(torch.equal(out["bucketed"][0], out["allgather"][0])
           and torch.equal(out["bucketed"][1], out["allgather"][1]),
           "fringe-overflow fallback diverged from the all-gather filter")
    if dist.get_rank() == 0:
        print(f"dryrun_multichip({n}) OK: fleet mesh {f_ax} x {p_ax}, sharded mesh {n}, "
              "lut_pallas per shard (sharded + meshed fleet), fringe-overflow all-gather "
              "fallback bitwise", flush=True)


def dryrun_multichip(num_processes: int, timeout_s: float = 300.0) -> str:
    """Run the five modes over ``num_processes`` gloo processes on the CPU;
    returns rank 0's output, raises on any failure."""
    from monte_carlo_localization_tpu_torch import native

    native.available()  # build the native library once, before the processes
    return spawn("monte_carlo_localization_tpu_torch.tools.dryrun_multichip:_child",
                 num_processes, timeout_s)[0]


if __name__ == "__main__":
    print(dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 2), end="")
