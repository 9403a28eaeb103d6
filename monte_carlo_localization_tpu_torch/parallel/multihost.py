"""Multi-process fleet scale-out over ``torch.distributed``, as the JAX
package's ``parallel/multihost.py`` does over ``jax.distributed``.

* Fleet members are independent filters, so the fleet axis is the only
  axis that crosses processes and a correction needs no collective: each
  process holds ``F / P`` members' particles, their scans and the whole
  map LUT. The mesh is 1-D, ``("fleet",)``, over every process in rank
  order (process-major), so a member's state never leaves its process.
* Processes exchange only small summaries: the (F, 3) pose table by
  :meth:`MultiHostFleet.gather_poses`, at the consumer's rate.
* A single giant filter (``parallel/sharded.py``) is sharded over
  processes too, but its per-correction collectives are latency-bound
  across hosts: scale particles within a host, fleets across hosts.

``init_multihost`` joins a process group over TCP; its backend is
``gloo`` unless asked otherwise. NCCL needs one card per process (it
refuses two ranks of one communicator on the same GPU); several processes
that share one card run over gloo, which ``parallel/collectives.py``
hands host copies.

``python -m monte_carlo_localization_tpu_torch.parallel.multihost
--dryrun N`` spawns N OS processes on the CPU joined by gloo, each
owning fleet members: the collective-free fleet step and the pose-table
gather run under the real multi-process runtime. :func:`spawn` is the
launcher that it, ``tools/dryrun_multichip.py`` and the tests share.
"""

from __future__ import annotations

import importlib
import os
import socket
import subprocess
import sys
import tempfile
import time
from datetime import timedelta
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from monte_carlo_localization_tpu_torch.parallel.collectives import Collectives, world_mesh
from monte_carlo_localization_tpu_torch.parallel.fleet import FleetFilter
from monte_carlo_localization_tpu_torch.utils.device import upload

__all__ = [
    "init_multihost",
    "multihost_mesh",
    "MultiHostFleet",
    "run_dryrun",
    "spawn",
]

_REPO = Path(__file__).resolve().parents[2]
# rendezvous and collective timeout: generous for a loaded machine, where
# processes reach their first collective tens of seconds apart
_TIMEOUT_S = 600.0


def init_multihost(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    backend: str = "gloo",
) -> None:
    """Join the process group (idempotent): ``coordinator_address`` is
    rank 0's ``host:port``, reached over TCP. A no-op for a single
    process (no address, no count): the mesh is then a one-process world
    and the API stays the same."""
    if dist.is_initialized():
        return
    if coordinator_address is None and num_processes is None:
        return
    dist.init_process_group(
        backend,
        init_method=f"tcp://{coordinator_address}",
        world_size=int(num_processes),
        rank=int(process_id),
        timeout=timedelta(seconds=_TIMEOUT_S),
    )


def multihost_mesh(fleet_axis: str = "fleet"):
    """A 1-D ``DeviceMesh`` over every process, process-major: a
    block-split fleet axis then gives each process a contiguous run of
    members. None for a single process outside a process group."""
    return world_mesh(fleet_axis)


class MultiHostFleet:
    """A :class:`~monte_carlo_localization_tpu_torch.parallel.fleet.FleetFilter`
    over every process: the fleet step itself is the fleet's, on this
    process's members; this class owns the multi-process concerns:

    * the process-major mesh (:func:`multihost_mesh`),
    * which members this process owns (:attr:`local_members`),
    * feeding this process's own scans and actions (:meth:`scatter_local`),
    * the pose-table gather (:meth:`gather_poses`).

    ``fleet_kwargs`` go to ``FleetFilter`` (``map_assignment``,
    ``device``)."""

    def __init__(self, grid_map, fleet_size, config=None, beam_angles=None, **fleet_kwargs):
        self.mesh = multihost_mesh()
        processes = Collectives.of_mesh(self.mesh, "fleet").size
        if fleet_size % processes:
            raise ValueError(f"fleet_size={fleet_size} must divide over {processes} processes")
        self.fleet = FleetFilter(grid_map, fleet_size=fleet_size, config=config,
                                 beam_angles=beam_angles, mesh=self.mesh, **fleet_kwargs)
        self.comm = self.fleet._fleet_comm
        self.fleet_size = fleet_size
        self.process_index = self.comm.axis_index
        self.process_count = self.comm.size
        self.local_members = self.fleet.local_members

    def init_pose(self, poses, seed=0):
        return self.fleet.init_pose(poses, seed=seed)

    def init_global(self, seed=0):
        return self.fleet.init_global(seed=seed)

    def set_beam_angles(self, beam_angles):
        self.fleet.set_beam_angles(beam_angles)

    def scatter_local(self, local_rows) -> torch.Tensor:
        """This process's members' rows (scans or actions, ``(F / P, ...)``),
        uploaded to its device. No process sees another's rows: each
        ingests its own robots' sensors."""
        rows = upload(np.ascontiguousarray(local_rows), self.fleet.device)
        if rows.shape[0] != len(self.local_members):
            raise ValueError(
                f"{rows.shape[0]} local rows for {len(self.local_members)} local members"
            )
        return rows

    def step(self, state, actions, scans, u0=None, noise=None):
        """One correction of this process's members; ``actions`` and
        ``scans`` are its rows (:meth:`scatter_local`) or the whole
        fleet's table. Returns (state, this process's poses (F / P, 3))."""
        return self.fleet.step(state, actions, scans, u0=u0, noise=noise)

    def gather_poses(self, poses) -> np.ndarray:
        """The (F, 3) pose table on every process: the one collective of
        the design (kilobytes, at the consumer's rate)."""
        table = self.comm.all_gather(torch.as_tensor(poses))
        return table.cpu().numpy().reshape(self.fleet_size, -1)


# ---------------------------------------------------------------------------
# spawn: N OS processes joined by init_multihost
# ---------------------------------------------------------------------------


def _free_port() -> int:
    """A port no socket holds now; any process may take it before its
    caller binds it, so only a caller that binds it at once may use it."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(target: str, num_processes: int, timeout_s: float = 300.0,
          env: dict | None = None, backend: str = "gloo") -> list[str]:
    """Run ``target`` (``"module:function"``, called with no arguments) in
    ``num_processes`` OS processes joined by :func:`init_multihost` over
    ``tcp://127.0.0.1:<port>`` (``backend`` gloo: the processes may share
    a card; NCCL needs a card a process), from the root of this checkout.
    Returns each process's output (stdout and stderr);
    raises with the tail of every process that failed or outlived
    ``timeout_s``. Once one fails, the rest are given 10 s and stopped.

    The rendezvous store listens in this process, on a port the system
    picks as it binds it, and the processes join it as clients (torch's
    ``TORCHELASTIC_USE_AGENT_STORE``, the elastic agent's convention). A
    port probed free and closed here, for rank 0 to bind seconds later,
    could be taken meanwhile by any other process's bind or connect."""
    store = dist.TCPStore("127.0.0.1", 0, None, True, timedelta(seconds=_TIMEOUT_S),
                          wait_for_workers=False)
    base = dict(os.environ, **(env or {}), MCL_MH_COORD=f"127.0.0.1:{store.port}",
                MCL_MH_NPROC=str(num_processes), MCL_MH_BACKEND=backend,
                TORCHELASTIC_USE_AGENT_STORE="True")
    with tempfile.TemporaryDirectory(prefix="mcl_spawn_") as tmp:
        logs = [Path(tmp) / f"rank{pid}.log" for pid in range(num_processes)]
        procs = []
        for pid, log in enumerate(logs):
            with open(log, "w") as out:
                procs.append(subprocess.Popen(
                    [sys.executable, "-c", _CHILD, target],
                    env=dict(base, MCL_MH_PID=str(pid)), cwd=_REPO,
                    stdout=out, stderr=subprocess.STDOUT,
                ))
        deadline, why = time.monotonic() + timeout_s, {}
        try:
            while any(p.poll() is None for p in procs):
                if time.monotonic() > deadline:
                    why.update({i: "timeout" for i, p in enumerate(procs) if p.poll() is None})
                    break
                if any(p.returncode not in (None, 0) for p in procs):
                    deadline = min(deadline, time.monotonic() + 10.0)
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        outs = [log.read_text() for log in logs]
    del store  # every process has ended: stop listening
    why.update({i: f"rc={p.returncode}" for i, p in enumerate(procs)
                if p.returncode != 0 and i not in why})
    if why:
        detail = "\n".join(f"--- process {i} ({w}) ---\n{outs[i][-3000:]}"
                           for i, w in sorted(why.items()))
        raise RuntimeError(f"{target} over {num_processes} processes failed:\n{detail}")
    return outs


_CHILD = ("import sys; from monte_carlo_localization_tpu_torch.parallel.multihost import _child; "
          "sys.exit(_child(sys.argv[1]))")


def _child(target: str) -> int:
    """One spawned process: join the group, run ``target``, leave."""
    torch.set_num_threads(1)
    init_multihost(os.environ["MCL_MH_COORD"], int(os.environ["MCL_MH_NPROC"]),
                   int(os.environ["MCL_MH_PID"]), backend=os.environ["MCL_MH_BACKEND"])
    module, fn = target.split(":")
    try:
        getattr(importlib.import_module(module), fn)()
    finally:
        dist.destroy_process_group()
    return 0


# ---------------------------------------------------------------------------
# dryrun: the multi-process fleet on the CPU
# ---------------------------------------------------------------------------


def _dryrun_child() -> None:
    """One process: owns two fleet members, feeds only their scans, steps
    them on the LUT likelihood (its plain version on the CPU) and checks
    the gathered pose table."""
    from monte_carlo_localization_tpu_torch.config import MCLConfig
    from monte_carlo_localization_tpu_torch.mapping import box_world
    from monte_carlo_localization_tpu_torch.ops.raycast import cast_rays_sphere

    gm = box_world(height=120, width=160, device="cpu")
    beams = np.linspace(-np.pi / 2, np.pi / 2, 12, dtype=np.float32)
    nproc, pid = dist.get_world_size(), dist.get_rank()
    members_per_host = 2
    fleet_size = members_per_host * nproc
    mh = MultiHostFleet(
        gm, fleet_size=fleet_size,
        config=MCLConfig(max_particles=32, raycast_method="lut_pallas", lut_theta_bins=180),
        beam_angles=beams,
    )
    # every member at its own pose, off multiples of the 0.05 m cells;
    # each process casts scans for its own members only
    truths = np.stack([np.array([3.013 + 0.15 * m, 2.517 + 0.1 * m, 0.1 * m], np.float32)
                       for m in range(fleet_size)])
    local_scans = []
    for m in mh.local_members:
        p = truths[m]
        q = np.stack([np.full(len(beams), p[0]), np.full(len(beams), p[1]), p[2] + beams],
                     1).astype(np.float32)
        local_scans.append(cast_rays_sphere(gm, torch.from_numpy(q)).numpy())
    scans = mh.scatter_local(np.stack(local_scans))
    actions = mh.scatter_local(np.zeros((members_per_host, 3), np.float32))
    state = mh.init_pose(truths, seed=4)
    for _ in range(3):
        state, poses = mh.step(state, actions, scans)
    table = mh.gather_poses(poses)
    if table.shape != (fleet_size, 3) or not np.isfinite(table).all():
        raise RuntimeError(f"pose table {table.shape}: {table}")
    err = np.linalg.norm(table[:, :2] - truths[:, :2], axis=1)
    if err.max() >= 0.5:
        raise RuntimeError(f"fleet diverged across processes: {err}")
    print(f"process {pid}/{nproc}: pose table ok, max err {err.max():.3f} m", flush=True)


def run_dryrun(num_processes: int = 2, timeout_s: float = 300.0) -> None:
    """Spawn ``num_processes`` processes joined over gloo and run the
    multi-process fleet step and pose gather on the CPU. Raises on any
    failure."""
    from monte_carlo_localization_tpu_torch import native

    native.available()  # build the native library once, before the processes
    outs = spawn("monte_carlo_localization_tpu_torch.parallel.multihost:_dryrun_child",
                 num_processes, timeout_s)
    print("".join(outs), end="")
    print(f"MULTIHOST DRYRUN OK ({num_processes} processes)")


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--dryrun", type=int, default=2, metavar="N",
                    help="number of processes to spawn")
    run_dryrun(ap.parse_args().dryrun)
