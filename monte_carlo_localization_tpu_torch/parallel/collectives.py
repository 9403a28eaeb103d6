"""The collectives of one mesh axis, over ``torch.distributed``: the
handful that the JAX package's ``shard_map`` code calls (``psum``,
``pmax``, ``all_gather``, ``ppermute``, ``axis_index``).

One process is one shard. A :class:`Collectives` wraps the process group
of one axis of a ``DeviceMesh`` (``mesh.get_group(axis)``); without a
group it is a one-shard world whose collectives are identities, as JAX's
one-device mesh is (the tensors stay on their device). A group of one
process still makes its calls.

NCCL takes the card's tensors. Gloo, which this repository uses wherever
several processes share one card (NCCL refuses two ranks of one
communicator on the same GPU), is given host tensors: every gloo call
copies a card tensor to the host first and its result back after, chosen
by the group's backend and nothing else. Those copies wait for the card,
so each one is a host synchronization; ``host_copies`` counts them. A
host copy cannot be captured in a CUDA graph: a filter whose step calls
the collectives of a group that stages on the host
(:attr:`Collectives.stages_on_host`) runs that step eagerly, and one over
a one-shard world or an NCCL group runs it as a graph
(``utils/graphs.py``). The NCCL calls add no host value and no
host-side allocation per rank, so that a graph can hold them.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from monte_carlo_localization_tpu_torch.utils.timing import COUNTS, Count


def shard_seed(seed: int, shard: int) -> int:
    """A seed for shard ``shard``'s own stream of ``seed`` (JAX
    ``fold_in(key, shard)``)."""
    return int(np.random.SeedSequence([int(seed), int(shard)]).generate_state(1, np.uint64)[0])


def world_mesh(axis: str):
    """A 1-D ``DeviceMesh`` named ``axis`` over every process of the
    initialized ``torch.distributed`` world, in rank order (process-major,
    one shard a process), or None when it is not initialized: a one-shard
    world, as JAX's mesh of one device."""
    if not (dist.is_available() and dist.is_initialized()):
        return None
    from torch.distributed.device_mesh import init_device_mesh

    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (dist.get_world_size(),), mesh_dim_names=(axis,))


class Collectives:
    """The collectives of one process group (or of a one-shard world when
    ``group`` is None), with counts of the calls made and the bytes this
    rank handed to them (``utils/timing.py`` :class:`Count` objects, which
    a graph's replays advance)."""

    calls = Count.attr("_calls")  # collective calls made by this rank
    bytes = Count.attr("_bytes")  # bytes this rank contributed to them

    def __init__(self, group=None):
        self.group = group
        if group is None:
            self.size, self.axis_index, self.backend = 1, 0, None
        else:
            self.size = dist.get_world_size(group)
            self.axis_index = dist.get_rank(group)
            self.backend = dist.get_backend(group)
        self._calls, self._bytes = Count(), Count()
        self.host_copies = 0  # card -> host copies of the gloo staging

    @classmethod
    def of_mesh(cls, mesh, axis: str) -> "Collectives":
        """The collectives of ``mesh``'s axis ``axis``; a one-shard world
        for ``mesh=None``."""
        return cls(None if mesh is None else mesh.get_group(axis))

    @property
    def stages_on_host(self) -> bool:
        """True where every call copies through the host (gloo): a step
        that calls these collectives then runs eagerly, never as a graph."""
        return self.backend == "gloo"

    def reset_counts(self) -> None:
        self.calls = self.bytes = self.host_copies = 0

    def _count(self, x: torch.Tensor) -> None:
        COUNTS.add(self._calls)
        COUNTS.add(self._bytes, x.numel() * x.element_size())

    def _stage(self, x: torch.Tensor) -> torch.Tensor:
        """The tensor handed to the backend: a host copy under gloo."""
        if self.stages_on_host and x.device.type != "cpu":
            self.host_copies += 1
            return x.cpu()
        return x.contiguous()

    def _global(self, rank: int) -> int:
        return dist.get_global_rank(self.group, rank)

    def _all_reduce(self, x: torch.Tensor, op) -> torch.Tensor:
        if self.group is None:
            return x
        self._count(x)
        buf = self._stage(x).clone()
        dist.all_reduce(buf, op=op, group=self.group)
        return buf.to(x.device)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over the axis, the same bits on every rank (integer
        counts are passed in int64 and stay exact)."""
        return self._all_reduce(x, dist.ReduceOp.SUM)

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        return self._all_reduce(x, dist.ReduceOp.MAX)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x`` concatenated along dim 0 in rank order (a
        0-d ``x`` gives a (D,) tensor)."""
        flat = x.reshape(1) if x.dim() == 0 else x
        if self.group is None:
            return flat
        self._count(flat)
        buf = self._stage(flat)
        if self.stages_on_host:
            parts = [torch.empty_like(buf) for _ in range(self.size)]
            dist.all_gather(parts, buf, group=self.group)
            return torch.cat(parts).to(x.device)
        # one output tensor, as a graph can hold: the bits of the list form
        out = buf.new_empty((self.size * buf.shape[0], *buf.shape[1:]))
        dist.all_gather_into_tensor(out, buf, group=self.group)
        return out

    def ppermute(self, x: torch.Tensor, pairs) -> torch.Tensor:
        """``x`` sent along ``pairs`` of (source, destination) ranks of the
        axis; a rank that no pair sends to receives zeros, as JAX's
        ``ppermute`` gives. Bool tensors travel as uint8."""
        src_of = {dst: src for src, dst in pairs}
        dst_of = {src: dst for src, dst in pairs}
        me = self.axis_index
        wire = x.to(torch.uint8) if x.dtype == torch.bool else x
        if me not in src_of and me not in dst_of:
            return torch.zeros_like(x)
        ops = []
        if me in dst_of:
            self._count(wire)
            ops.append(dist.P2POp(dist.isend, self._stage(wire), self._global(dst_of[me]),
                                  self.group))
        recv = None
        if me in src_of:
            recv = torch.zeros_like(wire, device="cpu" if self.stages_on_host else x.device)
            ops.append(dist.P2POp(dist.irecv, recv, self._global(src_of[me]), self.group))
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        if recv is None:
            return torch.zeros_like(x)
        return recv.to(device=x.device, dtype=x.dtype)
