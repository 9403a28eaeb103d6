"""Resampling from log weights, as in the JAX package's
``ops/resample.py``: indices (``:16-91``), and the proposal rows
themselves, on one filter or distributed over shards (``:94-325``).

Systematic resampling (the default) inverts the weight CDF by the
first-slot rule: with ``g = M*cdf - u0``, output slot s takes the first
source j of ``g[:-1]`` with ``g[j] >= s`` (else N - 1), one binary
search a slot. On a card, rows of float32 log weights that fit a block's
shared memory (:meth:`SystematicKernel.max_row`) go instead to one
hand-written kernel, ``csrc/resample.cu`` (:class:`SystematicKernel`):
the same CDF bits and the same indices, from the softmax on, one block a
row. CPU tensors and longer rows take the PyTorch path, its plain
version. Multinomial
resampling draws N iid categorical samples (the reference's
``std::discrete_distribution``).

The index functions take (N,) log weights, or (F, N) for a fleet: F
independent filters resampled by the same few launches, one offset u0 per
row (the JAX package vmaps the same functions over members). The row
functions serve one filter, or one shard of it
(:func:`distributed_systematic_resample_rows`, whose collectives are
``parallel/collectives.py``'s).
"""

from __future__ import annotations

import ctypes

import torch

from monte_carlo_localization_tpu_torch.utils.timing import COUNTS, Count

_INT32_MAX = 2**31 - 1


def _uniform_u0(log_weights, generator, u0):
    """One offset per row of ``log_weights``: shape () or (F,)."""
    if u0 is not None:
        return torch.as_tensor(u0, dtype=torch.float32, device=log_weights.device)
    return torch.rand(log_weights.shape[:-1], generator=generator, device=log_weights.device)


def multinomial_resample_indices(
    log_weights: torch.Tensor,
    num_samples: int | None = None,
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """N iid draws from Categorical(softmax(log_weights)), per row."""
    n = log_weights.shape[-1] if num_samples is None else num_samples
    w = torch.softmax(log_weights, dim=-1)
    return torch.multinomial(w, n, replacement=True, generator=generator).to(torch.int32)


def systematic_invert_cdf_window(
    cdf: torch.Tensor,
    u0: torch.Tensor,
    num_samples: int,
    slot0: int,
    window: int,
) -> torch.Tensor:
    """Invert a systematic-resampling CDF for output slots
    ``[slot0, slot0 + window)``. Returns int32 ``(window,)`` source indices,
    or ``(F, window)`` for an (F, N) ``cdf`` and (F,) ``u0``.

    With ``g[j] = num_samples*cdf[j] - u0`` (in ``cdf``'s dtype) source j
    owns the output slots ``(g[j-1], g[j]]``, so slot s takes the first j
    of ``g[:-1]`` with ``g[j] >= s``, clamped to N - 1 (an f32 CDF may end
    below 1): one ``searchsorted`` in float64, where every slot index is
    exact, over all F rows at once.
    """
    rows = cdf if cdf.dim() == 2 else cdf[None]
    dev = cdf.device
    g = num_samples * rows - torch.as_tensor(u0, device=dev).reshape(-1, 1)
    slots = torch.arange(slot0, slot0 + window, dtype=torch.float64, device=dev)
    idx = torch.searchsorted(g[:, :-1].double().contiguous(),
                             slots.expand(rows.shape[0], window).contiguous(), side="left")
    out = torch.clamp(idx, max=rows.shape[1] - 1).to(torch.int32)
    return out if cdf.dim() == 2 else out[0]


def prefix_sum_doubling(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum along the last axis by doubling (Hillis-Steele):
    log2(N) elementwise adds in float64, into buffers whose zero head
    stands in for the missing terms, rounded back to ``x.dtype``. Only
    elementwise ops, so the same input gives the same bits on every run
    and every device, and each row of a 2-D ``x`` the bits it gets alone."""
    n = x.shape[-1]
    a = torch.zeros(*x.shape[:-1], 2 * n, dtype=torch.float64, device=x.device)
    b = torch.zeros_like(a)
    a[..., n:] = x
    s = 1
    while s < n:
        torch.add(a[..., n:], a[..., n - s:2 * n - s], out=b[..., n:])
        a, b = b, a
        s *= 2
    return a[..., n:].to(x.dtype)


def weight_cdf(log_weights: torch.Tensor) -> torch.Tensor:
    """The float32 CDF of softmax(log_weights), the same bits on every run
    and device: :func:`prefix_sum_doubling`, since on a card
    ``torch.cumsum`` of floats is not reproducible (its single-pass scan
    adds tile prefixes in whatever order the tiles finish, so two runs of
    one seeded chain could part ways)."""
    return prefix_sum_doubling(torch.softmax(log_weights, dim=-1))


class SystematicKernel:
    """``csrc/resample.cu``: systematic resampling of each row of a
    softmax, one block a row and one launch for all rows, equal to
    ``systematic_invert_cdf_window(prefix_sum_doubling(weights), u0, m, 0,
    m)`` (its CDF bit for bit, then the first j of ``g[:-1]`` with ``g[j]
    >= s`` for slot s). Each launch adds one to ``launch_count``, the count
    named ``resample.kernel``, which a graph's replays advance too."""

    launch_count = Count.attr("_launches")

    def __init__(self):
        self._launches = COUNTS.name("resample.kernel")
        self._max_row: dict[torch.device, int] = {}

    def max_row(self, device: torch.device) -> int:
        """The longest row the kernel takes on the card ``device``: its
        opt-in shared memory a block over 16 B an element, at most 16 x
        1024 (what a block's registers hold), asked once."""
        cap = self._max_row.get(device)
        if cap is None:
            from monte_carlo_localization_tpu_torch.ops._cuda_build import launch

            out = ctypes.c_int(0)
            launch("resample", "mcl_resample_max_row", device, ctypes.byref(out),
                   name="resample max_row", stream=False)
            cap = self._max_row[device] = out.value
        return cap

    def __call__(self, weights: torch.Tensor, u0: torch.Tensor, num_samples: int) -> torch.Tensor:
        """int32 source indices ``weights.shape[:-1] + (num_samples,)`` from
        float32 ``weights`` (a softmax along the last axis) and ``u0``, one
        offset for all rows or one a row; raises on anything else."""
        from monte_carlo_localization_tpu_torch.ops._cuda_build import launch

        dev = weights.device
        n = weights.shape[-1] if weights.dim() else 0
        if dev.type != "cuda" or weights.dtype != torch.float32 or not weights.is_contiguous():
            raise ValueError(f"resample kernel needs contiguous float32 CUDA weights, got "
                             f"{weights.dtype} on {dev}")
        if not 1 <= n <= self.max_row(dev):
            raise ValueError(f"resample kernel takes rows of 1..{self.max_row(dev)}, not {n}")
        if not 0 <= num_samples <= _INT32_MAX:
            raise ValueError(f"num_samples {num_samples} outside 0..{_INT32_MAX}")
        rows = weights.numel() // n
        if not 1 <= rows <= _INT32_MAX:
            raise ValueError(f"resample kernel takes 1..{_INT32_MAX} rows, not {rows}")
        u0 = u0.reshape(-1).contiguous()
        if u0.device != dev or u0.dtype != torch.float32 or u0.numel() not in (1, rows):
            raise ValueError(f"u0 must be float32 on {dev} with 1 or {rows} values, got "
                             f"{tuple(u0.shape)} {u0.dtype} on {u0.device}")
        out = torch.empty(weights.shape[:-1] + (num_samples,), dtype=torch.int32, device=dev)
        launch("resample", "mcl_systematic_resample", dev, weights.data_ptr(), rows, n,
               u0.data_ptr(), int(u0.numel() > 1), num_samples, out.data_ptr(),
               name="resample.kernel")
        return out


SYSTEMATIC_KERNEL = SystematicKernel()


def systematic_resample_indices(
    log_weights: torch.Tensor,
    num_samples: int | None = None,
    generator: torch.Generator | None = None,
    u0: torch.Tensor | float | None = None,
) -> torch.Tensor:
    """Low-variance systematic resampling with one offset u0 ~ U[0, 1)
    per row, drawn from ``generator`` unless given: float32 rows on a card
    that fit :data:`SYSTEMATIC_KERNEL` launch it on their softmax, every
    other input takes the PyTorch path."""
    n = log_weights.shape[-1]
    m = n if num_samples is None else num_samples
    u0 = _uniform_u0(log_weights, generator, u0)
    if (log_weights.is_cuda and log_weights.dtype == torch.float32
            and 0 < n <= SYSTEMATIC_KERNEL.max_row(log_weights.device)):
        return SYSTEMATIC_KERNEL(torch.softmax(log_weights, dim=-1).contiguous(), u0, m)
    return systematic_invert_cdf_window(weight_cdf(log_weights), u0, m, 0, m)


def resample_indices(
    log_weights: torch.Tensor,
    method: str = "systematic",
    num_samples: int | None = None,
    generator: torch.Generator | None = None,
    u0: torch.Tensor | float | None = None,
) -> torch.Tensor:
    """Dispatch on ``method``: "systematic" (optional external ``u0``) or
    "multinomial"."""
    if method == "systematic":
        return systematic_resample_indices(log_weights, num_samples, generator, u0)
    if method == "multinomial":
        if u0 is not None:
            raise ValueError("u0 applies to systematic resampling only")
        return multinomial_resample_indices(log_weights, num_samples, generator)
    raise ValueError(f"Unknown resample method: {method!r}")


def _last_valid_scan(valid: torch.Tensor, rows: torch.Tensor):
    """Forward-fill ``rows`` with the last valid row: JAX's associative
    "last valid wins" scan as a cumulative max of the valid slots'
    indices and one gather. A slot with no valid slot at or before it
    keeps row 0, as the scan does. Returns (any valid so far, filled)."""
    idx = torch.arange(valid.shape[0], device=valid.device)
    last = torch.cummax(torch.where(valid, idx, 0), dim=0).values
    seen = torch.cummax(valid.to(torch.uint8), dim=0).values.bool()
    return seen, rows[last]


def _scatter_rows(target: torch.Tensor, rows: torch.Tensor, length: int):
    """JAX's ``.at[target].set(rows, mode="drop")`` into ``length`` zero
    rows and the matching valid mask: a target outside ``[0, length)``
    writes a spare row past the end, which is dropped."""
    spare = torch.where((target >= 0) & (target < length), target, length).to(torch.int64)
    out = torch.zeros((length + 1,) + rows.shape[1:], dtype=rows.dtype, device=rows.device)
    out[spare] = rows
    valid = torch.zeros(length + 1, dtype=torch.bool, device=rows.device)
    valid.index_fill_(0, spare, True)  # a scalar fill: no host tensor to copy in a graph
    return out[:length], valid[:length]


def systematic_rows_from_cdf(
    cdf: torch.Tensor, u0: torch.Tensor, particles: torch.Tensor, num_samples: int
) -> torch.Tensor:
    """The systematic proposal rows for ``num_samples`` slots of a weight
    CDF (N,) and offset ``u0``, without a gather of ancestor indices (JAX
    ``systematic_resample_rows``, ``ops/resample.py:94-161``).

    With ``g[j] = num_samples*cdf[j] - u0``, in ``cdf``'s dtype, source j
    covers the slots ``[floor(g[j-1]) + 1, floor(g[j])]``. Each covered
    source writes its row into its first slot (one writer a slot), slot 0
    takes the row of its covering source ``j0 = #{j: g[j] < 0}`` (clipped
    to N - 1: an f32 CDF may end below 1, and then no source covers a
    slot at the knife edge), and the last valid row fills the rest."""
    n, m = cdf.shape[0], num_samples
    g = m * cdf - u0
    floors = torch.floor(g).to(torch.int32)
    prev = torch.cat([torch.full((1,), -1, dtype=torch.int32, device=cdf.device), floors[:-1]])
    covered = floors > prev
    rows, valid = _scatter_rows(torch.where(covered, prev + 1, m), particles, m)
    j0 = torch.clamp(torch.sum((g < 0).to(torch.int32)), 0, n - 1)
    rows[0] = particles[j0]
    valid[0].fill_(True)
    return _last_valid_scan(valid, rows)[1]


def systematic_resample_rows(
    log_weights: torch.Tensor,
    particles: torch.Tensor,
    num_samples: int | None = None,
    generator: torch.Generator | None = None,
    u0: torch.Tensor | float | None = None,
) -> torch.Tensor:
    """Systematic resampling that materializes the proposal rows (JAX
    ``systematic_resample_rows``): :func:`systematic_rows_from_cdf` of
    :func:`weight_cdf`, with ``u0`` drawn from ``generator`` unless
    given. Equal to ``particles[systematic_resample_indices(...)]`` on
    the same CDF and u0."""
    m = log_weights.shape[-1] if num_samples is None else num_samples
    u0 = _uniform_u0(log_weights, generator, u0)
    return systematic_rows_from_cdf(weight_cdf(log_weights), u0, particles, m)


def distributed_systematic_resample_rows(
    particles: torch.Tensor,
    global_cdf_local: torch.Tensor,
    u0: torch.Tensor,
    num_total: int,
    comm,
    num_shards: int,
    fringe: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Bucketed distributed systematic resampling of this shard's rows
    (JAX ``distributed_systematic_resample_rows``,
    ``ops/resample.py:172-311``); ``comm`` is the shard axis's
    ``parallel.collectives.Collectives``.

    Shard p owns sources and output slots ``[p*n_local, (p+1)*n_local)``.
    Each shard writes its covered sources' rows into a buffer of its own
    slot window plus a ``fringe`` of C slots on each side; the two
    fringes go to the neighbours by one ``ppermute`` each (O(C) bytes,
    not the O(N) all-gather). Slot ``p*n_local`` takes its covering
    source ``j0_p = #{j: g[j] < p*n_local}``, an exact int64 psum, and
    that source's row by a masked psum. A covered source whose first
    slot falls outside its buffer sets the overflow flag (an exact psum,
    the same on every shard): the caller then takes the all-gather path.
    ``g`` is computed in ``global_cdf_local``'s dtype; the boundary
    ``g[j-1]`` crosses shards by value. Out-of-buffer writes go to a
    spare slot, where JAX's scatter drops them.

    Returns ``(rows (n_local, ...), overflow () bool)``, bitwise equal to
    the all-gather inversion of the same CDF."""
    n_local = particles.shape[0]
    d = num_shards
    c = int(min(max(fringe, 1), n_local))
    shard = comm.axis_index
    dev = particles.device
    trail = (1,) * (particles.dim() - 1)

    g = num_total * global_cdf_local - u0  # this shard's g segment
    perm_up = [(i, i + 1) for i in range(d - 1)]  # data moves p -> p+1
    perm_dn = [(i + 1, i) for i in range(d - 1)]  # data moves p -> p-1
    g_prev_last = comm.ppermute(g[-1:], perm_up)  # shard 0 is overridden below
    prev_floor = torch.floor(torch.cat([g_prev_last, g[:-1]])).to(torch.int32)
    if shard == 0:
        # global source 0's first slot is defined as 0, whatever g is
        prev_floor[0].fill_(-1)
    floors = torch.floor(g).to(torch.int32)
    covered = floors > prev_floor  # covers >= 1 slot; one writer a slot

    buf_len = n_local + 2 * c
    fb = prev_floor.to(torch.int64) + 1 - (shard * n_local - c)  # buffer coordinate
    in_buf = (fb >= 0) & (fb < buf_len)
    overflow_local = torch.any(covered & ~in_buf)
    buf_rows, buf_valid = _scatter_rows(torch.where(covered & in_buf, fb, buf_len),
                                        particles, buf_len)

    # my left fringe belongs to shard p-1's window, my right one to p+1's;
    # a missing neighbour sends zeros (invalid)
    from_left_rows = comm.ppermute(buf_rows[n_local + c:], perm_up)
    from_left_valid = comm.ppermute(buf_valid[n_local + c:], perm_up)
    from_right_rows = comm.ppermute(buf_rows[:c], perm_dn)
    from_right_valid = comm.ppermute(buf_valid[:c], perm_dn)

    rows = buf_rows[c:c + n_local].clone()
    valid = buf_valid[c:c + n_local].clone()
    # one covered writer a slot globally: merging is a select on validity
    rows[:c] = torch.where(from_left_valid.reshape((c,) + trail), from_left_rows, rows[:c])
    valid[:c] |= from_left_valid
    rows[n_local - c:] = torch.where(from_right_valid.reshape((c,) + trail), from_right_rows,
                                     rows[n_local - c:])
    valid[n_local - c:] |= from_right_valid

    boundaries = torch.arange(d, dtype=g.dtype, device=dev) * n_local
    counts_local = torch.sum((g[:, None] < boundaries[None, :]).to(torch.int64), dim=0)
    # one exact int64 psum: the D boundary counts and the overflow flag
    counts = comm.psum(torch.cat([counts_local, overflow_local.to(torch.int64).reshape(1)]))
    j0 = torch.clamp(counts[:d], 0, num_total - 1)  # (D,)
    local_idx = j0 - shard * n_local
    mine = (local_idx >= 0) & (local_idx < n_local)
    contrib = torch.where(mine.reshape((d,) + trail),
                          particles[torch.clamp(local_idx, 0, n_local - 1)],
                          torch.zeros((), dtype=particles.dtype, device=dev))
    seeds = comm.psum(contrib)  # (D, ...) on every shard
    rows[0] = seeds[shard]
    valid[0].fill_(True)

    return _last_valid_scan(valid, rows)[1], counts[d] > 0


def resample_rows(
    log_weights: torch.Tensor,
    particles: torch.Tensor,
    method: str = "systematic",
    num_samples: int | None = None,
    generator: torch.Generator | None = None,
    u0: torch.Tensor | float | None = None,
) -> torch.Tensor:
    """Resampled proposal rows (JAX ``resample_rows``): gather-free for
    the systematic default, ``particles[idx]`` for multinomial."""
    if method == "systematic":
        return systematic_resample_rows(log_weights, particles, num_samples, generator, u0)
    return particles[resample_indices(log_weights, method, num_samples, generator, u0)]
