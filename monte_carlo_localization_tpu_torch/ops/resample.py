"""Resampling indices from log weights, as in the JAX package's
``ops/resample.py:16-91``.

Systematic resampling (the default) inverts the weight CDF scatter-side
in O(N): source j's first output slot is ``floor(M*cdf[j-1] - u0) + 1``;
scatter j there with ``amax`` and forward-fill with a cumulative max.
Multinomial resampling draws N iid categorical samples (the reference's
``std::discrete_distribution``).

Every function takes (N,) log weights, or (F, N) for a fleet: F
independent filters resampled by the same few launches, one offset u0 per
row (the JAX package vmaps the same functions over members).
"""

from __future__ import annotations

import torch


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

    With ``g[j] = num_samples*cdf[j] - u0`` source j owns the output slots
    ``(g[j-1], g[j]]``. Each source is scattered into its first slot with
    ``amax`` (a zero-count source and the covering source may share a
    slot; the covering one has the larger j). Slots outside the window go
    to a spare slot at index ``window`` that is then dropped: JAX's
    ``mode="drop"`` skips them, while ``scatter_reduce_`` would raise.
    Slot 0 is seeded with the source covering ``slot0`` and a cumulative
    max fills the rest. Rows of a fleet scatter into one flat buffer at
    offsets of ``window + 1``, so F rows take the launches of one.
    """
    rows = cdf if cdf.dim() == 2 else cdf[None]
    f, n = rows.shape
    dev = cdf.device
    g = num_samples * rows - torch.as_tensor(u0, device=dev).reshape(-1, 1)
    first_slot = (
        torch.cat(
            [torch.zeros((f, 1), dtype=torch.int32, device=dev),
             torch.floor(g[:, :-1]).to(torch.int32) + 1],
            dim=1,
        )
        - slot0
    )
    inside = (first_slot >= 0) & (first_slot < window)
    target = torch.where(inside, first_slot, window).to(torch.int64)
    if f > 1:
        target = target + (window + 1) * torch.arange(f, device=dev)[:, None]
    src = torch.arange(n, dtype=torch.int32, device=dev).expand(f, n)
    seeded = torch.zeros(f * (window + 1), dtype=torch.int32, device=dev)
    seeded.scatter_reduce_(0, target.reshape(-1), src.reshape(-1), reduce="amax")
    seeded = seeded.view(f, window + 1)[:, :window]
    j0 = torch.sum((g < slot0).to(torch.int32), dim=1)
    seeded[:, 0] = torch.maximum(seeded[:, 0], j0)
    out = torch.clamp(torch.cummax(seeded, dim=1).values, 0, n - 1)
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


def systematic_resample_indices(
    log_weights: torch.Tensor,
    num_samples: int | None = None,
    generator: torch.Generator | None = None,
    u0: torch.Tensor | float | None = None,
) -> torch.Tensor:
    """Low-variance systematic resampling with one offset u0 ~ U[0, 1)
    per row, drawn from ``generator`` unless given."""
    n = log_weights.shape[-1]
    m = n if num_samples is None else num_samples
    cdf = weight_cdf(log_weights)
    return systematic_invert_cdf_window(cdf, _uniform_u0(log_weights, generator, u0), m, 0, m)


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
