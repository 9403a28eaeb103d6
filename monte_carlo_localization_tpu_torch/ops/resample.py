"""Resampling indices from log weights, as in the JAX package's
``ops/resample.py:16-91``.

Systematic resampling (the default) inverts the weight CDF scatter-side
in O(N): source j's first output slot is ``floor(M*cdf[j-1] - u0) + 1``;
scatter j there with ``amax`` and forward-fill with a cumulative max.
Multinomial resampling draws N iid categorical samples (the reference's
``std::discrete_distribution``).
"""

from __future__ import annotations

import torch


def _uniform_u0(log_weights, generator, u0):
    if u0 is not None:
        return torch.as_tensor(u0, dtype=torch.float32, device=log_weights.device)
    return torch.rand((), generator=generator, device=log_weights.device)


def multinomial_resample_indices(
    log_weights: torch.Tensor,
    num_samples: int | None = None,
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """N iid draws from Categorical(softmax(log_weights))."""
    n = log_weights.shape[0] if num_samples is None else num_samples
    w = torch.softmax(log_weights, dim=0)
    return torch.multinomial(w, n, replacement=True, generator=generator).to(torch.int32)


def systematic_invert_cdf_window(
    cdf: torch.Tensor,
    u0: torch.Tensor,
    num_samples: int,
    slot0: int,
    window: int,
) -> torch.Tensor:
    """Invert a systematic-resampling CDF for output slots
    ``[slot0, slot0 + window)``. Returns int32 ``(window,)`` source indices.

    With ``g[j] = num_samples*cdf[j] - u0`` source j owns the output slots
    ``(g[j-1], g[j]]``. Each source is scattered into its first slot with
    ``amax`` (a zero-count source and the covering source may share a
    slot; the covering one has the larger j). Slots outside the window go
    to a spare slot at index ``window`` that is then dropped: JAX's
    ``mode="drop"`` skips them, while ``scatter_reduce_`` would raise.
    Slot 0 is seeded with the source covering ``slot0`` and a cumulative
    max fills the rest.
    """
    n = cdf.shape[0]
    g = num_samples * cdf - u0
    first_slot = (
        torch.cat(
            [torch.zeros(1, dtype=torch.int32, device=cdf.device),
             torch.floor(g[:-1]).to(torch.int32) + 1]
        )
        - slot0
    )
    inside = (first_slot >= 0) & (first_slot < window)
    target = torch.where(inside, first_slot, window).to(torch.int64)
    src = torch.arange(n, dtype=torch.int32, device=cdf.device)
    seeded = torch.zeros(window + 1, dtype=torch.int32, device=cdf.device)
    seeded.scatter_reduce_(0, target, src, reduce="amax")
    seeded = seeded[:window]
    j0 = torch.sum((g < slot0).to(torch.int32))
    seeded[0] = torch.maximum(seeded[0], j0)
    return torch.clamp(torch.cummax(seeded, dim=0).values, 0, n - 1)


def systematic_resample_indices(
    log_weights: torch.Tensor,
    num_samples: int | None = None,
    generator: torch.Generator | None = None,
    u0: torch.Tensor | float | None = None,
) -> torch.Tensor:
    """Low-variance systematic resampling with one offset u0 ~ U[0, 1),
    drawn from ``generator`` unless given."""
    n = log_weights.shape[0]
    m = n if num_samples is None else num_samples
    cdf = torch.cumsum(torch.softmax(log_weights, dim=0), dim=0)
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
