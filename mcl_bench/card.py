"""The yardstick's fixed pieces: the card's identity, the published peaks
and the least-time arithmetic of the likelihood kernel, frozen here so a
later change to the program cannot move them.

Copied from ``chip_smoke.py`` (``bound``, ``lut_bound`` and the peaks,
commit 2f0b362) and ``monte_carlo_localization_tpu_torch/bench.py``
(``_card``, ``_launches``, commit 2f0b362).
"""

from __future__ import annotations

import subprocess

# NVIDIA's data sheet, H100 SXM at its full 700 W: HBM bytes/s and the
# dense float32 and float64 rates outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
F64_OPS_PER_S = 34e12
# float32 operations of one tabled beam term and of one particle's
# address math, counted from the kernel's source (csrc/beam_model.cuh at
# 2f0b362): the entry's conversion and clip, its table index, the hit
# term, the short term, the max and rand terms, fmax, log, subtract; two
# subtractions, two divisions, casts, compares, rint and fix-ups
OPS_PER_BEAM_TABLED = 23
OPS_PER_PARTICLE_K1 = 12


def card(index: int = 0) -> dict:
    """The card's name (as torch names it) and power limit in watts
    (``nvidia-smi``; None where it cannot be read)."""
    import torch

    limit = None
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={index}", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.strip()
        limit = float(out)
    except (OSError, subprocess.SubprocessError, ValueError):
        pass
    return dict(kind=torch.cuda.get_device_name(index), count=torch.cuda.device_count(),
                power_limit_w=limit)


def bound(bytes_moved: float, f32_ops: float, f64_ops: float) -> dict:
    """Least time on an H100 SXM: the larger of bytes over HBM bandwidth
    and operations over the peak rates of their types."""
    mem = bytes_moved / HBM_BYTES_PER_S * 1e3
    ops = (f32_ops / F32_OPS_PER_S + f64_ops / F64_OPS_PER_S) * 1e3
    return dict(bound_ms=max(mem, ops), bound_by="bytes" if mem >= ops else "operations",
                bytes=bytes_moved, f32_ops=f32_ops, f64_ops=f64_ops)


def lut_bound(n: int, n_on: int, r: int, itemsize: int, row_map: bool) -> dict:
    """One launch of the likelihood kernel (tabled normaliser, no sub-bin
    lerp): particles in (12 B) and log weights out (4 B) for all n, the
    scan and beam offsets, one LUT window of r entries and (compact LUT)
    one row-map entry for each of the n_on particles on the map, each
    byte counted once; r beam terms of each on-map particle, summed in
    double."""
    entries = n_on * r
    other = 12 * n + 4 * n + 8 * r + n_on * (4 if row_map else 0)
    f32 = n * OPS_PER_PARTICLE_K1 + n_on * r * OPS_PER_BEAM_TABLED
    return bound(other + entries * itemsize, f32, n_on * r)


def lut_launches(filt) -> int:
    """The likelihood kernel's launches that the wrapper of ``filt`` has
    counted (0 without the wrapper)."""
    q = filt.likelihood
    return 0 if q is None else q.launch_count
