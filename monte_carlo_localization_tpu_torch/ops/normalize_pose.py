"""The normalization and pose of a correction on a card:
``csrc/normalize_pose.cu``, the max-shifted log weights, the log quality
and the weighted-mean pose of every row in one launch: one block a row,
a thread-block cluster a row past 4096 particles.

:data:`NORMALIZE_POSE_KERNEL` reads the counts named
``normalize_pose.kernel``, its launches (``launch_count``), and
``normalize_pose.plain``, the calls off a card, which take the plain
PyTorch version in ``filter/core.py`` ``normalize_pose``
(``plain_launch_count``); ``TRACER.summary()`` shows both, and a graph's
replays advance both.
"""

from __future__ import annotations

import torch

from monte_carlo_localization_tpu_torch.utils.timing import COUNTS, Count


class NormalizePoseKernel:
    """``csrc/normalize_pose.cu``: for log likelihoods (..., N) over
    particles (..., N, 3), (shifted, log_quality, pose) with ``shifted``
    bit for bit the plain ``log_w - amax(log_w)`` and ``log_quality``
    (...) and ``pose`` (..., 3) from float64 sums, rounded once. Each
    launch adds one to ``launch_count``; ``plain_launch_count`` counts
    the calls off a card, which take the plain version."""

    launch_count = Count.attr("_launches")
    plain_launch_count = Count.attr("_plain")

    def __init__(self):
        self._launches = COUNTS.name("normalize_pose.kernel")
        self._plain = COUNTS.name("normalize_pose.plain")
        self._ready: set[torch.device] = set()

    def __call__(self, particles: torch.Tensor, log_weights: torch.Tensor):
        """(shifted (..., N), log_quality (...), pose (..., 3)), float32,
        from contiguous float32 ``log_weights`` (..., N) and ``particles``
        (..., N, 3) on one card. Raises ``ValueError`` on anything else,
        before any launch."""
        lead = tuple(log_weights.shape[:-1])
        n = log_weights.shape[-1] if log_weights.dim() else 0
        if tuple(particles.shape) != lead + (n, 3) or n == 0:
            raise ValueError(f"normalize_pose kernel takes (..., N) log weights and (..., N, 3) "
                             f"particles, got {tuple(log_weights.shape)} and "
                             f"{tuple(particles.shape)}")
        if log_weights.dtype != torch.float32 or particles.dtype != torch.float32:
            raise ValueError(f"normalize_pose kernel needs float32 log weights and particles, "
                             f"got {log_weights.dtype} and {particles.dtype}")
        if not (log_weights.is_contiguous() and particles.is_contiguous()):
            raise ValueError("normalize_pose kernel needs contiguous log weights and particles")
        dev = log_weights.device
        if dev.type != "cuda" or particles.device != dev:
            raise ValueError(f"normalize_pose kernel needs both inputs on one CUDA device, got "
                             f"{dev} and {particles.device}")
        from monte_carlo_localization_tpu_torch.ops._cuda_build import launch

        if dev not in self._ready:  # the kernel's opt-in shared memory, once a device
            launch("normalize_pose", "mcl_normalize_pose_setup", dev,
                   name="normalize_pose setup", stream=False)
            self._ready.add(dev)
        shifted = torch.empty_like(log_weights)
        log_quality = torch.empty(lead, dtype=torch.float32, device=dev)
        pose = torch.empty(lead + (3,), dtype=torch.float32, device=dev)
        launch("normalize_pose", "mcl_normalize_pose", dev, log_weights.data_ptr(),
               particles.data_ptr(), log_weights.numel() // n, n, shifted.data_ptr(), log_quality.data_ptr(), pose.data_ptr(),
               name="normalize_pose.kernel")
        return shifted, log_quality, pose


NORMALIZE_POSE_KERNEL = NormalizePoseKernel()
