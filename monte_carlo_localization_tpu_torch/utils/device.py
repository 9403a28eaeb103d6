"""The device an entry point runs on.

Every entry point of the package that takes ``device`` defaults to the
card (:data:`DEFAULT_DEVICE`). CPU callers, the tests among them, pass
``device="cpu"``; a default call on a machine without CUDA raises
instead of running on the CPU.
"""

from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device: torch.device | str) -> torch.device:
    """``device`` as a ``torch.device``; raises for a CUDA device on a
    machine that has none."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested (the default of the port's entry points) "
            "but torch.cuda.is_available() is False; pass device='cpu' to run "
            "on the CPU"
        )
    return dev
