"""The device an entry point runs on.

Every entry point of the package that takes ``device`` defaults to the
card (:data:`DEFAULT_DEVICE`). CPU callers, the tests among them, pass
``device="cpu"``; a default call on a machine without CUDA raises
instead of running on the CPU.
"""

from __future__ import annotations

import numpy as np
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


def upload(x, device: torch.device, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``x`` (array, number or tensor) as a ``dtype`` tensor on ``device``.
    A host value goes to a card through pinned memory without waiting: a
    plain host-to-device copy synchronizes the stream, and with it every
    correction still in flight."""
    if isinstance(x, torch.Tensor):
        if x.device == device:
            return x.to(dtype)
        t = x.to(dtype)
    else:
        t = torch.tensor(np.asarray(x), dtype=dtype)
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)
