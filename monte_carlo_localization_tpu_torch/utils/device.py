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


def upload(x, device: torch.device, dtype: torch.dtype = torch.float32,
           out: torch.Tensor | None = None) -> torch.Tensor:
    """``x`` (array, number or tensor) as a ``dtype`` tensor on ``device``,
    or copied into ``out`` (whose device and type then rule). A host value
    goes to a card through pinned memory without waiting: a plain
    host-to-device copy synchronizes the stream, and with it every
    correction still in flight."""
    if out is not None:
        device, dtype = out.device, out.dtype
    if isinstance(x, torch.Tensor) and (x.device.type != "cpu" or device.type == "cpu"):
        return x.to(device=device, dtype=dtype) if out is None else out.copy_(x)
    t = x.to(dtype) if isinstance(x, torch.Tensor) else torch.tensor(np.asarray(x), dtype=dtype)
    if device.type != "cuda":
        return t.to(device) if out is None else out.copy_(t)
    t = t.pin_memory()
    return t.to(device, non_blocking=True) if out is None else out.copy_(t, non_blocking=True)
