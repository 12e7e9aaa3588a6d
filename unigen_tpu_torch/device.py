"""Device resolution for the port's entry points.

Entry points run on the GPU unless the caller asks for the CPU. Without a GPU
and without an explicit ``device="cpu"`` they raise instead of continuing on
the CPU, so a run never measures or validates the wrong device by accident.
"""
from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means ``cuda``; ``"cpu"`` must be asked for explicitly."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def to_device(data, device: torch.device, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """A host array as a tensor on ``device``. To a CUDA device it goes
    through pinned memory with a non-blocking copy, so the host does not
    wait for the work already queued on the stream (a pageable copy
    synchronises the stream)."""
    t = torch.as_tensor(np.asarray(data), dtype=dtype)
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def fetch_async(t: torch.Tensor):
    """Starts the copy of a CUDA tensor to pinned host memory and returns
    (host tensor, event that marks its arrival). The copy is queued behind
    the work that made ``t`` only, so waiting on the event does not wait for
    work queued after it. A CPU tensor is returned as it is, with no event."""
    if t.device.type != "cuda":
        return t, None
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return host, event
