"""Device resolution for the port's entry points.

Entry points run on the GPU unless the caller asks for the CPU. Without a GPU
and without an explicit ``device="cpu"`` they raise instead of continuing on
the CPU, so a run never measures or validates the wrong device by accident.
"""
from __future__ import annotations

from typing import Optional, Union

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
