"""Collectives of host objects across the processes of ``torch.distributed``.

Port of ``unigen_tpu/utils/multihost.py``: ``gather_objects`` merges the
CoT-V rating tables of every rank (the reference's ``dist.all_gather_object``),
``broadcast_object`` sends rank 0's object to all, ``sync_hosts`` is the
barrier, ``broadcast_tensor`` sends rank 0's tensor of a known shape. One
process (no process group initialised) makes each the identity. The objects are pickled by ``torch.distributed``'s object
collectives, where JAX sends JSON bytes: anything JSON carries goes.
"""
from __future__ import annotations

from typing import Any, List, Optional, Sequence

import torch
import torch.distributed as dist


def process_index() -> int:
    """This process's rank (0 without a process group)."""
    return dist.get_rank() if _initialized() else 0


def process_count() -> int:
    """The number of processes (1 without a process group)."""
    return dist.get_world_size() if _initialized() else 1


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def gather_objects(obj: Any) -> List[Any]:
    """``obj`` of every process, ordered by rank; ``[obj]`` on one."""
    if process_count() == 1:
        return [obj]
    out: List[Any] = [None] * process_count()
    dist.all_gather_object(out, obj)
    return out


def broadcast_object(obj: Any, source: int = 0) -> Any:
    """``source``'s ``obj`` on every process."""
    if process_count() == 1:
        return obj
    box = [obj if process_index() == source else None]
    dist.broadcast_object_list(box, src=source)
    return box[0]


def sync_hosts() -> None:
    """A barrier across processes."""
    if process_count() > 1:
        dist.barrier()


def broadcast_tensor(t: Optional[torch.Tensor], shape: Sequence[int], dtype: torch.dtype,
                     source: int = 0) -> torch.Tensor:
    """``source``'s tensor of ``shape`` and ``dtype`` on every process, on
    the device the world's backend carries (the CPU under gloo, this rank's
    card under NCCL): ``t`` on ``source``, ignored elsewhere. Fixed-layout
    integer plans go this way instead of a pickle (the serving engine's
    rank-0 plan); ``t`` itself on one process."""
    if process_count() == 1:
        return t
    device = (torch.device("cpu") if dist.get_backend() == "gloo"
              else torch.device("cuda", torch.cuda.current_device()))
    if process_index() == source:
        buf = t.to(device=device, dtype=dtype).contiguous()
    else:
        buf = torch.empty(tuple(shape), dtype=dtype, device=device)
    dist.broadcast(buf, src=source)
    return buf
