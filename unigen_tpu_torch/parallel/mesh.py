"""The (data, fsdp, model) device mesh over the ``torch.distributed`` world.

Port of ``unigen_tpu/parallel/mesh.py``. One logical mesh with axes
(data, fsdp, model), one rank a cell, ranks laid out row-major:

* ``data``  - batch sharding: plain data parallelism;
* ``fsdp``  - parameter sharding along the batch-replica group (ZeRO-3);
  fsdp ranks also take distinct rows of the batch;
* ``model`` - tensor parallelism (Megatron column / row products).

JAX's GSPMD inserts every collective from the shardings; here the steps and
the models call the four autograd functions of ``collectives.py`` over the
groups this mesh builds once: one group an axis and one for each pair of
axes, among them the batch group (data, fsdp).

``make_mesh`` makes its mesh the process's current one (``current_mesh``),
as ``jax.set_mesh`` does for a ``with`` block; ``set_mesh(None)`` clears it.
"""
from __future__ import annotations

import dataclasses
import itertools
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class MeshAxes:
    data: str = "data"
    fsdp: str = "fsdp"
    model: str = "model"


AXES = MeshAxes()
AXIS_NAMES = (AXES.data, AXES.fsdp, AXES.model)
BATCH_AXES = (AXES.data, AXES.fsdp)

_CURRENT: Optional["Mesh"] = None
_MESHES: Dict[tuple, "Mesh"] = {}


def world() -> Tuple[int, int]:
    """(rank, world size) of the initialised process group, else (0, 1)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class Mesh:
    """The mesh of one process: its shape, its rank's coordinates, and the
    process groups of every axis and pair of axes (None where the group has
    one rank, so a collective over it is skipped)."""

    def __init__(self, data: int, fsdp: int, model: int, device_type: str = "cuda"):
        self.rank, self.world_size = world()
        self.shape: Dict[str, int] = dict(zip(AXIS_NAMES, (data, fsdp, model)))
        self.device_type = device_type
        grid = np.arange(self.world_size).reshape(data, fsdp, model)
        self.coord: Dict[str, int] = dict(zip(AXIS_NAMES, (int(c) for c in np.unravel_index(
            self.rank, grid.shape))))
        self._groups: Dict[Tuple[str, ...], object] = {}
        if self.world_size > 1:
            # every axis and pair of axes: the ranks that share the other axes'
            # coordinates, ordered row-major (dist's subgroups, built on all ranks)
            for n_axes in (1, 2):
                for axes in itertools.combinations(range(3), n_axes):
                    rest = [a for a in range(3) if a not in axes]
                    lines = np.moveaxis(grid, rest, range(len(rest))).reshape(
                        -1, int(np.prod([grid.shape[a] for a in axes])))
                    group, _ = dist.new_subgroups_by_enumeration(lines.tolist())
                    self._groups[tuple(AXIS_NAMES[a] for a in axes)] = group

    def _axes(self, axes) -> Tuple[str, ...]:
        return tuple(a for a in AXIS_NAMES if a in axes)

    def size(self, *axes: str) -> int:
        """The number of ranks along ``axes`` together."""
        return int(np.prod([self.shape[a] for a in self._axes(axes)], dtype=np.int64))

    def index(self, *axes: str) -> int:
        """This rank's index along ``axes`` together, row-major (its rank in
        their group)."""
        i = 0
        for a in self._axes(axes):
            i = i * self.shape[a] + self.coord[a]
        return i

    def group(self, *axes: str):
        """The process group of the ranks that differ only along ``axes``;
        None when it holds this rank alone."""
        axes = self._axes(axes)
        if self.size(*axes) == 1:
            return None
        if len(axes) == 3:
            return dist.group.WORLD
        return self._groups[axes]

    def __repr__(self) -> str:
        return (f"Mesh(data={self.shape['data']}, fsdp={self.shape['fsdp']}, "
                f"model={self.shape['model']}, rank={self.rank})")


def make_mesh(data: int = -1, fsdp: int = 1, model: int = 1,
              device_type: str = "cuda") -> Mesh:
    """Create a (data, fsdp, model) mesh over the initialised world and make
    it current. ``data=-1`` absorbs the remaining ranks. ``device_type`` is
    ``"cuda"``, or ``"cpu"`` for the CPU tests."""
    _, n = world()
    if data == -1:
        denom = fsdp * model
        if n % denom:
            raise ValueError(f"{n} devices not divisible by fsdp*model={denom}")
        data = n // denom
    if data * fsdp * model != n:
        raise ValueError(f"mesh {data}x{fsdp}x{model} != {n} devices")
    key = (data, fsdp, model, device_type, n)
    if key not in _MESHES:       # its process groups are built once a shape
        _MESHES[key] = Mesh(data, fsdp, model, device_type)
    set_mesh(_MESHES[key])
    return _MESHES[key]


def set_mesh(mesh: Optional[Mesh]) -> None:
    global _CURRENT
    _CURRENT = mesh


def current_mesh() -> Optional[Mesh]:
    return _CURRENT


def local_device(device_type: str = "cuda", local_rank: Optional[int] = None) -> torch.device:
    """This rank's device: ``cuda:(local_rank % device_count)`` (the local
    rank from ``LOCAL_RANK``, else the global rank), or the CPU."""
    if device_type == "cpu":
        return torch.device("cpu")
    if local_rank is None:
        local_rank = int(os.environ.get("LOCAL_RANK", world()[0]))
    return torch.device("cuda", local_rank % torch.cuda.device_count())


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           device_type: str = "cuda",
                           backend: Optional[str] = None) -> torch.device:
    """Join the ``torch.distributed`` world and return this rank's device.

    A no-op for one process (JAX's ``initialize_distributed``), which returns
    ``cuda:0`` or the CPU. The backend is NCCL for ``device_type="cuda"``
    (one card a rank) and gloo for ``"cpu"``; ranks that share one card must
    pass ``backend="gloo"``, since NCCL refuses two ranks on one device.
    ``coordinator_address`` is ``host:port`` of rank 0's TCP store."""
    if device_type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device type {device_type}")
    if num_processes is None or num_processes <= 1:
        return local_device(device_type, 0)
    backend = backend or ("nccl" if device_type == "cuda" else "gloo")
    device = local_device(device_type, process_id)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)
    return device
