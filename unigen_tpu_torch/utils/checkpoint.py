"""Checkpoint save / restore with rotation, in place of the JAX package's Orbax.

Port of ``unigen_tpu/utils/checkpoint.py`` with its layout:

1. trainer state, ``checkpoint-<step>/state``: the whole ``TrainState``
   (params, the optimizer's two moments and count, the step, the EMA),
   rotated by ``checkpoints_total_limit`` and resumed from the latest
   ``checkpoint-*``;
2. portable model, ``checkpoint-<step>/unwrapped_model``: a parameter tree
   in the JAX layout (``weights.unigen_to_jax``), which
   ``launch.build_pipeline(config)`` / ``build_unigen`` load through
   ``model.unigen.pretrained_model_path``: the stage handoff.

Both are written by ``utils/persistence.py`` (safetensors under the trees'
``/``-joined paths; a NamedTuple is a mapping of its fields), not pickles.

A sharded state (``TrainState.sharding``, ``parallel/``) is saved by every
rank that holds a distinct shard (data coordinate 0): ``state/shard-f<i>-m<j>``
is the state of fsdp index i and model index j in the format above, and
``state/sharding.json`` the mesh's shape and every leaf's spec. A restore
builds each of the target rank's pieces from the parts of the saved pieces
that overlap it, the files read through a memory map
(``persistence.map_file``), so a rank holds its own shards and no whole
leaf; a state saved on one mesh restores onto another mesh, or onto one
process, bit for bit. An unsharded checkpoint is read the same way. The
portable ``unwrapped_model`` stays whole: the caller gathers the
parameters (``parallel.gather_params``) and rank 0 writes them.
"""
from __future__ import annotations

import glob
import json
import os
import re
import shutil
from typing import Any, Dict, Iterator, List, Optional, Tuple

import torch
import torch.distributed as dist

from ..parallel.mesh import AXES, world
from ..parallel.partition import Sharding
from .persistence import _leaves, _unflatten, from_pretrained, load_state_dict, save_pretrained

SHARDING_NAME = "sharding.json"


def _ckpt_dirs(output_dir: str) -> List[str]:
    if not os.path.isdir(output_dir):
        return []
    dirs = [d for d in os.listdir(output_dir) if re.match(r"checkpoint-\d+$", d)]
    return sorted(dirs, key=lambda d: int(d.split("-")[1]))


def rotate_checkpoints(output_dir: str, total_limit: Optional[int]) -> None:
    """Delete the oldest checkpoints so that one more fits the limit."""
    if not total_limit:
        return
    dirs = _ckpt_dirs(output_dir)
    if len(dirs) >= total_limit:
        for d in dirs[: len(dirs) - total_limit + 1]:
            shutil.rmtree(os.path.join(output_dir, d), ignore_errors=True)


def _to_tree(x: Any) -> Any:
    """NamedTuples as mappings of their fields (None fields and the sharding
    record dropped)."""
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return {f: _to_tree(v) for f, v in zip(x._fields, x)
                if v is not None and not isinstance(v, Sharding)}
    if isinstance(x, dict):
        return {k: _to_tree(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_to_tree(v) for v in x]
    return x


def state_leaves(state: Any) -> List[Tuple[str, torch.Tensor]]:
    """[(path, tensor)] of a ``TrainState`` as the checkpoint names them."""
    return _leaves(_to_tree(state))


def _like(loaded: Any, target: Any) -> Any:
    """``loaded`` (CPU tensors in ``_to_tree(target)``'s structure) rebuilt
    as ``target``: its NamedTuples, devices, dtypes and requires_grad."""
    if isinstance(target, tuple) and hasattr(target, "_fields"):
        return type(target)(*[v if v is None or isinstance(v, Sharding) else _like(loaded[f], v)
                              for f, v in zip(target._fields, target)])
    if isinstance(target, dict):
        return {k: _like(loaded[k], v) for k, v in target.items()}
    if isinstance(target, (list, tuple)):
        return [_like(a, b) for a, b in zip(loaded, target)]
    t = loaded.to(device=target.device, dtype=target.dtype)
    return t.requires_grad_(True) if target.requires_grad else t


def _barrier() -> None:
    if world()[1] > 1:
        dist.barrier()


def state_specs(state: Any) -> Dict[str, tuple]:
    """{path in ``_to_tree(state)``: spec} of a sharded ``TrainState``: the
    params' and the EMA's by the params' paths, the moments' by trained
    leaf, every other leaf replicated."""
    sh = state.sharding
    out = {}
    for p, t in state_leaves(state):
        m = re.match(r"opt_state/(mu|nu)/(\d+)$", p)
        if m:
            out[p] = tuple(sh.moments[int(m.group(2))])
        elif p.startswith("params/") or p.startswith("ema/params/"):
            out[p] = tuple(sh.specs[p.split("params/", 1)[1]])
        else:
            out[p] = (None,) * t.dim()
    return out


def _save_sharded(state: Any, path: str) -> None:
    mesh = state.sharding.mesh
    if mesh.coord[AXES.data] == 0:
        name = f"shard-f{mesh.coord[AXES.fsdp]}-m{mesh.coord[AXES.model]}"
        save_pretrained(_to_tree(state), os.path.join(path, "state", name))
    if mesh.rank == 0:
        with open(os.path.join(path, "state", SHARDING_NAME), "w") as f:
            json.dump({"mesh": mesh.shape, "specs": state_specs(state)}, f)


def save_checkpoint(state: Any, output_dir: str, step: int,
                    total_limit: Optional[int] = None,
                    unwrapped_params: Optional[Any] = None) -> str:
    """Save the trainer state (and a portable parameter tree in the JAX
    layout). Every rank of a sharded state calls it; rank 0 rotates and
    writes ``unwrapped_params``."""
    rank = world()[0]
    path = os.path.join(output_dir, f"checkpoint-{step}")
    if rank == 0:
        rotate_checkpoints(output_dir, total_limit)
        if os.path.isdir(path):  # a re-save at the same step overwrites
            shutil.rmtree(path, ignore_errors=True)
        os.makedirs(os.path.join(path, "state"))
    _barrier()
    if getattr(state, "sharding", None) is not None:
        _save_sharded(state, path)
    elif rank == 0:
        save_pretrained(_to_tree(state), os.path.join(path, "state"))
    if unwrapped_params is not None and rank == 0:
        save_pretrained(unwrapped_params, os.path.join(path, "unwrapped_model"))
    _barrier()
    return path


def latest_checkpoint(output_dir: str) -> Optional[str]:
    dirs = _ckpt_dirs(output_dir)
    return os.path.join(output_dir, dirs[-1]) if dirs else None


def _ranges(spec, shape, sizes: Dict[str, int], coord: Dict[str, int]):
    """[(start, stop)] a dimension of the piece at ``coord`` of a whole leaf
    of ``shape`` under ``spec`` on a mesh of ``sizes`` ranks an axis."""
    out = []
    for n, axis in zip(shape, spec):
        k = n // sizes[axis] if axis is not None else n
        i = coord[axis] if axis is not None else 0
        out.append((i * k, i * k + k))
    return out


def _saved_pieces(state_dir: str):
    """(mesh sizes, {path: spec}, [(coord, {path: tensor})]) of a saved
    state: a sharded one's pieces by fsdp and model index, or an unsharded
    one as a single piece; the tensors are views of memory maps."""
    info_path = os.path.join(state_dir, SHARDING_NAME)
    if not os.path.exists(info_path):
        sd = load_state_dict(state_dir, mmap=True)
        return {}, {p: (None,) * t.dim() for p, t in sd.items()}, [({}, sd)]
    with open(info_path) as f:
        info = json.load(f)
    pieces = []
    for d in sorted(glob.glob(os.path.join(state_dir, "shard-f*-m*"))):
        fi, mi = re.search(r"shard-f(\d+)-m(\d+)$", d).groups()
        pieces.append(({AXES.fsdp: int(fi), AXES.model: int(mi)}, load_state_dict(d, mmap=True)))
    return info["mesh"], {p: tuple(s) for p, s in info["specs"].items()}, pieces


def read_pieces(state_dir: str, specs: Dict[str, tuple], sizes: Optional[Dict[str, int]] = None,
                coord: Optional[Dict[str, int]] = None) -> Iterator[Tuple[str, torch.Tensor]]:
    """(path, this rank's piece) of each leaf of ``specs``, one at a time,
    on a mesh of ``sizes`` at ``coord`` (neither for specs that cut nothing:
    whole leaves): each copied from the parts of the saved pieces that
    overlap it, and nothing else read; the directory is mapped once."""
    saved_sizes, saved_specs, saved = _saved_pieces(state_dir)
    for p, spec in specs.items():
        sspec = saved_specs[p]
        local = saved[0][1][p].shape
        whole = [n * (saved_sizes[a] if a is not None else 1) for n, a in zip(local, sspec)]
        want = _ranges(spec, whole, sizes or {}, coord or {})
        piece = torch.empty([b - a for a, b in want], dtype=saved[0][1][p].dtype)
        seen = set()
        for scoord, sd in saved:
            have = _ranges(sspec, whole, saved_sizes, scoord)
            part = [(max(a0, b0), min(a1, b1)) for (a0, a1), (b0, b1) in zip(want, have)]
            if any(a >= b for a, b in part) or tuple(part) in seen:
                continue
            seen.add(tuple(part))
            src, dst = sd[p], piece
            for dim, (a, b) in enumerate(part):
                src = src.narrow(dim, a - have[dim][0], b - a)
                dst = dst.narrow(dim, a - want[dim][0], b - a)
            dst.copy_(src)
        yield p, piece


def _read_pieces(state_dir: str, specs: Dict[str, tuple], sizes: Dict[str, int],
                 coord: Dict[str, int]) -> Dict[str, torch.Tensor]:
    """{path: this rank's piece}: ``read_pieces`` gathered."""
    return dict(read_pieces(state_dir, specs, sizes, coord))


@torch.no_grad()
def restore_checkpoint(path: str, target: Any, kind: str = "state") -> Any:
    """Restore into the structure, devices and dtypes of ``target``: a
    sharded target (``TrainState.sharding``) gets its rank's pieces of each
    leaf, from a sharded checkpoint of any mesh or an unsharded one, and the
    restored state carries the target's ``Sharding``."""
    d = os.path.join(path, kind)
    sharding = getattr(target, "sharding", None)
    if not os.path.exists(os.path.join(d, SHARDING_NAME)) and sharding is None:
        loaded, _ = from_pretrained(d, _to_tree(target))
        return _like(loaded, target)
    if sharding is not None:
        pieces = _read_pieces(d, state_specs(target), sharding.mesh.shape, sharding.mesh.coord)
    else:
        pieces = _read_pieces(d, {p: (None,) * t.dim() for p, t in state_leaves(target)}, {}, {})
    return _like(_unflatten(pieces, _to_tree(target)), target)


def resume_step(path: str) -> int:
    """checkpoint-<step> -> step."""
    return int(os.path.basename(path).split("-")[1])
