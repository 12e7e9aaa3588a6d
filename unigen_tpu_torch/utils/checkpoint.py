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
"""
from __future__ import annotations

import os
import re
import shutil
from typing import Any, List, Optional

import torch

from .persistence import from_pretrained, save_pretrained


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
    """NamedTuples as mappings of their fields (None fields dropped)."""
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return {f: _to_tree(v) for f, v in zip(x._fields, x) if v is not None}
    if isinstance(x, dict):
        return {k: _to_tree(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_to_tree(v) for v in x]
    return x


def _like(loaded: Any, target: Any) -> Any:
    """``loaded`` (CPU tensors in ``_to_tree(target)``'s structure) rebuilt
    as ``target``: its NamedTuples, devices, dtypes and requires_grad."""
    if isinstance(target, tuple) and hasattr(target, "_fields"):
        return type(target)(*[None if v is None else _like(loaded[f], v)
                              for f, v in zip(target._fields, target)])
    if isinstance(target, dict):
        return {k: _like(loaded[k], v) for k, v in target.items()}
    if isinstance(target, (list, tuple)):
        return [_like(a, b) for a, b in zip(loaded, target)]
    t = loaded.to(device=target.device, dtype=target.dtype)
    return t.requires_grad_(True) if target.requires_grad else t


def save_checkpoint(state: Any, output_dir: str, step: int,
                    total_limit: Optional[int] = None,
                    unwrapped_params: Optional[Any] = None) -> str:
    """Save the trainer state (and a portable parameter tree in the JAX layout)."""
    rotate_checkpoints(output_dir, total_limit)
    path = os.path.join(output_dir, f"checkpoint-{step}")
    if os.path.isdir(path):  # a re-save at the same step overwrites
        shutil.rmtree(path, ignore_errors=True)
    save_pretrained(_to_tree(state), os.path.join(path, "state"))
    if unwrapped_params is not None:
        save_pretrained(unwrapped_params, os.path.join(path, "unwrapped_model"))
    return path


def latest_checkpoint(output_dir: str) -> Optional[str]:
    dirs = _ckpt_dirs(output_dir)
    return os.path.join(output_dir, dirs[-1]) if dirs else None


@torch.no_grad()
def restore_checkpoint(path: str, target: Any, kind: str = "state") -> Any:
    """Restore into the structure, devices and dtypes of ``target``."""
    loaded, _ = from_pretrained(os.path.join(path, kind), _to_tree(target))
    return _like(loaded, target)


def resume_step(path: str) -> int:
    """checkpoint-<step> -> step."""
    return int(os.path.basename(path).split("-")[1])
