"""Sharding specs for the port's parameter trees, and the sharding itself.

Port of ``unigen_tpu/parallel/partition.py``: Megatron tensor parallelism
by rules (column-parallel q/k/v, gate/up and ``img_head``, row-parallel o
and down, a vocab-sharded embedding and head; SigLIP's column / row
rules), ZeRO-3 sharding of each large leaf on ``fsdp`` (``add_fsdp``), the
batch on (data, fsdp) (``partition_batch``) and ``sanitize_specs``.

A spec is a tuple of axis names (or None) a dimension of the port's leaf,
and a tree's specs are a flat ``{path: spec}`` over ``named_leaves`` paths
(list indices as numbers). The rules are written in the port's [out, in]
layout: JAX's column-parallel ``P(None, model)`` on an [in, out] kernel is
the port's dimension 0, its row-parallel ``P(model, None)`` the port's
dimension 1, a bias sharded on ``model`` dimension 0.

Two deliberate differences from JAX's placement (ROADMAP):

* JAX's layer leaves are stacked, and ``add_fsdp`` puts ``fsdp`` on the
  first free dimension, which there is the layer axis. The port's leaves
  are per layer: the threshold is taken on the stacked size (``n_layers``
  times the leaf's), and ``fsdp`` goes on the first free dimension of the
  leaf in JAX's order (a transposed kernel's dimensions read backwards).
  Each rank holds the same share of the layer parameters.
* Column sharding never splits a head (``align_heads``): where
  ``num_key_value_heads`` is not a multiple of ``model``, k/v and their
  biases replicate and each rank takes its query group's KV heads;
  GSPMD may split a head, with the same results.

``shard_params`` returns a rank's local shards (contiguous fsdp and model
slices) and a ``Sharding`` record of the specs and mesh; ``gather_params``
is its inverse.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, Iterator, List, Optional, Tuple

import torch

from . import collectives as C
from .mesh import AXES, BATCH_AXES, Mesh

Spec = Tuple[Optional[str], ...]
M = AXES.model

# (regex over the port's path, spec of the port's leaf)
_QWEN2_RULES = [
    (r"embed$", (M, None)),                              # vocab-sharded embedding
    (r"lm_head$", (M, None)),
    (r"layers/\d+/[qkv]_w$", (M, None)),                 # column parallel
    (r"layers/\d+/[qkv]_b$", (M,)),
    (r"layers/\d+/o_w$", (None, M)),                     # row parallel
    (r"layers/\d+/(gate|up)_w$", (M, None)),
    (r"layers/\d+/down_w$", (None, M)),
    (r"_ln$", ()),
    (r"final_ln$", ()),
]

_UNIGEN_EXTRA_RULES = [
    (r"gen_embed$", (None, None)),
    (r"img_head$", (M, None)),
    (r"(gen_projector|mm_projector)/\d+/w$", (None, None)),
    (r"(gen_projector|mm_projector)/\d+/b$", ()),
]

_SIGLIP_RULES = [
    (r"layers/\d+/[qkv]_w$", (M, None)),
    (r"layers/\d+/[qkv]_b$", (M,)),
    (r"layers/\d+/o_w$", (None, M)),
    (r"layers/\d+/fc1_w$", (M, None)),
    (r"layers/\d+/fc1_b$", (M,)),
    (r"layers/\d+/fc2_w$", (None, M)),
]

# leaves that are JAX kernels transposed ([out, in] here, [in, out] there)
_TRANSPOSED = re.compile(r"(^|/)(\w+_w|w|img_head|lm_head)$")
_LAYER = re.compile(r"(^|/)layers/\d+/")
_UNSUPPORTED_TP = re.compile(r"_lora_|kernel_int8|kernel_int4|lm_head_q")


def named_leaves(tree: Any, prefix: str = "") -> Iterator[Tuple[str, torch.Tensor]]:
    """(``/``-joined path, tensor): dict keys sorted, lists in order (the
    optimizer's order)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from named_leaves(tree[k], f"{prefix}/{k}" if prefix else str(k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from named_leaves(v, f"{prefix}/{i}" if prefix else str(i))
    elif tree is not None:
        yield prefix, tree


def _map(tree: Any, fn, prefix: str = "") -> Any:
    """``fn(path, leaf)`` of every tensor, in ``tree``'s structure."""
    if isinstance(tree, dict):
        return {k: _map(v, fn, f"{prefix}/{k}" if prefix else str(k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(v, fn, f"{prefix}/{i}" if prefix else str(i)) for i, v in enumerate(tree)]
    return None if tree is None else fn(prefix, tree)


def _spec_for(path: str, leaf: torch.Tensor, rules) -> Spec:
    for pat, spec in rules:
        if re.search(pat, path):
            # a rank mismatch (a rule for a kernel hitting a bias) replicates
            return spec if leaf.dim() == len(spec) else (None,) * leaf.dim()
    return (None,) * leaf.dim()


def _specs(params: Any, rules) -> Dict[str, Spec]:
    return {p: _spec_for(p, t, rules) for p, t in named_leaves(params)}


def partition_qwen2(params: Any) -> Dict[str, Spec]:
    return _specs(params, _QWEN2_RULES)


def partition_unigen(params: Any) -> Dict[str, Spec]:
    # UniGen's rules first: "gen_embed" must not hit the vocab-sharded "embed" rule
    return _specs(params, _UNIGEN_EXTRA_RULES + _QWEN2_RULES)


def partition_magvit(params: Any) -> Dict[str, Spec]:
    """The tokenizer's convolutions are small: replicated."""
    return _specs(params, [])


def partition_siglip(params: Any) -> Dict[str, Spec]:
    """SigLIP's and the SigLIP2 tower's layers (the same leaves)."""
    return _specs(params, _SIGLIP_RULES)


def _n_layers(params: Any, path: str) -> int:
    node = params
    for k in path.split("/"):
        if k == "layers":
            return len(node[k])
        node = node[int(k)] if isinstance(node, list) else node[k]
    return 1


def add_fsdp(specs: Dict[str, Spec], params: Any, min_size: int = 2 ** 14
             ) -> Dict[str, Spec]:
    """ZeRO-3: also shard each large leaf's first free dimension (in JAX's
    order) on ``fsdp``; a layer leaf's size counts all layers, as JAX's
    stacked leaf (module docstring)."""
    out = dict(specs)
    for path, leaf in named_leaves(params):
        size = leaf.numel() * (_n_layers(params, path) if _LAYER.search(path) else 1)
        if size < min_size:
            continue
        dims = list(specs[path])
        order = range(leaf.dim())
        if _TRANSPOSED.search(path) and leaf.dim() == 2:
            order = reversed(order)
        for i in order:
            if dims[i] is None and leaf.shape[i] > 1:
                dims[i] = AXES.fsdp
                out[path] = tuple(dims)
                break
    return out


def partition_batch(ndim: int) -> Spec:
    """The batch's leading dimension on (data, fsdp): fsdp groups take
    distinct rows too, as ZeRO's data parallelism."""
    return (BATCH_AXES,) + (None,) * (ndim - 1)


def _axis_size(mesh: Mesh, d) -> int:
    return mesh.size(*((d,) if isinstance(d, str) else d))


def sanitize_specs(specs: Dict[str, Spec], params: Any, mesh: Mesh) -> Dict[str, Spec]:
    """Replicate any dimension whose size its mesh axis does not divide (a
    161-entry tiny vocabulary cannot be sharded 2-way)."""
    leaves = dict(named_leaves(params))
    return {p: tuple(None if d is None or leaves[p].shape[i] % _axis_size(mesh, d) else d
                     for i, d in enumerate(spec))
            for p, spec in specs.items()}


def align_heads(specs: Dict[str, Spec], cfg, mesh: Mesh, prefix: str = "llm/") -> Dict[str, Spec]:
    """Column sharding by whole heads: raise when the query heads do not
    divide over ``model``; replicate k/v (weights and biases) when the KV
    heads do not (each rank then takes its query group's KV heads)."""
    m = mesh.size(AXES.model)
    if m == 1:
        return specs
    if cfg.num_attention_heads % m:
        raise ValueError(f"{cfg.num_attention_heads} query heads do not split over model={m}")
    if cfg.num_key_value_heads % m == 0:
        return specs
    kv = re.compile("^" + re.escape(prefix) + r"layers/\d+/[kv]_[wb]$")
    return {p: ((None,) * len(s) if kv.search(p) else s) for p, s in specs.items()}


def unigen_specs(params: Any, cfg, mesh: Mesh, fsdp: bool = False) -> Dict[str, Spec]:
    """The UniGen tree's specs on ``mesh``: the rules, ``add_fsdp`` when
    asked, ``sanitize_specs``, whole heads."""
    specs = partition_unigen(params)
    if fsdp:
        specs = add_fsdp(specs, params)
    return align_heads(sanitize_specs(specs, params, mesh), cfg.llm, mesh)


def siglip_specs(params: Any, mesh: Mesh, fsdp: bool = False) -> Dict[str, Spec]:
    specs = partition_siglip(params)
    if fsdp:
        specs = add_fsdp(specs, params)
    return sanitize_specs(specs, params, mesh)


@dataclasses.dataclass
class Sharding:
    """The record of a sharded tree: its specs by path and its mesh; a
    train state's also the specs of its optimizer moments (one a trained
    leaf, in order)."""
    specs: Dict[str, Spec]
    mesh: Mesh
    moments: Optional[List[Spec]] = None

    def leaf_specs(self, tree: Any) -> List[Tuple[torch.Tensor, Spec]]:
        return [(t, self.specs[p]) for p, t in named_leaves(tree)]

    def spec_list(self, tree: Any) -> List[Spec]:
        return [self.specs[p] for p, _ in named_leaves(tree)]


def local_shard(t: torch.Tensor, spec: Spec, mesh: Mesh) -> torch.Tensor:
    """This rank's contiguous piece of the whole ``t`` under ``spec``."""
    for dim, axis in enumerate(spec):
        if axis is not None:
            n = _axis_size(mesh, axis)
            k = t.shape[dim] // n
            t = t.narrow(dim, mesh.index(*((axis,) if isinstance(axis, str) else axis)) * k, k)
    return t.contiguous()


def shard_params(params: Any, specs: Dict[str, Spec], mesh: Mesh) -> Tuple[Any, Sharding]:
    """(this rank's local shards of ``params``, their ``Sharding``). The
    specs are sanitized first. A LoRA or a W8A8 / W4A8 tree under
    ``model > 1`` raises (ROADMAP Queue 1 item 15(c))."""
    specs = sanitize_specs(specs, params, mesh)
    if mesh.size(AXES.model) > 1:
        bad = [p for p, _ in named_leaves(params) if _UNSUPPORTED_TP.search(p)]
        if bad:
            raise NotImplementedError(
                f"{bad[0]}: LoRA and quantized trees under model > 1 are not ported "
                "(ROADMAP Queue 1 item 15(c)); shard them on data and fsdp only")
    sharding = Sharding(specs, mesh)
    return C.register(sharding, _map(params, lambda p, t: local_shard(t, specs[p], mesh))), \
        sharding


@torch.no_grad()
def gather_full(t: torch.Tensor, spec: Spec, mesh: Mesh) -> torch.Tensor:
    """The whole leaf from every rank's ``t`` (an all-gather an axis), a
    new tensor."""
    t = t.clone()
    for dim, axis in enumerate(spec):
        group = None if axis is None else mesh.group(*((axis,) if isinstance(axis, str) else axis))
        if group is not None:
            t = C._all_gather(t, group, dim)
    return t.contiguous()


def gather_params(local: Any, sharding: Sharding) -> Any:
    """The whole tree on every rank, from the local shards."""
    return _map(local, lambda p, t: gather_full(t.detach(), sharding.specs[p], sharding.mesh))
