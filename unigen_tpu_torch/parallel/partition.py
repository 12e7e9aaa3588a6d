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

Quantized and LoRA leaves follow their projection's rule, where JAX's
rules (written for ``kernel`` / ``weight`` / ``bias`` / ``scale``) leave
``kernel_int8``, ``kernel_int4``, ``scale4`` and the adapters whole:

* a W8A8 node ``{kernel_int8 [Npad, K], scale [N], bias? [N]}``: column
  parallel, each rank takes N / m of the real rows (re-padded to a multiple
  of 8), their scales and biases; row parallel, K / m columns, the scale and
  bias whole;
* a W4A8 node ``{kernel_int4 [K/2, Npad], scale4 [K/group, Npad], bias
  [N]}``: column parallel, N / m real columns re-padded to a multiple of
  512; row parallel, K / m rows by whole groups, the node first repacked at
  ``gcd(group, K / m)`` where a group straddles the cut (the int4 values
  unchanged, each new group taking its old group's scale row;
  ``Sharding.groups`` keeps the old group, and ``gather_params`` rebuilds
  the node bit for bit);
* the text and image heads' quantized nodes (``lm_head_q``, ``img_head_q``)
  are column parallel as the float heads;
* adapters ``<name>_lora_a [in, r]`` / ``<name>_lora_b [r, out]``: a
  column projection's b on ``out``, a row projection's a on ``in``, the
  other whole.

``sanitize_specs`` tests a node's real N (column) or K (row), never the
padded Npad, and keeps the whole node's leaves together.

Three deliberate differences from JAX's placement (ROADMAP), the sharding
of the quantized and LoRA leaves above being the third:

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
is its inverse. The forwards read a leaf's layout from the spec tree
``Sharding.tree(local)`` passed beside the parameters, never from the
tensor: a clone, a deep copy, a ``torch.save`` / ``torch.load`` round trip
or a cast of the shards runs with the same ``Sharding``.
"""
from __future__ import annotations

import dataclasses
import math
import re
from typing import Any, Dict, Iterator, List, Optional, Tuple

import torch

from ..ops import int4
from ..ops.quantization import int8_leaf
from . import collectives as C
from .mesh import AXES, BATCH_AXES, Mesh

Spec = Tuple[Optional[str], ...]
M = AXES.model

_COLUMN = r"layers/\d+/([qkv]|gate|up)"
_ROW = r"layers/\d+/(o|down)"

# (regex over the port's path, spec of the port's leaf)
_QWEN2_RULES = [
    (_COLUMN + r"/kernel_int8$", (M, None)),             # W8A8 [Npad, K]
    (_COLUMN + r"/(scale|bias)$", (M,)),
    (_ROW + r"/kernel_int8$", (None, M)),
    (_COLUMN + r"/(kernel_int4|scale4)$", (None, M)),    # W4A8 [K/2 | K/group, Npad]
    (_ROW + r"/(kernel_int4|scale4)$", (M, None)),
    (_COLUMN + r"_lora_b$", (None, M)),                  # LoRA b [r, out], a [in, r]
    (_ROW + r"_lora_a$", (M, None)),
    (r"lm_head_q/kernel_int8$", (M, None)),
    (r"lm_head_q/(scale|bias)$", (M,)),
    (r"lm_head_q/(kernel_int4|scale4)$", (None, M)),
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
    (r"img_head_q/kernel_int8$", (M, None)),
    (r"img_head_q/(scale|bias)$", (M,)),
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
_QUANT_KEYS = ("kernel_int8", "kernel_int4")


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


def _spec_for(path: str, leaf: torch.Tensor, rules) -> Spec:
    for pat, spec in rules:
        if re.search(pat, path):
            # a rank mismatch (a rule for a kernel hitting a bias) replicates
            return spec if leaf.dim() == len(spec) else (None,) * leaf.dim()
    return (None,) * leaf.dim()


def _units(tree: Any, prefix: str = "") -> Iterator[Tuple[str, Dict]]:
    """(path, node) of every W8A8 / W4A8 node of ``tree``."""
    if isinstance(tree, dict):
        if any(k in tree for k in _QUANT_KEYS):
            yield prefix, tree
            return
        for k in sorted(tree):
            yield from _units(tree[k], f"{prefix}/{k}" if prefix else str(k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _units(v, f"{prefix}/{i}" if prefix else str(i))


def _unit_split(path: str, node: Dict, specs: Dict[str, Spec]) -> Optional[str]:
    """"column" or "row": how a quantized node's product is split on
    ``model`` by its specs; None when it is not."""
    int4 = "kernel_int4" in node
    spec = specs[f"{path}/{'kernel_int4' if int4 else 'kernel_int8'}"]
    if M not in spec:
        return None
    return "column" if (spec.index(M) == 1) == int4 else "row"


def _unit_dims(node: Dict) -> Tuple[int, int, int]:
    """(K, real N, group or 0) of a quantized node."""
    if "kernel_int4" in node:
        k = 2 * node["kernel_int4"].shape[0]
        return k, node["bias"].shape[0], k // node["scale4"].shape[0]
    return node["kernel_int8"].shape[1], node["scale"].shape[0], 0


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
    161-entry tiny vocabulary cannot be sharded 2-way). A quantized node's
    ``model`` axis is kept or dropped on all its leaves at once, by its real
    N (column) or K (row), not by the padded Npad: the flagship's 159,867-row
    ``lm_head_q`` stays whole as the float head does."""
    leaves = dict(named_leaves(params))
    out = {p: tuple(None if d is None or leaves[p].shape[i] % _axis_size(mesh, d) else d
                    for i, d in enumerate(spec))
           for p, spec in specs.items()}
    m = mesh.size(M)
    for path, node in _units(params):
        split = _unit_split(path, node, specs)
        if split is None:
            continue
        k, n, group = _unit_dims(node)
        ok = n % m == 0 if split == "column" else (
            k % m == 0 and (not group or (k // m) % 2 == 0 and math.gcd(group, k // m) % 2 == 0))
        for key in node:
            p = f"{path}/{key}"
            out[p] = tuple((M if ok else None) if a == M else b
                           for a, b in zip(specs[p], out[p]))
    return out


def align_heads(specs: Dict[str, Spec], cfg, mesh: Mesh, prefix: str = "llm/") -> Dict[str, Spec]:
    """Column sharding by whole heads: raise when the query heads do not
    divide over ``model``; replicate k/v (weights and biases) when the KV
    heads do not (each rank then takes its query group's KV heads), and
    with them their quantized nodes and adapters."""
    m = mesh.size(AXES.model)
    if m == 1:
        return specs
    if cfg.num_attention_heads % m:
        raise ValueError(f"{cfg.num_attention_heads} query heads do not split over model={m}")
    if cfg.num_key_value_heads % m == 0:
        return specs
    kv = re.compile("^" + re.escape(prefix) + r"layers/\d+/([kv]_[wb]|[kv]_lora_[ab]|[kv]/\w+)$")
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
    # a W4A8 node repacked to split on whole groups: {path: its own group}
    groups: Dict[str, int] = dataclasses.field(default_factory=dict)

    def spec_list(self, tree: Any) -> List[Spec]:
        return [self.specs[p] for p, _ in named_leaves(tree)]

    def tree(self, tree: Any) -> Any:
        """The spec tree of the local ``tree`` (its params, or an EMA copy
        of them): shaped like it, each leaf its spec with the axes of one
        rank stripped, None where the leaf is whole here. The forwards take
        it as ``specs``."""
        def spec(path: str, _t) -> Optional[Spec]:
            s = tuple(a if a is not None and _axis_size(self.mesh, a) > 1 else None
                      for a in self.specs[path])
            return s if any(a is not None for a in s) else None
        return _map_units(tree, spec, lambda p, node: {
            k: None if t is None else spec(f"{p}/{k}", t) for k, t in node.items()})


def local_shard(t: torch.Tensor, spec: Spec, mesh: Mesh) -> torch.Tensor:
    """This rank's contiguous piece of the whole ``t`` under ``spec``."""
    for dim, axis in enumerate(spec):
        if axis is not None:
            n = _axis_size(mesh, axis)
            k = t.shape[dim] // n
            t = t.narrow(dim, mesh.index(*((axis,) if isinstance(axis, str) else axis)) * k, k)
    return t.contiguous()


def _without_model(spec: Spec) -> Spec:
    return tuple(None if a == M else a for a in spec)


def _only_model(spec: Spec) -> Spec:
    return tuple(a if a == M else None for a in spec)


def _shard_unit(path: str, node: Dict, sharding: Sharding) -> Dict:
    """This rank's piece of a quantized node: the relayout on ``model``
    (module docstring), then the plain slices of the other axes."""
    specs, mesh = sharding.specs, sharding.mesh
    split = _unit_split(path, node, specs)
    m, r = mesh.size(M), mesh.index(M)
    k, n, group = _unit_dims(node)
    if split == "column":
        a, b = r * n // m, (r + 1) * n // m
        if group:
            node = int4.column_slice(node, a, b)
        else:
            node = int8_leaf(node["kernel_int8"][a:b], node["scale"][a:b],
                             None if node.get("bias") is None else node["bias"][a:b])
    elif split == "row":
        g = math.gcd(group, k // m) if group else 0
        if g != group:
            node = int4.regroup(node, group, g)
            sharding.groups[path] = group
        node = {key: local_shard(t, _only_model(specs[f"{path}/{key}"]), mesh)
                for key, t in node.items()}
    return {key: local_shard(t, _without_model(specs[f"{path}/{key}"]), mesh)
            for key, t in node.items()}


def _map_units(tree: Any, leaf_fn, unit_fn, prefix: str = "") -> Any:
    """``tree`` with each quantized node replaced by ``unit_fn(path, node)``
    and every other tensor by ``leaf_fn(path, tensor)``."""
    if isinstance(tree, dict):
        if any(k in tree for k in _QUANT_KEYS):
            return unit_fn(prefix, tree)
        return {k: _map_units(v, leaf_fn, unit_fn, f"{prefix}/{k}" if prefix else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_units(v, leaf_fn, unit_fn, f"{prefix}/{i}" if prefix else str(i))
                for i, v in enumerate(tree)]
    return None if tree is None else leaf_fn(prefix, tree)


def shard_params(params: Any, specs: Dict[str, Spec], mesh: Mesh) -> Tuple[Any, Sharding]:
    """(this rank's local shards of ``params``, their ``Sharding``). The
    specs are sanitized first; quantized nodes are laid out as the module
    docstring says."""
    specs = sanitize_specs(specs, params, mesh)
    sharding = Sharding(specs, mesh)
    local = _map_units(params, lambda p, t: local_shard(t, specs[p], mesh),
                       lambda p, node: _shard_unit(p, node, sharding))
    return local, sharding


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


def _gather_unit(path: str, node: Dict, sharding: Sharding) -> Dict:
    """The whole quantized node from every rank's piece, bit for bit:
    ``_shard_unit`` undone."""
    specs, mesh = sharding.specs, sharding.mesh
    split = _unit_split(path, node, specs)
    node = {key: gather_full(t.detach(), _without_model(specs[f"{path}/{key}"]), mesh)
            for key, t in node.items()}
    if split == "column":
        _, n, group = _unit_dims(node)
        if group:
            # the real columns, gathered, padded back as pack_int4 pads
            cols = {key: gather_full(node[key][:, :n], (None, M), mesh)
                    for key in ("kernel_int4", "scale4")}
            whole = {"bias": gather_full(node["bias"], (M,), mesh), **cols}
            return int4.column_slice(whole, 0, whole["bias"].shape[0])
        bias = node.get("bias")
        return int8_leaf(gather_full(node["kernel_int8"][:n], (M, None), mesh),
                         gather_full(node["scale"], (M,), mesh),
                         None if bias is None else gather_full(bias, (M,), mesh))
    if split == "row":
        node = {key: gather_full(t, _only_model(specs[f"{path}/{key}"]), mesh)
                for key, t in node.items()}
        if path in sharding.groups:
            node = int4.regroup(node, _unit_dims(node)[2], sharding.groups[path])
    return node


def gather_params(local: Any, sharding: Sharding) -> Any:
    """The whole tree on every rank, from the local shards."""
    return _map_units(local, lambda p, t: gather_full(t.detach(), sharding.specs[p],
                                                      sharding.mesh),
                      lambda p, node: _gather_unit(p, node, sharding))
