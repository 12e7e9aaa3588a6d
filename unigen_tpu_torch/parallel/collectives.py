"""The collectives that JAX's GSPMD would insert, written out.

Four ``torch.autograd.Function``s are the only places where a forward or a
backward calls a collective on activations or weights:

* ``copy_to_model``: forward the identity, backward an all-reduce over the
  model group (the input of a column-parallel product, or a replicated
  weight that each model rank uses on its own heads);
* ``reduce_from_model``: forward an all-reduce, backward the identity (the
  output of a row-parallel product, a vocab-parallel embedding);
* ``gather_last``: forward an all-gather of a last dimension sharded on
  ``model``, backward this rank's slice (column-parallel logits);
* ``gather_fsdp``: forward an all-gather of a leaf sharded on ``fsdp``,
  backward a reduce-scatter (ZeRO-3's gather at use).

Outside autograd the steps reduce gradients, losses' denominators and
metrics over the batch group (``sync_grads``, ``batch_sum``) and the
sharded grad norm's partial sums (``all_reduce``); a row-parallel
quantized layer (no backward: ``models/qwen2.py`` refuses it) takes its
rows' absmax as a MAX over ``model`` (``max_over_model``) and sums its
int32 or fp32 partial products (``sum_over_model``).

Which leaves are sharded, and how, travels beside the parameters: a spec
tree shaped like the local tree (``partition.Sharding.tree``), each leaf
its spec with the axes of one rank stripped, None where the leaf is whole.
The forwards take the matching subtree (``sub``) as they take the
parameters and read it (``model_dim``, ``gather_fsdp``, ``gather_tree``);
a gathered leaf's remaining spec is returned beside it. No state here is
keyed by a tensor: a copy of a shard, given its specs, runs as the shard.
With no specs (None) every leaf is whole, and every function here is the
identity on it.
``batch_sharded(mesh)`` marks the block in which each rank holds its rows
of the global batch; only there do ``local_rows``, ``batch_sum`` and
``batch_mean`` act, and with no mesh (an unsharded state) they are the
identity, as ``sync_grads`` is.

Gloo takes CUDA tensors for all four operations (all-reduce, all-gather
into a tensor, reduce-scatter of a tensor, broadcast) in PyTorch 2.11
(checked with two ranks on one H100), so the port stages none through host
memory. ``timing()`` counts the calls and their seconds (synchronising the
card around each) for the collective share.
"""
from __future__ import annotations

import contextlib
import time
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from .mesh import AXES, BATCH_AXES, Mesh, current_mesh, set_mesh

Spec = Tuple[Optional[str], ...]

_BATCH = [False]
_TIMER: List[Optional[Dict[str, float]]] = [None]


# ---------------------------------------------------------------- the ops --

@contextlib.contextmanager
def timing():
    """Counts the collectives of the block: yields {"calls", "seconds"}.
    Each op is timed between two card synchronisations."""
    stats = {"calls": 0, "seconds": 0.0}
    _TIMER[0] = stats
    try:
        yield stats
    finally:
        _TIMER[0] = None


def _timed(fn, t: torch.Tensor):
    stats = _TIMER[0]
    if stats is None:
        return fn()
    if t.is_cuda:
        torch.cuda.synchronize(t.device)
    t0 = time.perf_counter()
    out = fn()
    if t.is_cuda:
        torch.cuda.synchronize(t.device)
    stats["calls"] += 1
    stats["seconds"] += time.perf_counter() - t0
    return out


def _all_reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """Sum (or ``op``) over ``group`` into a new tensor."""
    out = t.contiguous().clone()
    _timed(lambda: dist.all_reduce(out, op=op, group=group), out)
    return out


def _all_gather(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The group's pieces concatenated along ``dim``, in group-rank order."""
    n = dist.get_world_size(group)
    x = t.movedim(dim, 0).contiguous()
    out = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    _timed(lambda: dist.all_gather_into_tensor(out, x, group=group), x)
    return out.movedim(0, dim)


def _reduce_scatter(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The sum over ``group``, this rank's piece of ``dim``."""
    n = dist.get_world_size(group)
    x = t.movedim(dim, 0).contiguous()
    out = torch.empty((x.shape[0] // n,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    _timed(lambda: dist.reduce_scatter_tensor(out, x, group=group), x)
    return out.movedim(0, dim)


def _piece(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    n, i = dist.get_world_size(group), dist.get_rank(group)
    k = t.shape[dim] // n
    return t.narrow(dim, i * k, k).contiguous()


def all_reduce(t: torch.Tensor, *axes: str) -> torch.Tensor:
    """Sum of ``t`` over the current mesh's ``axes`` (no autograd)."""
    mesh = current_mesh()
    group = mesh.group(*axes) if mesh is not None else None
    return t if group is None else _all_reduce(t, group)


# ------------------------------------------------------- autograd functions --

class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherLast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_gather(x, group, x.dim() - 1)

    @staticmethod
    def backward(ctx, g):
        return _piece(g, ctx.group, g.dim() - 1), None


class _GatherFsdp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, group, dim):
        ctx.group, ctx.dim = group, dim
        return _all_gather(w, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.group, ctx.dim), None, None


def _model_group():
    mesh = current_mesh()
    return None if mesh is None else mesh.group(AXES.model)


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    group = _model_group()
    return x if group is None else _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor) -> torch.Tensor:
    group = _model_group()
    return x if group is None else _ReduceFromModel.apply(x, group)


def gather_last(x: torch.Tensor) -> torch.Tensor:
    group = _model_group()
    return x if group is None else _GatherLast.apply(x, group)


def sum_over_model(t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` over the model group, outside autograd: a
    row-parallel W8A8 layer's int32 products (exact) or a W4A8 layer's fp32
    partials, before their epilogue."""
    group = _model_group()
    return t if group is None else _all_reduce(t, group)


def max_over_model(t: torch.Tensor) -> torch.Tensor:
    """The elementwise MAX of ``t`` over the model group, outside autograd:
    a row-parallel quantized layer's per-row absmax over its input slices."""
    group = _model_group()
    return t if group is None else _all_reduce(t, group, dist.ReduceOp.MAX)


def model_index() -> int:
    mesh = current_mesh()
    return 0 if mesh is None else mesh.index(AXES.model)



# ------------------------------------------------------------- leaf specs --

def sub(specs: Any, *keys) -> Any:
    """The subtree of a spec tree at ``keys`` (dict keys or list indices);
    None when ``specs`` is None (a whole tree) or holds no such key."""
    for k in keys:
        if specs is None:
            return None
        specs = specs.get(k) if isinstance(specs, dict) else specs[k]
    return specs


def model_dim(spec: Optional[Spec]) -> Optional[int]:
    """The dimension that ``spec`` shards on ``model``, or None."""
    return spec.index(AXES.model) if spec is not None and AXES.model in spec else None


def expect_whole(name: str, got, want, *args) -> None:
    """Raise when a leaf's local size ``got`` is not the config's ``want``:
    a forward given no specs takes its tree as whole. The leaf is named
    ``name.format(*args)``, built only then (the check runs every forward)."""
    if got != want:
        raise ValueError(f"{name.format(*args)} is {got} here and {want} in the config: a "
                         "sharded tree runs with its specs (specs=Sharding.tree(params))")


def gather_fsdp(t: torch.Tensor, spec: Optional[Spec] = None
                ) -> Tuple[torch.Tensor, Optional[Spec]]:
    """(``t`` whole along its ``fsdp`` dimension, the spec left: its
    ``model`` sharding or None): the all-gather at use, a reduce-scatter of
    its gradient. A leaf not sharded on fsdp comes back as it is."""
    if spec is None or AXES.fsdp not in spec:
        return t, spec
    group = current_mesh().group(AXES.fsdp)
    if group is not None:
        t = _GatherFsdp.apply(t, group, spec.index(AXES.fsdp))
    rest = tuple(None if a == AXES.fsdp else a for a in spec)
    return t, (rest if any(a is not None for a in rest) else None)


def gather_tree(tree: Dict, specs: Optional[Dict]) -> Tuple[Dict, Optional[Dict]]:
    """``gather_fsdp`` of every tensor of a dict of tensors and dicts (a
    layer's leaves, at the top of the layer: the remat recompute gathers
    them again in the backward) and the specs left, shaped alike."""
    if specs is None:
        return tree, None
    out, rest = {}, {}
    for k, v in tree.items():
        out[k], rest[k] = (gather_tree(v, specs.get(k)) if isinstance(v, dict)
                           else gather_fsdp(v, specs.get(k)))
    return out, rest


# ------------------------------------------------------------ the batch --

@contextlib.contextmanager
def batch_sharded(mesh: Optional[Mesh] = None):
    """The block runs on this rank's rows of the global batch: CE counts,
    means and metrics are reduced over the batch group (data, fsdp).
    ``mesh`` (a sharded state's; None for a whole one) is the current mesh
    in the block."""
    prev, prev_mesh = _BATCH[0], current_mesh()
    _BATCH[0] = True
    set_mesh(mesh)
    try:
        yield
    finally:
        _BATCH[0] = prev
        set_mesh(prev_mesh)


def batch_size() -> int:
    mesh = current_mesh()
    return mesh.size(*BATCH_AXES) if (_BATCH[0] and mesh is not None) else 1


def batch_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the batch group inside ``batch_sharded``, without
    a gradient (a denominator, a metric); else ``t``."""
    if batch_size() == 1:
        return t
    return all_reduce(t.detach(), *BATCH_AXES)


def batch_mean(t: torch.Tensor) -> torch.Tensor:
    """This rank's share of the global mean of the rows ``t`` [B_local, ...]:
    summed over the batch group it is the mean over the global batch."""
    return t.sum() / (t.numel() * batch_size())


def local_rows(x: torch.Tensor, accum: int = 1, dim: int = 0) -> torch.Tensor:
    """This rank's rows of the global ``x`` inside ``batch_sharded``: with
    ``accum`` micro-batches, its rows of each micro-batch, in order."""
    n = batch_size()
    if n == 1:
        return x
    i = current_mesh().index(*BATCH_AXES)
    b = x.shape[dim]
    if b % (n * accum):
        raise ValueError(f"{b} rows do not split over {n} batch ranks x {accum} micro-batches")
    x = x.movedim(dim, 0)
    k = b // (n * accum)
    y = x.reshape(accum, n, k, *x.shape[1:])[:, i].reshape(accum * k, *x.shape[1:])
    return y.movedim(0, dim)


def sync_grads(grads: Sequence[Optional[torch.Tensor]], specs: Optional[Sequence[Spec]]
               ) -> List[Optional[torch.Tensor]]:
    """Sum each rank's gradients over the batch group: a leaf sharded on
    ``fsdp`` was reduce-scattered over fsdp in the backward and is summed
    over ``data``; any other leaf over (data, fsdp). One flat all-reduce a
    group and dtype. ``specs`` None (a whole tree): the gradients as they are."""
    mesh = current_mesh()
    out = list(grads)
    if specs is None or mesh is None:
        return out
    buckets: Dict[Tuple[Tuple[str, ...], torch.dtype], List[int]] = {}
    for i, (g, spec) in enumerate(zip(grads, specs)):
        if g is None:
            continue
        axes = (AXES.data,) if AXES.fsdp in spec else BATCH_AXES
        if mesh.group(*axes) is not None:
            buckets.setdefault((axes, g.dtype), []).append(i)
    for (axes, _), idx in buckets.items():
        flat = _all_reduce(torch.cat([grads[i].reshape(-1) for i in idx]), mesh.group(*axes))
        for i, piece in zip(idx, flat.split([grads[i].numel() for i in idx])):
            out[i] = piece.view_as(grads[i])
    return out


def sum_over_shards(values: Iterable[torch.Tensor], specs: Iterable[Spec]) -> torch.Tensor:
    """Σ of per-leaf scalars, each leaf's summed over the axes it is sharded
    on (a replicated leaf counted once): a leaf-wise global total."""
    groups: Dict[Tuple[str, ...], List[torch.Tensor]] = {}
    for v, spec in zip(values, specs):
        groups.setdefault(tuple(a for a in spec if a is not None), []).append(v)
    total = None
    for axes, vs in groups.items():
        s = torch.stack(vs).sum()
        s = all_reduce(s, *axes) if axes else s
        total = s if total is None else total + s
    return total

