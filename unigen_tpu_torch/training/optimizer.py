"""AdamW with no-decay groups, lr multipliers and frozen parts.

Port of ``unigen_tpu/training/optimizer.py``. JAX builds one optax chain;
its order is kept here, leaf by leaf over the flat parameter list
(``named_leaves``), with ``torch._foreach_*`` updates in place:

1. ``clip_by_global_norm`` (over the trainable leaves, as under optax's
   ``multi_transform``): g / norm * max where the norm is not below max;
2. ``scale_by_adam``: bias-corrected moments, eps outside the square root;
3. ``add_decayed_weights`` on the decay mask;
4. the lr multipliers (``lr_mapper``);
5. ``-lr * schedule(count)``, count = updates before this one;
6. frozen leaves (``tunable_parts``) get a zero update and no moments.

``torch.optim.AdamW`` is not used: its decoupled decay multiplies the
parameter before the Adam step and is not scaled like optax's, so it does
not give the chain above. Moments are kept in the parameters' dtype, as
optax keeps them; the update count and the schedule stay on the device.
The decay, freeze and multiplier patterns match the JAX tree's paths of
the leaves (``weights.jax_leaf_path``), so a pattern means what it means
there. One difference: the global norm (clip and metric) is summed in fp32
for every leaf dtype; optax sums a bf16 tree in bf16.

On a sharded tree (``parallel/``) the moments are the shards' and the
update is elementwise on them; only the global norm (clip and metric)
reduces, each leaf's partial sum over the axes it is sharded on.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Iterator, List, NamedTuple, Optional, Sequence, Tuple

import torch

from ..parallel.collectives import sum_over_shards
from ..weights import jax_leaf_path

NO_DECAY_PATTERNS = ("bias", "ln/scale", "final_ln", "embed/weight", "pos_embed",
                     # LoRA leaves never decay (the JAX package's list)
                     "lora_")


def named_leaves(tree: Any, prefix: str = "") -> Iterator[Tuple[str, torch.Tensor]]:
    """(``/``-joined path, tensor) of a parameter tree: dict keys sorted,
    list entries in order (JAX's flattening order)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from named_leaves(tree[k], f"{prefix}/{k}" if prefix else str(k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from named_leaves(v, f"{prefix}/{i}" if prefix else str(i))
    elif tree is not None:
        yield prefix, tree


def decay_mask(params: Any) -> Dict[str, bool]:
    """{port path: True where weight decay applies}."""
    return {p: not any(pat in jax_leaf_path(p) for pat in NO_DECAY_PATTERNS)
            for p, _ in named_leaves(params)}


def trainable_mask(params: Any, tunable_parts: Optional[Sequence[str]]) -> Dict[str, bool]:
    """{port path: True where the leaf trains}: all without ``tunable_parts``,
    else the leaves whose JAX path holds one of them."""
    return {p: not tunable_parts or any(tp in jax_leaf_path(p) for tp in tunable_parts)
            for p, _ in named_leaves(params)}


def lr_multiplier_mask(params: Any, lr_mapper: Dict[str, float]) -> Dict[str, float]:
    """{port path: the multiplier of the first ``lr_mapper`` key in its JAX
    path, else 1.0}."""
    def mult(path):
        return next((m for key, m in lr_mapper.items() if key in path), 1.0)
    return {p: mult(jax_leaf_path(p)) for p, _ in named_leaves(params)}


def global_norm(tensors: Sequence[torch.Tensor],
                specs: Optional[Sequence[Tuple]] = None) -> torch.Tensor:
    """sqrt of the sum of squares over all tensors, in fp32, on the device.
    With ``specs`` (one a tensor: the leaves of a sharded tree) each local
    shard's sum of squares is summed over the mesh axes its leaf is sharded
    on, a replicated leaf counted once: the whole tree's norm on every rank."""
    if specs is None:
        norms = [torch.linalg.vector_norm(t, dtype=torch.float32) for t in tensors]
        return torch.linalg.vector_norm(torch.stack(norms))
    squares = [torch.linalg.vector_norm(t, dtype=torch.float32) ** 2 for t in tensors]
    return torch.sqrt(sum_over_shards(squares, specs))


class OptState(NamedTuple):
    mu: List[torch.Tensor]      # first moments of the trainable leaves
    nu: List[torch.Tensor]      # second moments
    count: torch.Tensor         # int32 []: updates applied


@dataclasses.dataclass
class AdamW:
    """The update of ``make_optimizer``; flags and multipliers by leaf, in
    ``named_leaves`` order."""
    learning_rate: float
    schedule: Callable
    beta1: float
    beta2: float
    epsilon: float
    weight_decay: float
    max_grad_norm: Optional[float]
    decay: List[bool]
    trainable: List[bool]
    multiplier: List[float]

    def init(self, leaves: Sequence[torch.Tensor]) -> OptState:
        kept = [t for t, train in zip(leaves, self.trainable) if train]
        return OptState([torch.zeros_like(t) for t in kept], [torch.zeros_like(t) for t in kept],
                        torch.zeros((), dtype=torch.int32, device=leaves[0].device))

    @torch.no_grad()
    def update(self, grads: Sequence[torch.Tensor], state: OptState,
               leaves: Sequence[torch.Tensor],
               specs: Optional[Sequence[Tuple]] = None) -> OptState:
        """Applies one update to ``leaves`` in place; returns the new state
        (its moments are the old ones, updated in place). ``specs``: the
        leaves' specs when they are local shards (the clip's norm is the
        whole tree's; the rest is elementwise on the shards)."""
        idx = [i for i, train in enumerate(self.trainable) if train]
        g = [grads[i] for i in idx]
        if self.max_grad_norm is not None:
            norm = global_norm(g, None if specs is None else [specs[i] for i in idx])
            keep = norm < self.max_grad_norm
            g = [torch.where(keep, x, x / norm.to(x.dtype) * self.max_grad_norm) for x in g]
        count = state.count + 1
        b1, b2 = self.beta1, self.beta2
        torch._foreach_mul_(state.mu, b1)
        torch._foreach_add_(state.mu, g, alpha=1 - b1)
        torch._foreach_mul_(state.nu, b2)
        torch._foreach_addcmul_(state.nu, g, g, value=1 - b2)
        cf = count.to(torch.float32)
        bc1, bc2 = 1 - torch.pow(b1, cf), 1 - torch.pow(b2, cf)
        step_size = -self.learning_rate * self.schedule(state.count)
        by_dtype: Dict[torch.dtype, List[int]] = {}
        for j, i in enumerate(idx):
            by_dtype.setdefault(leaves[i].dtype, []).append(j)
        for dtype, js in by_dtype.items():
            mu_hat = torch._foreach_div([state.mu[j] for j in js], bc1.to(dtype))
            denom = torch._foreach_sqrt(torch._foreach_div([state.nu[j] for j in js],
                                                           bc2.to(dtype)))
            torch._foreach_add_(denom, self.epsilon)
            upd = torch._foreach_div(mu_hat, denom)
            decayed = [k for k, j in enumerate(js) if self.decay[idx[j]]]
            if self.weight_decay and decayed:
                torch._foreach_add_([upd[k] for k in decayed],
                                    [leaves[idx[js[k]]] for k in decayed],
                                    alpha=self.weight_decay)
            for k, j in enumerate(js):
                if self.multiplier[idx[j]] != 1.0:
                    upd[k].mul_(self.multiplier[idx[j]])
            torch._foreach_mul_(upd, step_size.to(dtype))
            torch._foreach_add_([leaves[idx[j]] for j in js], upd)
        return OptState(state.mu, state.nu, count)


def make_optimizer(
    params: Any,
    learning_rate: float,
    lr_schedule: Callable,
    *,
    beta1: float = 0.9,
    beta2: float = 0.999,
    epsilon: float = 1e-8,
    weight_decay: float = 0.01,
    max_grad_norm: Optional[float] = None,
    tunable_parts: Optional[Sequence[str]] = None,
    lr_mapper: Optional[Dict[str, float]] = None,
) -> AdamW:
    """AdamW + schedule + clipping + freezing over ``params``' leaves."""
    paths = [p for p, _ in named_leaves(params)]
    decay, train = decay_mask(params), trainable_mask(params, tunable_parts)
    mult = lr_multiplier_mask(params, lr_mapper) if lr_mapper else dict.fromkeys(paths, 1.0)
    return AdamW(float(learning_rate), lr_schedule, beta1, beta2, epsilon, weight_decay,
                 max_grad_norm, [decay[p] for p in paths], [train[p] for p in paths],
                 [mult[p] for p in paths])
