"""LoRA / QLoRA adapters for the Qwen2 backbone.

Port of ``unigen_tpu/training/lora.py`` (lines 38-136). JAX keeps the
adapters as extra leaves inside each stacked dense node (``lora_a [L, in,
r]``, ``lora_b [L, r, out]``, ``lora_scale [L]``). The port's layers are one
dict each, so the adapters are per-layer leaves beside the projection they
adapt:

    <name>_lora_a [in, r], <name>_lora_b [r, out], <name>_lora_scale [] fp32

(``name`` one of q, k, v, o, gate, up, down; a and b in JAX's per-layer
layout, not transposed). ``models.qwen2`` adds ``((x @ a) @ b) * scale`` in
x's dtype after the base projection, float, W8A8 or W4A8 alike (QLoRA: the
quantized base rides the forward; its backward is refused).
``weights.jax_leaf_path`` maps the leaves to JAX's ``.../lora_a`` paths, so
``optimizer.trainable_mask(params, lora_tunable_parts())`` trains a and b
only and ``decay_mask`` never decays them, as JAX's optimizer does; and
``weights.unigen_to_jax`` / ``unigen_from_jax`` carry them both ways.

Under tensor parallelism (``parallel/partition.py``) a column projection's
b is sharded on ``out`` with its base and a stays whole; a row projection's
a is sharded on ``in`` and b stays whole (``models/qwen2.py`` reduces the
[*, r] partial over ``model`` before ``@ b``). The steps train the shards.

Standard LoRA semantics: ``a`` Gaussian (std in^-1/2), ``b`` zero (the
adapted model equals the base at step 0), effective weight ``W + (alpha /
r) a b``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import torch

# every dense family in a Qwen2 layer, JAX's names
DEFAULT_TARGETS: Tuple[str, ...] = (
    "attn/q", "attn/k", "attn/v", "attn/o", "mlp/gate", "mlp/up", "mlp/down")


def target_name(target: str) -> str:
    """JAX's ``attn/q`` -> the port's projection name ``q``."""
    if target not in DEFAULT_TARGETS:
        raise ValueError(f"unknown LoRA target {target!r}; targets are {DEFAULT_TARGETS}")
    return target.split("/")[1]


def dense_dims(lp: Dict[str, Any], name: str) -> Tuple[int, int]:
    """(in, out) of projection ``name`` of a layer: float ``<name>_w [out,
    in]``, W8A8 ``{kernel_int8 [Npad, in], scale [out]}`` or W4A8
    ``{kernel_int4 [in / 2, Npad], bias [out]}``."""
    if f"{name}_w" in lp:
        out, d_in = lp[f"{name}_w"].shape
        return d_in, out
    leaf = lp[name]
    if "kernel_int8" in leaf:
        return leaf["kernel_int8"].shape[1], leaf["scale"].shape[0]
    return 2 * leaf["kernel_int4"].shape[0], leaf["bias"].shape[0]


def add_lora(llm_params: Dict, generator: Optional[torch.Generator], rank: int, *,
             alpha: Optional[float] = None, targets: Sequence[str] = DEFAULT_TARGETS,
             dtype: torch.dtype = torch.bfloat16) -> Dict:
    """A new Qwen2 tree with zero-effect adapters on ``targets`` of every
    layer (the input tree and its layer dicts are not changed). ``alpha``
    defaults to ``rank`` (scale 1). Each target's a is drawn [L, in, r] at
    once from ``generator``, targets in order, on the layers' device."""
    if rank <= 0:
        raise ValueError(f"LoRA rank must be positive, got {rank}")
    scale = (alpha if alpha is not None else float(rank)) / float(rank)
    layers = [dict(lp) for lp in llm_params["layers"]]
    for tgt in targets:
        name = target_name(tgt)
        d_in, d_out = dense_dims(layers[0], name)
        dev = next(v for v in layers[0].values() if isinstance(v, torch.Tensor)).device
        a = torch.randn((len(layers), d_in, rank), generator=generator, device=dev,
                        dtype=torch.float32) * (d_in ** -0.5)
        for i, lp in enumerate(layers):
            lp[f"{name}_lora_a"] = a[i].to(dtype)
            lp[f"{name}_lora_b"] = torch.zeros((rank, d_out), dtype=dtype, device=dev)
            lp[f"{name}_lora_scale"] = torch.full((), scale, dtype=torch.float32, device=dev)
    return dict(llm_params, layers=layers)


def is_lora_leaf(key: str) -> bool:
    return "_lora_" in key


def strip_lora(llm_params: Dict) -> Dict:
    """The tree without its adapter leaves (the frozen base)."""
    return dict(llm_params, layers=[{k: v for k, v in lp.items() if not is_lora_leaf(k)}
                                    for lp in llm_params["layers"]])


def lora_names(lp: Dict) -> Tuple[str, ...]:
    """The projections of layer ``lp`` that carry adapters."""
    return tuple(k[:-len("_lora_a")] for k in lp if k.endswith("_lora_a"))


@torch.no_grad()
def merge_lora(llm_params: Dict) -> Dict:
    """Fold ``W += scale * (a @ b)`` (in fp32, cast back to W's dtype) and
    strip the adapters: a plain base tree. An int8 or int4 base cannot be
    merged (the fold would change its quantization grid): merge the float
    tree first, then quantize."""
    layers = []
    for lp in llm_params["layers"]:
        out = {k: v for k, v in lp.items() if not is_lora_leaf(k)}
        for name in lora_names(lp):
            if f"{name}_w" not in lp:
                raise ValueError(f"merge_lora on a quantized {name}: merge before quantizing "
                                 "(or keep the adapters on the runtime path)")
            delta = (lp[f"{name}_lora_a"].float() @ lp[f"{name}_lora_b"].float()) \
                * lp[f"{name}_lora_scale"].float()                          # [in, out]
            w = lp[f"{name}_w"]
            out[f"{name}_w"] = (w.float() + delta.t()).to(w.dtype)
        layers.append(out)
    return dict(llm_params, layers=layers)


def lora_tunable_parts() -> Tuple[str, ...]:
    """The ``tunable_parts`` that train the low-rank factors only; the scale
    (the fixed alpha / r) stays frozen."""
    return ("lora_a", "lora_b")


def lora_param_count(llm_params: Dict) -> int:
    return sum(v.numel() for lp in llm_params["layers"] for k, v in lp.items()
               if is_lora_leaf(k))
