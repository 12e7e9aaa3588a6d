"""Qwen2.5 causal-LM backbone.

Port of ``unigen_tpu/models/qwen2.py``: q/k/v projections with biases, o_proj
without; SwiGLU MLP; NeoX rotary embedding and RMSNorm in fp32 inside a
``cfg.dtype`` compute stream. Parameters are a plain dict of tensors with one
dict per layer and linear weights in PyTorch's [out, in] layout
(``weights.py`` converts the JAX tree).

Attention routing: a call with ``meta_bits`` (cache-free, or the prefill that
fills an empty cache) goes to ``ops.flash_attention``; a cached chunk with
``kv_rowmask`` goes to ``ops.chunk_attention``; anything else goes to the
plain ``ops.attention.dot_product_attention``. Each kernel wrapper launches
its CUDA kernel on a GPU tensor and runs its plain version on a CPU tensor.

Without a mask, ``forward`` builds JAX's defaults: causal without a cache
(all-zero ``meta_bits``, so the flash kernel); with a cache, key ``s`` is
visible to query ``j`` of row ``b`` when ``s <= index[b] + j``. A one-token
step passes that as the [B, S] ``kv_rowmask`` (the chunk kernel); a longer
chunk (the serving engine's speculative verify step and its shared-prefix
suffix) as an all-true ``kv_rowmask`` with the chunk kernel's per-row causal
offset ``q_start = index``; with the int8 cache, as the dense [B, 1, l, S]
mask.

``KVCache.index`` is a Python int (every row at one position) or, from
``init_kv_cache(per_row_index=True)``, a [B] int32 tensor on the cache's
device: each row writes its chunk at its own position, positions default to
``index[:, None] + arange(l)``, and ``forward`` returns ``index + l``. The
per-row write is a gather and a scatter over [B, l] slots (``row_slots``,
computed once a forward); nothing of it is read back to the host.

The int8 KV cache (``init_kv_cache(quantize=True)``) stores K/V int8 with
per-(slot, head) fp32 scales, quantized at write time as JAX's
``_kv_quantize``. Two routes differ from JAX, which reads it through
``dot_product_attention_q8`` with a dense mask everywhere (and refuses
``kv_rowmask``): the prefill (``meta_bits``) quantizes and writes its chunk,
then runs ``ops.flash_attention`` on that chunk's dequantized K/V, so it
attends to what the cache holds; a cached chunk with ``kv_rowmask`` (the
decode step) runs the plain ``ops.attention.dot_product_attention_q8`` with
it as the key mask, never the bf16 chunk kernel on a dequantized copy.

Training: ``forward`` records autograd when grad mode is on and a leaf
requires grad (the inference callers run under ``torch.no_grad``), the
cache-free path writes nothing in place, and ``remat=True`` wraps each
layer in ``torch.utils.checkpoint`` (non-reentrant), JAX's ``remat``: a
layer's activations are recomputed in the backward, its flash launch
included.

Dense projections are ``torch`` matmuls, as the JAX package leaves them to
XLA, except in a quantized tree: a layer holds ``<name>: {'kernel_int8',
'scale', 'bias'?}`` (W8A8, ``ops.quantization.quantize_unigen_params``) or
``<name>: {'kernel_int4', 'scale4', 'bias'}`` (W4A8,
``ops.int4.quantize_unigen_params_int4``) in place of ``<name>_w`` /
``<name>_b``, and the projection goes through ``dense_int8`` or
``dense_int4`` (q/k/v share one activation quantization, and so do
gate/up).

LoRA (``training/lora.py``): a layer may hold ``<name>_lora_a [in, r]``,
``<name>_lora_b [r, out]`` and ``<name>_lora_scale []`` beside a projection;
``((x @ a) @ b) * scale`` in x's dtype is added after the base projection,
float or quantized, as JAX's ``_lora_delta`` (qwen2.py:271-277) does. Over a
W8A8 or W4A8 base (QLoRA) the adapters ride the forward, but a backward
through the quantized product raises ``NotImplementedError``: JAX's
autodiff differentiates through its ``round`` (zero) and ``act_scale``, and
matching that is open (ROADMAP Queue 1 item 17).

Tensor and ZeRO-3 parallelism (``parallel/``): a sharded tree runs with
its spec tree (``specs=``, ``parallel.Sharding.tree``: shaped like the
params, each leaf its spec or None), which every function here takes
beside the params and reads. Under column-sharded q/k/v the rank computes its own heads (local
heads = local q rows / ``head_dim``): the hidden states enter through
``copy_to_model``, kernels 1 and 2 run unchanged on the local heads, and o
and down leave through ``reduce_from_model``, a row-parallel bias added
after the reduce. Replicated k/v under sharded q (the KV heads do not
divide over ``model``) are taken whole and sliced to the rank's query
group's KV heads (``kv_heads_of_rank``). A vocab-sharded ``embed`` is a
masked lookup plus the reduce; the text head's logits are gathered over
the vocabulary (``project``). Leaves sharded on ``fsdp`` are gathered at
use: a layer's at the top of ``_layer``, so that ``remat`` gathers them
again in the backward. RMSNorm, RoPE and the residual stream stay
replicated. The KV cache holds the local KV heads (``local_kv_heads``),
int8 or not. Without specs the tree must be whole: ``forward`` and
``logits`` check the local shapes against the config (layer 0's
projections and norms, ``final_ln``, the embedding; the head) and raise a
``ValueError`` naming the leaf, where a sharded tree would otherwise fail
on a reshape or return a rank's partial sum.

Quantized and LoRA layers under tensor parallelism (``parallel/partition``
lays their leaves out): a column-split W8A8 / W4A8 q/k/v or gate/up runs
on the whole input, quantized once as on one rank, and gives the rank's
output columns exactly. A row-split o / down quantizes the rank's input
slice with the rows' global absmax (MAX over ``model``), so that its int8
values are one rank's, and sums the products over ``model`` before one
epilogue: W8A8 sums int32 (bit for bit one rank's), W4A8 sums kernel 4's
fp32 partials. A column projection's adapter a is whole, under
``copy_to_model``; a row projection's partial ``x_local @ a_local`` is
summed over ``model`` before ``@ b``, and the delta is added to the reduced
output. Quantized heads split on their codes or vocabulary are gathered as
the float heads' logits are.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, NamedTuple, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops.attention import dot_product_attention, dot_product_attention_q8
from ..parallel import collectives as C
from ..ops.chunk_attention import chunk_attention
from ..ops.flash_attention import flash_attention
from ..ops.int4 import dense_int4, dense_int4_prequant, dense_int4_row, is_quantized_int4
from ..ops.quantization import (dense_int8, dense_int8_prequant, dense_int8_row, int8_leaf,
                                is_quantized, quantize_activations)
from ..utils.persistence import take


@dataclasses.dataclass(frozen=True)
class Qwen2Config:
    vocab_size: int = 151936
    hidden_size: int = 1536
    intermediate_size: int = 8960
    num_hidden_layers: int = 28
    num_attention_heads: int = 12
    num_key_value_heads: int = 2
    head_dim: int = 128
    max_position_embeddings: int = 32768
    rms_norm_eps: float = 1e-6
    rope_theta: float = 1e6
    rope_scaling_factor: float = 1.0
    rope_type: str = "linear"
    tie_word_embeddings: bool = True
    dtype: Any = torch.bfloat16
    # JAX's cache storage order; its "skbd" and "bhsd" are TPU memory layouts,
    # and the port's attention kernels read "bskd" only
    kv_layout: str = "bskd"

    @classmethod
    def tiny(cls, vocab_size: int = 512, **kw) -> "Qwen2Config":
        """Small config for tests (the JAX package's ``Qwen2Config.tiny``)."""
        defaults = dict(vocab_size=vocab_size, hidden_size=64, intermediate_size=128,
                        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                        head_dim=16, rope_theta=1e4, dtype=torch.float32)
        defaults.update(kw)
        return cls(**defaults)


class KVCache(NamedTuple):
    """Layer-stacked bskd cache: k, v [num_layers, B, max_len, KVH, Dh].

    ``index`` is the number of positions written: an int (all rows alike)
    or a [B] int32 tensor (one a row). The buffers are updated in place;
    ``forward`` returns a cache whose index has advanced past the chunk it
    wrote. An int8 cache holds k, v in int8 and their per-(slot, head)
    scales k_scale, v_scale [num_layers, B, max_len, KVH] fp32.
    """
    k: torch.Tensor
    v: torch.Tensor
    index: Union[int, torch.Tensor]
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None


def init_kv_cache(cfg: Qwen2Config, batch_size: int, max_len: int,
                  device: torch.device, dtype=None, quantize: bool = False,
                  per_row_index: bool = False,
                  num_kv_heads: Optional[int] = None) -> KVCache:
    """``num_kv_heads``: the KV heads a rank holds under tensor parallelism
    (``local_kv_heads``); all of them by default."""
    if cfg.kv_layout != "bskd":
        raise NotImplementedError(
            f"kv_layout {cfg.kv_layout!r}: the port's cache is bskd only (ROADMAP, "
            "'Deliberate differences')")
    shape = (cfg.num_hidden_layers, batch_size, max_len,
             num_kv_heads or cfg.num_key_value_heads, cfg.head_dim)
    index = (torch.zeros((batch_size,), dtype=torch.int32, device=device)
             if per_row_index else 0)
    if quantize:
        return KVCache(torch.zeros(shape, dtype=torch.int8, device=device),
                       torch.zeros(shape, dtype=torch.int8, device=device), index,
                       torch.zeros(shape[:-1], dtype=torch.float32, device=device),
                       torch.zeros(shape[:-1], dtype=torch.float32, device=device))
    dtype = dtype or cfg.dtype
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device), index)


class RowSlots(NamedTuple):
    """Where a chunk of l tokens goes under a [B] index: row b's token j to
    slot ``slot[b, j]``; ``keep`` is False for a slot past the cache, which
    is dropped, as JAX's per-row select drops it. ``forward`` computes it
    once for all layers."""
    rows: torch.Tensor   # [B, l] int64
    slot: torch.Tensor   # [B, l] int64
    keep: torch.Tensor   # [B, l] bool


def row_slots(index: torch.Tensor, l: int, s: int) -> RowSlots:
    """A dropped slot p >= S is sent to p - l instead: a slot below the row's
    index that no other write of the call touches, which gets its old value
    back (l <= S)."""
    pos = index.long().clamp(0, s)[:, None] + torch.arange(l, device=index.device)
    keep = pos < s
    slot = torch.where(keep, pos, pos - l)
    rows = torch.arange(index.shape[0], device=index.device)[:, None].expand_as(slot)
    return RowSlots(rows, slot, keep)


def _cache_write(buf: torch.Tensor, upd: torch.Tensor, li: int,
                 where: Union[int, RowSlots]) -> None:
    """Write the chunk [B, l, ...] into layer ``li`` in place.

    At an int index: one slice, its start clamped so the chunk fits, as JAX's
    dynamic_update_slice does. At ``RowSlots`` (a [B] index): one gather of
    the old values and one scatter of [B, l] slots, the dropped ones getting
    their old values back."""
    if not isinstance(where, RowSlots):
        s, l = buf.shape[2], upd.shape[1]
        start = min(max(where, 0), s - l)
        buf[li, :, start:start + l] = upd.to(buf.dtype)
        return
    layer = buf[li]
    keep = where.keep.view(where.keep.shape + (1,) * (upd.dim() - 2))
    layer[where.rows, where.slot] = torch.where(keep, upd.to(buf.dtype),
                                                layer[where.rows, where.slot])


def _kv_quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B, L, KVH, Dh] -> (int8 values, [B, L, KVH] fp32 scales), JAX's
    order: ``max(|x|)`` floored at 1e-8, then divided by 127 (a tensor on x's
    device, for IEEE division on the card)."""
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(dim=-1), min=1e-8) / torch.full((), 127.0,
                                                                      device=x.device)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127).to(torch.int8)
    return q, scale


def _kv_dequantize(q: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    return (q.float() * scale[..., None].float()).to(dtype)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    xf = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (xf * scale.float()).to(x.dtype)


def rope_tables(positions: torch.Tensor, dh: int, theta: float,
                scaling_factor: float = 1.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin), each [B, L, 1, Dh/2] fp32, for ``apply_rope``. ``forward``
    builds them once for all layers."""
    inv_freq = 1.0 / (theta ** (torch.arange(0, dh, 2, dtype=torch.float32,
                                             device=positions.device) / dh))
    pos = positions.float()
    if scaling_factor != 1.0:
        pos = pos / scaling_factor
    freqs = pos[..., None] * inv_freq
    return torch.cos(freqs)[:, :, None, :], torch.sin(freqs)[:, :, None, :]


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """NeoX rotate-half rotation in fp32; x: [B, L, H, Dh]."""
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
         scaling_factor: float = 1.0) -> torch.Tensor:
    """Rotary embedding, NeoX rotate-half convention, in fp32.

    x: [B, L, H, Dh]; positions: [B, L] int.
    """
    return apply_rope(x, *rope_tables(positions, x.shape[-1], theta, scaling_factor))


_QUANT_LEAF_SIZE = 3   # {kernel_int8, scale, bias?} or {kernel_int4, scale4, bias}
LORA_SUFFIXES = ("lora_a", "lora_b", "lora_scale")   # a layer's <name>_lora_* leaves


def _check_leaf(p: Dict, name: str) -> None:
    """Raise on leaves the port does not compute: a projection that is
    neither ``<name>_w`` nor a W8A8 / W4A8 leaf, a quantized leaf with more
    in it (JAX's layout puts adapters inside the node; the port's beside
    it), or adapters without all three of their leaves."""
    leaf = p.get(name)
    quantized = is_quantized(leaf) or is_quantized_int4(leaf)
    if isinstance(leaf, dict) and (not quantized or len(leaf) > _QUANT_LEAF_SIZE):
        raise NotImplementedError(
            f"{name}: leaves {sorted(leaf)}; the port computes float, W8A8 (kernel_int8) and "
            f"W4A8 (kernel_int4) projections, with adapters as {name}_lora_* leaves of the layer")
    if f"{name}_w" not in p and not quantized:
        raise KeyError(f"layer has neither {name}_w nor a quantized {name}")
    if f"{name}_lora_a" in p and not all(f"{name}_{s}" in p for s in LORA_SUFFIXES):
        raise KeyError(f"{name}: LoRA needs {', '.join(f'{name}_{s}' for s in LORA_SUFFIXES)}")


class _RefuseQuantizedBackward(torch.autograd.Function):
    """The identity on a W8A8 / W4A8 product whose backward would be taken;
    that backward raises instead of returning gradients through the int8
    rounding (which autograd would drop, leaving the act_scale path only)."""

    @staticmethod
    def forward(ctx, y, x):
        return y.clone()

    @staticmethod
    def backward(ctx, grad):
        raise NotImplementedError(
            "the backward through a W8A8 / W4A8 projection (QLoRA training) is not ported "
            "(ROADMAP Queue 1 item 17); train LoRA over a float base")


def _quantized_out(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    if torch.is_grad_enabled() and x.requires_grad:
        return _RefuseQuantizedBackward.apply(y, x)
    return y


def _lora(p: Dict, name: str, x: torch.Tensor, y: torch.Tensor,
          column: bool = False) -> torch.Tensor:
    """``y`` plus the low-rank path of projection ``name`` when the layer
    holds one: ``((x @ a) @ b) * scale`` in x's dtype. Under a column-split
    base (``column``) a and scale are whole and b the rank's columns: their
    gradients are summed over ``model``."""
    a = p.get(f"{name}_lora_a")
    if a is None:
        return y
    scale = p[f"{name}_lora_scale"]
    if column:
        a, scale = C.copy_to_model(a), C.copy_to_model(scale)
    d = (x @ a.to(x.dtype)) @ p[f"{name}_lora_b"].to(x.dtype)
    return y + d * scale.to(x.dtype)


def _dense(p: Dict, name: str, x: torch.Tensor) -> torch.Tensor:
    """The projection ``name`` of layer ``p``: W8A8 or W4A8 when it holds
    ``kernel_int8`` or ``kernel_int4``, else ``F.linear`` with ``<name>_w``
    and ``<name>_b``; plus its adapters."""
    _check_leaf(p, name)
    leaf = p.get(name)
    if is_quantized(leaf):
        y = _quantized_out(dense_int8(leaf, x), x)
    elif is_quantized_int4(leaf):
        y = _quantized_out(dense_int4(leaf, x), x)
    else:
        y = F.linear(x, p[f"{name}_w"], p.get(f"{name}_b"))
    return _lora(p, name, x, y)


def _dense_shared(p: Dict, names: Tuple[str, ...], x: torch.Tensor, sp: Optional[Dict]):
    """Projections of one input: in a quantized layer the input is quantized
    once for all of them, as the JAX package does."""
    for name in names:
        _check_leaf(p, name)
    first = p.get(names[0])
    if is_quantized(first) or is_quantized_int4(first):
        x8, xs = quantize_activations(x)
        ys = [_quantized_out((dense_int8_prequant if is_quantized(p[n]) else dense_int4_prequant)(
            p[n], x8, xs, x.dtype), x) for n in names]
    else:
        ys = [F.linear(x, p[f"{n}_w"], p.get(f"{n}_b")) for n in names]
    return [_lora(p, n, x, y, _split(p, n, sp) == "column") for n, y in zip(names, ys)]


def _node_spec(node: Optional[Dict]):
    """The spec of a W8A8 / W4A8 node's ``kernel_int8`` or ``kernel_int4``
    (None: the node is whole)."""
    if node is None:
        return None
    return node["kernel_int8"] if "kernel_int8" in node else node.get("kernel_int4")


def _weight_spec(p: Dict, name: str, sp: Optional[Dict]):
    """The spec that says how projection ``name`` is split: ``<name>_w``'s,
    or its node's weight's."""
    if isinstance(p.get(name), dict):
        return _node_spec(C.sub(sp, name))
    return C.sub(sp, f"{name}_w")


def _split(p: Dict, name: str, sp: Optional[Dict]) -> Optional[str]:
    """"column" or "row" when projection ``name`` is split on ``model``
    (a W4A8 node's packed weight is [K/2, N], the others [N, K]), else None."""
    d = C.model_dim(_weight_spec(p, name, sp))
    if d is None:
        return None
    return "column" if (d == 1) == is_quantized_int4(p.get(name)) else "row"


def _out_features(p: Dict, name: str) -> int:
    """Projection ``name``'s (local) output features, without padding."""
    leaf = p.get(name)
    if is_quantized(leaf):
        return leaf["scale"].shape[0]
    if is_quantized_int4(leaf):
        return leaf["bias"].shape[0]
    return p[f"{name}_w"].shape[0]


def _in_features(p: Dict, name: str) -> int:
    """Projection ``name``'s (local) input features."""
    leaf = p.get(name)
    if is_quantized(leaf):
        return leaf["kernel_int8"].shape[1]
    if is_quantized_int4(leaf):
        return 2 * leaf["kernel_int4"].shape[0]
    return p[f"{name}_w"].shape[1]


def _check_whole(params: Dict, cfg: Qwen2Config) -> None:
    """Without specs the tree must be whole: layer 0's projections (output
    and input features) and norms, ``final_ln`` and the embedding, against
    the config."""
    d, hd = cfg.hidden_size, cfg.num_attention_heads * cfg.head_dim
    kv, inter = cfg.num_key_value_heads * cfg.head_dim, cfg.intermediate_size
    lp = params["layers"][0]
    for name, (n_out, n_in) in (("q", (hd, d)), ("k", (kv, d)), ("v", (kv, d)), ("o", (d, hd)),
                                ("gate", (inter, d)), ("up", (inter, d)), ("down", (d, inter))):
        w = "" if isinstance(lp.get(name), dict) else "_w"
        C.expect_whole("layers/0/{}{}'s output features", _out_features(lp, name), n_out, name, w)
        C.expect_whole("layers/0/{}{}'s input features", _in_features(lp, name), n_in, name, w)
    for name in ("input_ln", "post_ln"):
        C.expect_whole("layers/0/{}'s size", lp[name].numel(), d, name)
    C.expect_whole("final_ln's size", params["final_ln"].numel(), d)
    _check_table(params, cfg, "embed")


def _check_table(params: Dict, cfg: Qwen2Config, name: str) -> None:
    """An embedding or head [V, D], or a quantized head's rows, whole."""
    leaf = params[name]
    if isinstance(leaf, dict):
        C.expect_whole("{}'s rows", _out_features(params, name), cfg.vocab_size, name)
        return
    C.expect_whole("{}'s shape", tuple(leaf.shape), (cfg.vocab_size, cfg.hidden_size), name)


def kv_heads_of_rank(h: int, kvh: int, h_loc: int, r: int) -> Union[slice, List[int]]:
    """The KV heads that model rank ``r``'s query heads r*h_loc .. read: a
    slice when they are a contiguous GQA group of the local heads, else one
    KV head a query head (a list)."""
    g = h // kvh
    idx = [(r * h_loc + i) // g for i in range(h_loc)]
    n = idx[-1] + 1 - idx[0]
    if h_loc % n == 0 and all(j - idx[0] == i // (h_loc // n) for i, j in enumerate(idx)):
        return slice(idx[0], idx[-1] + 1)
    return idx


def _tp_heads(p: Dict, cfg: Qwen2Config, sp: Optional[Dict]):
    """(local query heads, KV heads to take from a whole k/v or None) of a
    layer under its specs ``sp``; (all heads, None) without tensor
    parallelism."""
    h, dh = cfg.num_attention_heads, cfg.head_dim
    if _split(p, "q", sp) is None:
        return h, None
    h_loc = _out_features(p, "q") // dh
    if _split(p, "k", sp) is not None:
        return h_loc, None
    return h_loc, kv_heads_of_rank(h, cfg.num_key_value_heads, h_loc, C.model_index())


def local_kv_heads(params: Dict, cfg: Qwen2Config, specs: Optional[Dict] = None) -> int:
    """The KV heads this rank's cache holds under ``specs`` (all of them on
    a whole tree)."""
    h_loc, sel = _tp_heads(params["layers"][0], cfg, C.sub(specs, "layers", 0))
    if sel is None:
        return cfg.num_key_value_heads * h_loc // cfg.num_attention_heads
    return sel.stop - sel.start if isinstance(sel, slice) else len(sel)


def _dense_row(p: Dict, name: str, x: torch.Tensor, tp: bool) -> torch.Tensor:
    """A row-parallel product: the local partial sums reduced over
    ``model``, the bias added once after the reduce (a quantized node's
    product as the module docstring says); then the adapters, their [*, r]
    partial reduced before b."""
    if not tp:
        return _dense(p, name, x)
    _check_leaf(p, name)
    leaf = p.get(name)
    if is_quantized(leaf) or is_quantized_int4(leaf):
        row = dense_int8_row if is_quantized(leaf) else dense_int4_row
        y = _quantized_out(row(leaf, x, C.max_over_model, C.sum_over_model), x)
    else:
        y = C.reduce_from_model(F.linear(x, p[f"{name}_w"]))
        bias = p.get(f"{name}_b")
        y = y if bias is None else y + bias
    a = p.get(f"{name}_lora_a")
    if a is None:
        return y
    d = C.reduce_from_model(x @ a.to(x.dtype)) @ p[f"{name}_lora_b"].to(x.dtype)
    return y + d * p[f"{name}_lora_scale"].to(x.dtype)


def _attention_block(p: Dict, cfg: Qwen2Config, x: torch.Tensor,
                     mask: Optional[torch.Tensor],
                     cos_sin: Tuple[torch.Tensor, torch.Tensor],
                     cache: Optional[KVCache], li: int,
                     meta_bits: Optional[torch.Tensor],
                     kv_rowmask: Optional[torch.Tensor],
                     where: Union[int, RowSlots, None],
                     q_start: Optional[torch.Tensor], sp: Optional[Dict]) -> torch.Tensor:
    b, l, _ = x.shape
    dh = cfg.head_dim
    h, kv_sel = _tp_heads(p, cfg, sp)
    tp = h < cfg.num_attention_heads
    if tp:
        x = C.copy_to_model(x)
    if kv_sel is not None:
        # whole k/v, each rank on its own heads: their gradients are summed over model
        p = {**p, **{n: C.copy_to_model(p[n]) for n in _KV_WHOLE if n in p}}
    q, k, v = _dense_shared(p, ("q", "k", "v"), x, sp)
    q = q.view(b, l, h, dh)
    k = k.view(b, l, -1, dh)
    v = v.view(b, l, -1, dh)
    if kv_sel is not None:
        k, v = k[:, :, kv_sel], v[:, :, kv_sel]
    q = apply_rope(q, *cos_sin)
    k = apply_rope(k, *cos_sin)

    if cache is not None and cache.quantized:
        kq, ks = _kv_quantize(k)
        vq, vs = _kv_quantize(v)
        for buf, upd in ((cache.k, kq), (cache.v, vq), (cache.k_scale, ks), (cache.v_scale, vs)):
            _cache_write(buf, upd, li, where)
        if meta_bits is not None:
            # the prefill of an empty cache: the chunk's K/V as the cache holds them
            out = flash_attention(q, _kv_dequantize(kq, ks, q.dtype),
                                  _kv_dequantize(vq, vs, q.dtype), meta_bits)
        else:
            key_mask = mask if kv_rowmask is None else kv_rowmask[:, None, None, :]
            out = dot_product_attention_q8(q, cache.k[li], cache.k_scale[li], cache.v[li],
                                           cache.v_scale[li], mask=key_mask)
        return _dense_row(p, "o", out.reshape(b, l, h * dh), tp)
    if cache is not None:
        _cache_write(cache.k, k, li, where)
        _cache_write(cache.v, v, li, where)
    if meta_bits is not None:
        # cache-free self-attention, or the prefill of an empty cache
        out = flash_attention(q, k, v, meta_bits)
    elif cache is not None and kv_rowmask is not None:
        out = chunk_attention(q, cache.k[li], cache.v[li], kv_rowmask, q_start)
    elif cache is not None:
        out = dot_product_attention(q, cache.k[li].to(q.dtype), cache.v[li].to(q.dtype),
                                    mask=mask)
    else:
        out = dot_product_attention(q, k, v, mask=mask)
    return _dense_row(p, "o", out.reshape(b, l, h * dh), tp)


# a whole k/v's float leaves (a quantized node has no gradient)
_KV_WHOLE = ("k_w", "k_b", "v_w", "v_b") + tuple(f"{n}_lora_{s}" for n in "kv"
                                                  for s in ("a", "b", "scale"))


def _mlp_block(p: Dict, x: torch.Tensor, sp: Optional[Dict]) -> torch.Tensor:
    tp = _split(p, "gate", sp) is not None
    if tp:
        x = C.copy_to_model(x)
    gate, up = _dense_shared(p, ("gate", "up"), x, sp)
    return _dense_row(p, "down", F.silu(gate) * up, tp)


def embed(params: Dict, input_ids: torch.Tensor, specs: Optional[Dict] = None) -> torch.Tensor:
    """Token embeddings; a vocab-sharded table looks up the ids in its rows
    (zeros elsewhere) and the ranks' rows are summed over ``model``."""
    w, spec = C.gather_fsdp(params["embed"], C.sub(specs, "embed"))
    if C.model_dim(spec) != 0:
        return F.embedding(input_ids, w)
    vl = w.shape[0]
    local = input_ids - C.model_index() * vl
    inside = (local >= 0) & (local < vl)
    e = F.embedding(torch.where(inside, local, torch.zeros_like(local)), w)
    return C.reduce_from_model(e * inside[..., None].to(e.dtype))


def _layer(lp: Dict, cfg: Qwen2Config, x: torch.Tensor, mask, cos_sin, cache, li: int,
           meta_bits, kv_rowmask, where, q_start, sp: Optional[Dict]) -> torch.Tensor:
    lp, sp = C.gather_tree(lp, sp)
    hn = rms_norm(x, lp["input_ln"], cfg.rms_norm_eps)
    x = x + _attention_block(lp, cfg, hn, mask, cos_sin, cache, li, meta_bits,
                             kv_rowmask, where, q_start, sp)
    return x + _mlp_block(lp, rms_norm(x, lp["post_ln"], cfg.rms_norm_eps), sp)


def forward(
    params: Dict,
    cfg: Qwen2Config,
    *,
    input_ids: Optional[torch.Tensor] = None,
    inputs_embeds: Optional[torch.Tensor] = None,
    mask: Optional[torch.Tensor] = None,         # [B, 1, Lq, Lk] bool (True = visible)
    meta_bits: Optional[torch.Tensor] = None,    # [B, L] int32 (ops.masks.pack_meta)
    positions: Optional[torch.Tensor] = None,    # [B, L]
    cache: Optional[KVCache] = None,
    kv_rowmask: Optional[torch.Tensor] = None,   # [B, S] key visibility (chunk kernel)
    remat: bool = False,
    specs: Optional[Dict] = None,                # the tree's specs (module docstring)
) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """Returns (hidden states [B, L, D], advanced cache or None).

    Without a cache this is the prefill-style path. With a cache the chunk is
    written at ``cache.index`` and attends to the whole cache, except with
    ``meta_bits``: then the cache must be empty (an int index of 0) and the
    chunk attends to itself (the prefill). With none of ``mask``,
    ``meta_bits`` and ``kv_rowmask`` the mask is JAX's default (module
    docstring). ``remat`` checkpoints each layer of a cache-free call.
    ``specs`` None: the tree is whole, and checked so.
    """
    if remat and cache is not None:
        raise ValueError("remat is for the cache-free (training) forward")
    if specs is None:
        _check_whole(params, cfg)
    if inputs_embeds is None:
        inputs_embeds = embed(params, input_ids, specs)
    x = inputs_embeds.to(cfg.dtype)
    b, l, _ = x.shape
    start = cache.index if cache is not None else 0
    per_row = isinstance(start, torch.Tensor)
    steps = torch.arange(l, device=x.device)
    if positions is None:
        positions = start[:, None] + steps if per_row else (start + steps)[None].expand(b, l)
    if meta_bits is not None and (per_row or start != 0):
        raise ValueError("meta_bits with a cache is the prefill of an empty cache")
    q_start = None
    if mask is None and meta_bits is None and kv_rowmask is None:
        if cache is None:
            meta_bits = torch.zeros((b, l), dtype=torch.int32, device=x.device)  # causal
        elif l > 1 and not cache.quantized:
            # key s is visible to query j of row b when s <= index[b] + j: the
            # chunk kernel's per-row causal offset over an all-true key mask
            kv_rowmask = torch.ones((b, cache.k.shape[2]), dtype=torch.bool, device=x.device)
            q_start = (start.to(torch.int32) if per_row else
                       torch.full((b,), start, dtype=torch.int32, device=x.device))
        else:
            s = cache.k.shape[2]
            qpos = (start[:, None] if per_row else torch.full((b, 1), start, device=x.device)
                    ) + steps
            visible = torch.arange(s, device=x.device) <= qpos[:, :, None]   # [B, l, S]
            if l == 1:
                kv_rowmask = visible[:, 0]
            else:
                mask = visible[:, None]

    cos_sin = rope_tables(positions, cfg.head_dim, cfg.rope_theta, cfg.rope_scaling_factor)
    where = row_slots(start, l, cache.k.shape[2]) if per_row else start
    for li, lp in enumerate(params["layers"]):
        args = (lp, cfg, x, mask, cos_sin, cache, li, meta_bits, kv_rowmask, where, q_start,
                C.sub(specs, "layers", li))
        x = checkpoint(_layer, *args, use_reentrant=False) if remat else _layer(*args)
    x = rms_norm(x, C.gather_fsdp(params["final_ln"], C.sub(specs, "final_ln"))[0],
                 cfg.rms_norm_eps)
    new_cache = None if cache is None else cache._replace(index=start + l)
    return x, new_cache


def _head_name(params: Dict, cfg: Qwen2Config) -> str:
    return "embed" if cfg.tie_word_embeddings and "lm_head" not in params else "lm_head"


def lm_head(params: Dict, cfg: Qwen2Config, specs: Optional[Dict] = None):
    """(the [V, D] output projection, the embedding unless the head is
    untied, gathered over ``fsdp``; its spec left: vocab-sharded on a
    tensor-parallel tree, for ``project``, or None). ``specs`` None: the
    head is checked whole."""
    name = _head_name(params, cfg)
    if specs is None:
        _check_table(params, cfg, name)
    return C.gather_fsdp(params[name], C.sub(specs, name))


def project(hidden: torch.Tensor, w: torch.Tensor, spec=None) -> torch.Tensor:
    """``hidden @ w.T`` in hidden's dtype over all of w's rows: a weight
    whose ``spec`` shards its rows (a vocab- or code-parallel head) gives
    this rank's columns of the logits, gathered over ``model``."""
    if C.model_dim(spec) != 0:
        return F.linear(hidden, w.to(hidden.dtype))
    return C.gather_last(F.linear(C.copy_to_model(hidden), w.to(hidden.dtype)))


def dense_head(p: Dict, hidden: torch.Tensor, sp: Optional[Dict] = None) -> torch.Tensor:
    """A quantized head's (W8A8 or W4A8) product over all its rows: a node
    whose specs ``sp`` split it on its codes or vocabulary gives this rank's
    columns, gathered over ``model``."""
    y = (dense_int8 if is_quantized(p) else dense_int4)(p, hidden)
    if C.model_dim(_node_spec(sp)) is None:
        return y
    return C.gather_last(y)


def logits(params: Dict, cfg: Qwen2Config, hidden: torch.Tensor,
           vocab_slice: Optional[Tuple[int, int]] = None,
           specs: Optional[Dict] = None) -> torch.Tensor:
    """Project hidden states to (a slice of) the vocabulary, in hidden.dtype.

    A quantized head (``lm_head_q``, W8A8 or W4A8) is used when present;
    ``vocab_slice=(a, b)`` then slices its output channels: the W8A8 head's
    weight rows a .. a + b - a rounded up to a multiple of 8 (rows past the
    slice are computed and not stored; zero rows are appended only where the
    weight ends first) and its scales a .. b; the W4A8 head's packed columns,
    which stay contiguous because the packing runs along K. The float head
    slices the [V, D] weight's rows. A quantized head split on ``model``
    gives the gathered logits, then the slice, as a vocab-sharded float
    head does. ``specs`` None: the head is checked whole.
    """
    if "lm_head_q" in params:
        if specs is None:
            _check_table(params, cfg, "lm_head_q")
        p, sp = params["lm_head_q"], C.sub(specs, "lm_head_q")
        if C.model_dim(_node_spec(sp)) is not None:
            y = dense_head(p, hidden, sp)
            return y if vocab_slice is None else y[..., vocab_slice[0]:vocab_slice[1]]
        if is_quantized(p):
            if vocab_slice is not None:
                a, b = vocab_slice
                p = int8_leaf(p["kernel_int8"][a:a + -(-(b - a) // 8) * 8], p["scale"][a:b])
            return dense_int8(p, hidden)
        if vocab_slice is not None:
            a, b = vocab_slice
            p = {"kernel_int4": p["kernel_int4"][:, a:b], "scale4": p["scale4"][:, a:b],
                 "bias": p["bias"][a:b]}
        return dense_int4(p, hidden)
    w, spec = lm_head(params, cfg, specs)
    if vocab_slice is not None:
        if C.model_dim(spec) is not None:
            return project(hidden, w, spec)[..., vocab_slice[0]:vocab_slice[1]]
        w = w[vocab_slice[0]:vocab_slice[1]]
    return project(hidden, w, spec)


# ---------------------------------------------------------------------------
# HF weight import
# ---------------------------------------------------------------------------

# the port's layer leaves and their names in HF's Qwen2 layer (JAX qwen2.py:588-629)
HF_LAYER_KEYS = {
    "input_ln": "input_layernorm.weight", "post_ln": "post_attention_layernorm.weight",
    "q_w": "self_attn.q_proj.weight", "q_b": "self_attn.q_proj.bias",
    "k_w": "self_attn.k_proj.weight", "k_b": "self_attn.k_proj.bias",
    "v_w": "self_attn.v_proj.weight", "v_b": "self_attn.v_proj.bias",
    "o_w": "self_attn.o_proj.weight",
    "gate_w": "mlp.gate_proj.weight", "up_w": "mlp.up_proj.weight",
    "down_w": "mlp.down_proj.weight",
}


def convert_hf_state_dict(sd: Dict[str, torch.Tensor], cfg: Qwen2Config, prefix: str = "model.",
                          device="cpu") -> Dict[str, Any]:
    """A HuggingFace ``Qwen2ForCausalLM`` state dict -> the port's
    parameters, each leaf on ``device`` in ``cfg.dtype``, one at a time.
    HF's ``nn.Linear`` weights are [out, in], the port's layout, so nothing
    is transposed; ``lm_head`` is taken only when the embeddings are untied.
    A missing key raises ``KeyError`` naming it."""

    def get(name):
        return take(sd, prefix + name, device, cfg.dtype)

    params: Dict[str, Any] = {"embed": get("embed_tokens.weight")}
    params["layers"] = [{leaf: get(f"layers.{i}.{key}") for leaf, key in HF_LAYER_KEYS.items()}
                        for i in range(cfg.num_hidden_layers)]
    params["final_ln"] = get("norm.weight")
    if "lm_head.weight" in sd and not cfg.tie_word_embeddings:
        params["lm_head"] = take(sd, "lm_head.weight", device, cfg.dtype)
    return params
