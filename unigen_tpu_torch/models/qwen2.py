"""Qwen2.5 causal-LM backbone, inference only.

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
chunk as the dense [B, 1, l, S] mask.

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

Dense projections are ``torch`` matmuls, as the JAX package leaves them to
XLA, except in a quantized tree: a layer holds ``<name>: {'kernel_int8',
'scale', 'bias'?}`` (W8A8, ``ops.quantization.quantize_unigen_params``) or
``<name>: {'kernel_int4', 'scale4', 'bias'}`` (W4A8,
``ops.int4.quantize_unigen_params_int4``) in place of ``<name>_w`` /
``<name>_b``, and the projection goes through ``dense_int8`` or
``dense_int4`` (q/k/v share one activation quantization, and so do
gate/up). The JAX package's LoRA leaves are not ported: a tree that holds
them raises.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from ..ops.attention import dot_product_attention, dot_product_attention_q8
from ..ops.chunk_attention import chunk_attention
from ..ops.flash_attention import flash_attention
from ..ops.int4 import dense_int4, dense_int4_prequant, is_quantized_int4
from ..ops.quantization import (dense_int8, dense_int8_prequant, int8_leaf, is_quantized,
                                quantize_activations)


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
                  per_row_index: bool = False) -> KVCache:
    if cfg.kv_layout != "bskd":
        raise NotImplementedError(
            f"kv_layout {cfg.kv_layout!r}: the port's cache is bskd only (ROADMAP, "
            "'Deliberate differences')")
    shape = (cfg.num_hidden_layers, batch_size, max_len, cfg.num_key_value_heads,
             cfg.head_dim)
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


def _check_leaf(p: Dict, name: str) -> None:
    """Raise on the JAX package's leaves that the port does not compute."""
    leaf = p.get(name)
    if isinstance(leaf, dict) and "lora_a" in leaf:
        raise NotImplementedError(
            f"{name}: LoRA layers are not ported; W8A8 (kernel_int8), W4A8 "
            "(kernel_int4) and float layers are")
    if f"{name}_w" not in p and not (is_quantized(leaf) or is_quantized_int4(leaf)):
        raise KeyError(f"layer has neither {name}_w nor a quantized {name}")


def _dense(p: Dict, name: str, x: torch.Tensor) -> torch.Tensor:
    """The projection ``name`` of layer ``p``: W8A8 or W4A8 when it holds
    ``kernel_int8`` or ``kernel_int4``, else ``F.linear`` with ``<name>_w``
    and ``<name>_b``."""
    _check_leaf(p, name)
    leaf = p.get(name)
    if is_quantized(leaf):
        return dense_int8(leaf, x)
    if is_quantized_int4(leaf):
        return dense_int4(leaf, x)
    return F.linear(x, p[f"{name}_w"], p.get(f"{name}_b"))


def _dense_shared(p: Dict, names: Tuple[str, ...], x: torch.Tensor):
    """Projections of one input: in a quantized layer the input is quantized
    once for all of them, as the JAX package does."""
    for name in names:
        _check_leaf(p, name)
    first = p.get(names[0])
    if is_quantized(first) or is_quantized_int4(first):
        x8, xs = quantize_activations(x)
        return [(dense_int8_prequant if is_quantized(p[n]) else dense_int4_prequant)(
            p[n], x8, xs, x.dtype) for n in names]
    return [F.linear(x, p[f"{n}_w"], p.get(f"{n}_b")) for n in names]


def _attention_block(p: Dict, cfg: Qwen2Config, x: torch.Tensor,
                     mask: Optional[torch.Tensor],
                     cos_sin: Tuple[torch.Tensor, torch.Tensor],
                     cache: Optional[KVCache], li: int,
                     meta_bits: Optional[torch.Tensor],
                     kv_rowmask: Optional[torch.Tensor],
                     where: Union[int, RowSlots, None]) -> torch.Tensor:
    b, l, _ = x.shape
    h, kvh, dh = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    q, k, v = _dense_shared(p, ("q", "k", "v"), x)
    q = q.view(b, l, h, dh)
    k = k.view(b, l, kvh, dh)
    v = v.view(b, l, kvh, dh)
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
        return _dense(p, "o", out.reshape(b, l, h * dh))
    if cache is not None:
        _cache_write(cache.k, k, li, where)
        _cache_write(cache.v, v, li, where)
    if meta_bits is not None:
        # cache-free self-attention, or the prefill of an empty cache
        out = flash_attention(q, k, v, meta_bits)
    elif cache is not None and kv_rowmask is not None:
        out = chunk_attention(q, cache.k[li], cache.v[li], kv_rowmask)
    elif cache is not None:
        out = dot_product_attention(q, cache.k[li].to(q.dtype), cache.v[li].to(q.dtype),
                                    mask=mask)
    else:
        out = dot_product_attention(q, k, v, mask=mask)
    return _dense(p, "o", out.reshape(b, l, h * dh))


def _mlp_block(p: Dict, x: torch.Tensor) -> torch.Tensor:
    gate, up = _dense_shared(p, ("gate", "up"), x)
    return _dense(p, "down", F.silu(gate) * up)


def embed(params: Dict, input_ids: torch.Tensor) -> torch.Tensor:
    return F.embedding(input_ids, params["embed"])


@torch.no_grad()
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
) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """Returns (hidden states [B, L, D], advanced cache or None).

    Without a cache this is the prefill-style path. With a cache the chunk is
    written at ``cache.index`` and attends to the whole cache, except with
    ``meta_bits``: then the cache must be empty (an int index of 0) and the
    chunk attends to itself (the prefill). With none of ``mask``,
    ``meta_bits`` and ``kv_rowmask`` the mask is JAX's default (module
    docstring).
    """
    if inputs_embeds is None:
        inputs_embeds = embed(params, input_ids)
    x = inputs_embeds.to(cfg.dtype)
    b, l, _ = x.shape
    start = cache.index if cache is not None else 0
    per_row = isinstance(start, torch.Tensor)
    steps = torch.arange(l, device=x.device)
    if positions is None:
        positions = start[:, None] + steps if per_row else (start + steps)[None].expand(b, l)
    if meta_bits is not None and (per_row or start != 0):
        raise ValueError("meta_bits with a cache is the prefill of an empty cache")
    if mask is None and meta_bits is None and kv_rowmask is None:
        if cache is None:
            meta_bits = torch.zeros((b, l), dtype=torch.int32, device=x.device)  # causal
        else:
            # key s is visible to query j of row b when s <= index[b] + j
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
        hn = rms_norm(x, lp["input_ln"], cfg.rms_norm_eps)
        x = x + _attention_block(lp, cfg, hn, mask, cos_sin, cache, li, meta_bits,
                                 kv_rowmask, where)
        x = x + _mlp_block(lp, rms_norm(x, lp["post_ln"], cfg.rms_norm_eps))
    x = rms_norm(x, params["final_ln"], cfg.rms_norm_eps)
    new_cache = None if cache is None else cache._replace(index=start + l)
    return x, new_cache


def lm_head_weight(params: Dict, cfg: Qwen2Config) -> torch.Tensor:
    """[V, D] output projection (the embedding unless the head is untied)."""
    if cfg.tie_word_embeddings and "lm_head" not in params:
        return params["embed"]
    return params["lm_head"]


def logits(params: Dict, cfg: Qwen2Config, hidden: torch.Tensor,
           vocab_slice: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Project hidden states to (a slice of) the vocabulary, in hidden.dtype.

    A quantized head (``lm_head_q``, W8A8 or W4A8) is used when present;
    ``vocab_slice=(a, b)`` then slices its output channels: the W8A8 head's
    weight rows a .. a + b - a rounded up to a multiple of 8 (rows past the
    slice are computed and not stored; zero rows are appended only where the
    weight ends first) and its scales a .. b; the W4A8 head's packed columns,
    which stay contiguous because the packing runs along K. The float head
    slices the [V, D] weight's rows.
    """
    if "lm_head_q" in params:
        p = params["lm_head_q"]
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
    w = lm_head_weight(params, cfg)
    if vocab_slice is not None:
        w = w[vocab_slice[0]:vocab_slice[1]]
    return F.linear(hidden, w.to(hidden.dtype))
