"""Plain multi-head attention with an fp32 softmax (bskd layout).

Counterpart of ``unigen_tpu/ops/attention.py::dot_product_attention``: fp32
logits, masked logits set to ``finfo(float32).min`` (so a fully masked row
gives uniform weights, as in JAX), softmax in fp32, weights cast to q.dtype
before the PV product. GQA groups the query heads as [KVH, G] so K/V are never
repeated. ``dot_product_attention_q8`` reads an int8 KV cache the same way.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_MIN = torch.finfo(torch.float32).min


def dot_product_attention(
    q: torch.Tensor,                       # [B, Lq, H, Dh]
    k: torch.Tensor,                       # [B, Lk, KVH, Dh]
    v: torch.Tensor,                       # [B, Lk, KVH, Dh]
    mask: Optional[torch.Tensor] = None,   # [B, 1, Lq, Lk] bool (True = visible)
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Returns [B, Lq, H, Dh] in q.dtype."""
    b, lq, h, dh = q.shape
    kvh = k.shape[2]
    g = h // kvh
    if scale is None:
        scale = dh ** -0.5
    qg = q.reshape(b, lq, kvh, g, dh)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float()) * scale
    if mask is not None:
        logits = logits.masked_fill(~mask[:, :, None], NEG_MIN)
    weights = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", weights, v.to(q.dtype))
    return out.reshape(b, lq, h, dh)


def dot_product_attention_q8(
    q: torch.Tensor,                       # [B, Lq, H, Dh]
    k_q: torch.Tensor,                     # [B, Lk, KVH, Dh] int8
    k_scale: torch.Tensor,                 # [B, Lk, KVH] fp32
    v_q: torch.Tensor,                     # [B, Lk, KVH, Dh] int8
    v_scale: torch.Tensor,                 # [B, Lk, KVH] fp32
    mask: Optional[torch.Tensor] = None,   # [B, 1, Lq, Lk] bool (True = visible)
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Attention over an int8 KV cache with the scales applied after each
    product (``unigen_tpu/ops/attention.py::dot_product_attention_q8``): the
    per-(slot, head) scales are constant over the head dimension, so the key
    scales multiply the logits' columns and the value scales fold into the
    softmax weights; no dequantized copy of the cache is made. fp32 logits
    and softmax; weights cast to q.dtype before the PV product. Returns
    [B, Lq, H, Dh] in q.dtype."""
    b, lq, h, dh = q.shape
    kvh = k_q.shape[2]
    g = h // kvh
    if scale is None:
        scale = dh ** -0.5

    def per_key(sc):                       # [B, S, KVH] -> [B, KVH, 1, 1, S]
        return sc.float().transpose(1, 2)[:, :, None, None, :]

    qg = q.reshape(b, lq, kvh, g, dh)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k_q.float())
    logits = logits * scale * per_key(k_scale)
    if mask is not None:
        logits = logits.masked_fill(~mask[:, :, None], NEG_MIN)
    weights = (torch.softmax(logits, dim=-1) * per_key(v_scale)).to(q.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", weights, v_q.to(q.dtype))
    return out.reshape(b, lq, h, dh)
