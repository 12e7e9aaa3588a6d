"""Attention of the MaskGIT chunk step against the prefix KV cache.

Port of ``unigen_tpu/ops/chunk_attention.py::chunk_attention``. Every query
of batch row b sees exactly the keys with ``kvalid[b]`` set, so the mask is a
[B, S] vector, not an [Lq, S] matrix. On a CUDA tensor the wrapper launches
the hand-written kernel ``csrc/attention.cu`` (``chunk_attention_launch``);
on a CPU tensor it runs ``chunk_attention_plain``, which repeats the TPU
kernel's arithmetic and is the kernel's reference on the card.
"""
from __future__ import annotations

import torch

from . import _cuda


def chunk_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          kvalid: torch.Tensor) -> torch.Tensor:
    """fp32 logits plus a 0 / -1e30 bias, max-shifted fp32 softmax, P cast
    to q.dtype, P.V accumulated in fp32. q: [B, Lq, H, Dh]; k, v:
    [B, S, KVH, Dh]; kvalid: [B, S] bool. Returns [B, Lq, H, Dh] in q.dtype."""
    b, lq, h, dh = q.shape
    kvh = k.shape[2]
    g = h // kvh
    scale = dh ** -0.5
    qg = q.reshape(b, lq, kvh, g, dh)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.to(q.dtype).float()) * scale
    bias = torch.where(kvalid, 0.0, -1e30).to(torch.float32)
    logits = logits + bias[:, None, None, None, :]
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bkgqs,bskd->bqkgd", p.to(q.dtype).float(), v.to(q.dtype).float())
    return out.reshape(b, lq, h, dh).to(q.dtype)


def chunk_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    kvalid: torch.Tensor) -> torch.Tensor:
    """q: [B, Lq, H, Dh]; k, v: [B, S, KVH, Dh]; kvalid: [B, S] bool.
    Returns [B, Lq, H, Dh] in q.dtype."""
    if q.device.type == "cpu":
        return chunk_attention_plain(q, k, v, kvalid)
    b, lq, h, dh = q.shape
    s, kvh = k.shape[1], k.shape[2]
    if k.shape != (b, s, kvh, dh) or v.shape != k.shape or kvalid.shape != (b, s):
        raise ValueError(f"chunk_attention shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} kvalid {tuple(kvalid.shape)}")
    if h % kvh:
        raise ValueError(f"{h} query heads do not group over {kvh} kv heads")
    if kvalid.dtype != torch.bool:
        raise TypeError(f"kvalid must be bool, got {kvalid.dtype}")
    for t in (k, v, kvalid):
        if t.device != q.device:
            raise ValueError(f"chunk_attention inputs on {q.device} and {t.device}")
    q = q.contiguous()
    k = k.to(q.dtype).contiguous()
    v = v.to(q.dtype).contiguous()
    kvalid = kvalid.contiguous()
    out = torch.empty_like(q)
    lib = _cuda.library("attention")
    rc = lib.chunk_attention_launch(
        _cuda.dtype_code(q.dtype), q.data_ptr(), k.data_ptr(), v.data_ptr(),
        kvalid.data_ptr(), out.data_ptr(), b, lq, s, h, kvh, dh,
        dh ** -0.5, _cuda.stream_of(q))
    _cuda.check(rc, "chunk_attention_launch")
    chunk_attention.launches += 1
    return out


chunk_attention.launches = 0
