"""Self-attention with the omni mask computed from a per-token bitfield.

Port of ``unigen_tpu/ops/flash_attention.py::flash_attention``, forward and
backward. ``meta_bits`` is ``ops.masks.pack_meta``'s [B, L] int32:

    visible = ~pad[q] & ~pad[k] & (k <= q | bidir_q[q] | bidir_k[k])
              & seg[q] == seg[k]

Masked logits are ``finfo(float32).min``, so fully masked (pad) rows get
uniform weights over all keys. On a CUDA tensor the wrapper launches the
hand-written kernel ``csrc/attention.cu`` (``flash_attention_launch``); on a
CPU tensor it runs ``flash_attention_plain``, the dense path JAX uses as the
kernel's reference, which is also the kernel's reference on the card.

The backward is a kernel of the same source too
(``flash_attention_backward``), where JAX's ``custom_vjp`` (``_flash_bwd``)
lets XLA recompute the dense reference. A forward that will be
differentiated also writes each row's log-sum-exp, and the backward
recomputes the weights from it tile by tile, FlashAttention-2 style, with
each row's D = sum P dP summed in fp32 from the same P and dP; a pad row's
uniform weights cannot come from its log-sum-exp (finfo.min + ln L rounds
to finfo.min), so its share of dV is summed apart.
``flash_attention_backward_plain`` spells out the kernel's formulas, and
``flash_attention_lse_plain`` gives the log-sum-exp the kernel writes. On the
CPU ``flash_attention`` stays ``flash_attention_plain`` under autograd. On
the card the gradients differ from the plain autograd's in the last bits
(another order of sums; P rounded to bf16 before dV's product, dS carried
as two bf16 parts into dQ's and dK's),
and two runs give the same bits: the kernel uses no atomics.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import _cuda
from .attention import NEG_MIN, dot_product_attention
from .masks import unpack_meta


# The head dims ``csrc/attention.cu`` instantiates (its ``launch`` switch);
# tests/test_torch_siglip.py holds the two lists equal.
KERNEL_HEAD_DIMS = (16, 32, 64, 80, 128)


def kernel_head_dim(dh: int) -> int:
    """The smallest head dim the kernel is built for that holds ``dh``; a
    caller zero-pads q, k and v to it and passes the real ``scale``."""
    for d in KERNEL_HEAD_DIMS:
        if d >= dh:
            return d
    raise ValueError(f"head dim {dh} exceeds the kernel's {KERNEL_HEAD_DIMS[-1]}")


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          meta_bits: torch.Tensor,
                          scale: Optional[float] = None) -> torch.Tensor:
    """Dense attention under ``unpack_meta(meta_bits).visibility()``."""
    return dot_product_attention(q, k, v, mask=unpack_meta(meta_bits).visibility(),
                                 scale=scale)


def flash_attention_lse_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              meta_bits: torch.Tensor, scale: Optional[float] = None):
    """(out, lse): ``flash_attention_plain``'s output and each row's
    natural-base log-sum-exp of its scaled, masked fp32 logits, [B, H, L]
    float32 (``finfo(float32).min`` for a row with no visible key): what the
    kernel's forward writes for its backward."""
    b, l, h, dh = q.shape
    kvh = k.shape[2]
    if scale is None:
        scale = dh ** -0.5
    logits = torch.einsum("bqkgd,bskd->bkgqs", q.reshape(b, l, kvh, h // kvh, dh).float(),
                          k.float()) * scale
    logits = logits.masked_fill(~unpack_meta(meta_bits).visibility()[:, :, None], NEG_MIN)
    return (flash_attention_plain(q, k, v, meta_bits, scale),
            torch.logsumexp(logits, -1).reshape(b, h, l))


def flash_attention_backward_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                   meta_bits: torch.Tensor, lse: torch.Tensor, g: torch.Tensor,
                                   scale: Optional[float] = None):
    """dq, dk, dv of ``flash_attention`` for the upstream gradient ``g``, by
    the backward kernel's formulas in fp32, without autograd. With s the
    scaled logits, P = exp(s - lse) on visible pairs and 0 elsewhere, dP =
    g . v and D = sum_k P dP a row (g . out in exact arithmetic; the kernel
    sums it from P and dP, not from the output it rounded to bf16):

        dV = P^T g,  dS = P (dP - D),  dQ = scale dS K,  dK = scale dS^T Q

    summed over the G query heads of each KV head. A row with no visible key
    (a pad row) has weights 1/L over all L keys in the forward and no
    gradient to its logits (the mask blocks it): it adds g / L to every key's
    dV. ``lse`` as ``flash_attention_lse_plain`` gives it. Returns the three
    in q's, k's and v's dtypes."""
    b, l, h, dh = q.shape
    kvh = k.shape[2]
    gr = h // kvh
    if scale is None:
        scale = dh ** -0.5
    meta = unpack_meta(meta_bits)
    vis = meta.visibility()[:, :, None]                          # [B, 1, 1, L, L]
    qf, gf = (t.reshape(b, l, kvh, gr, dh).float() for t in (q, g))
    kf, vf = k.float(), v.float()
    s = torch.einsum("bqkgd,bskd->bkgqs", qf, kf) * scale
    p = torch.where(vis, torch.exp(s - lse.reshape(b, kvh, gr, l, 1)), 0.0)
    dp = torch.einsum("bqkgd,bskd->bkgqs", gf, vf)
    ds = p * (dp - (p * dp).sum(-1, keepdim=True))
    dq = torch.einsum("bkgqs,bskd->bqkgd", ds, kf) * scale
    dk = torch.einsum("bkgqs,bqkgd->bskd", ds, qf) * scale
    dv = torch.einsum("bkgqs,bqkgd->bskd", p, gf)
    pad = meta.pad[:, :, None, None, None]
    dv = dv + torch.where(pad, gf, 0.0).sum((1, 3))[:, None] / l
    return dq.reshape(b, l, h, dh).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _FlashAttention(torch.autograd.Function):
    """Forward: kernel 2 (``flash_attention_launch``), writing the rows'
    log-sum-exp when an input wants a gradient. Backward: the backward
    kernel (``flash_attention_backward``)."""

    @staticmethod
    def forward(ctx, q, k, v, meta_bits, scale):
        lse = None
        if any(ctx.needs_input_grad[:3]):
            b, l, h, _ = q.shape
            lse = torch.empty((b, h, l), dtype=torch.float32, device=q.device)
        ctx.save_for_backward(q, k, v, meta_bits, lse)
        ctx.scale = scale
        return flash_attention_launch(q, k, v, meta_bits, scale, lse=lse)

    @staticmethod
    def backward(ctx, g):
        q, k, v, meta_bits, lse = ctx.saved_tensors
        grads = flash_attention_backward(q, k, v, meta_bits, lse, g, ctx.scale)
        return (*(d if need else None for d, need in zip(grads, ctx.needs_input_grad)),
                None, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    meta_bits: torch.Tensor, scale: Optional[float] = None) -> torch.Tensor:
    """q: [B, L, H, Dh]; k, v: [B, L, KVH, Dh]; meta_bits: [B, L] int32.
    Returns [B, L, H, Dh] in q.dtype, differentiable in q, k and v."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, meta_bits, scale)
    return _FlashAttention.apply(q, k, v, meta_bits, scale)


def _check_inputs(q, k, v, meta_bits, *more):
    """Raise unless q [B, L, H, Dh], k and v [B, L, KVH, Dh] with KVH | H,
    int32 meta_bits [B, L], and ``more`` lie on one device."""
    b, l, h, dh = q.shape
    kvh = k.shape[2]
    if k.shape != (b, l, kvh, dh) or v.shape != k.shape or meta_bits.shape != (b, l):
        raise ValueError(f"flash_attention shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} meta {tuple(meta_bits.shape)}")
    if h % kvh:
        raise ValueError(f"{h} query heads do not group over {kvh} kv heads")
    if meta_bits.dtype != torch.int32:
        raise TypeError(f"meta_bits must be int32, got {meta_bits.dtype}")
    for t in (k, v, meta_bits, *more):
        if t.device != q.device:
            raise ValueError(f"flash_attention inputs on {q.device} and {t.device}")


def _check_lse(lse, q):
    b, l, h, _ = q.shape
    if lse.device != q.device:
        raise ValueError(f"flash_attention inputs on {q.device} and {lse.device}")
    if lse.shape != (b, h, l) or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError(f"lse must be contiguous float32 {(b, h, l)}, got {lse.dtype} "
                         f"{tuple(lse.shape)}")


def flash_attention_launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           meta_bits: torch.Tensor, scale: Optional[float] = None,
                           lse: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One launch of kernel 2 on CUDA tensors (counted on
    ``flash_attention.launches``); no autograd. ``lse``, a float32 [B, H, L]
    buffer, also receives each row's log-sum-exp (as
    ``flash_attention_lse_plain`` gives it); the output's bits are the same
    with or without it."""
    b, l, h, dh = q.shape
    kvh = k.shape[2]
    _check_inputs(q, k, v, meta_bits)
    if lse is not None:
        _check_lse(lse, q)
    if scale is None:
        scale = dh ** -0.5
    q = q.contiguous()
    k = k.to(q.dtype).contiguous()
    v = v.to(q.dtype).contiguous()
    meta_bits = meta_bits.contiguous()
    out = torch.empty_like(q)
    lib = _cuda.library("attention")
    rc = lib.flash_attention_launch(
        _cuda.dtype_code(q.dtype), q.data_ptr(), k.data_ptr(), v.data_ptr(),
        meta_bits.data_ptr(), out.data_ptr(), None if lse is None else lse.data_ptr(),
        b, l, h, kvh, dh, scale, _cuda.stream_of(q))
    _cuda.check(rc, "flash_attention_launch")
    flash_attention.launches += 1
    return out


def _dkv_splits(b: int, l: int, kvh: int, device) -> int:
    """Row ranges of the backward's dK/dV walk in bf16. Its grid has a block
    a (batch row, KV head, 64 keys) that walks all the group's query rows;
    where that grid is under one wave of two blocks an SM (SFT's mmu call
    [4, 796] has 104 blocks on 132 SMs), the walk is cut into ranges that
    fill one (at most 8) and their fp32 sums are added in range order."""
    blocks = b * kvh * -(-l // 64)
    wave = 2 * torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(8, -(-wave // blocks)))


def flash_attention_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             meta_bits: torch.Tensor, lse: torch.Tensor, g: torch.Tensor,
                             scale: Optional[float] = None):
    """dq, dk, dv of ``flash_attention`` for the upstream gradient ``g``,
    from the rows' ``lse`` ([B, H, L] float32, as ``flash_attention_launch``
    writes it). CPU tensors:
    ``flash_attention_backward_plain``. CUDA tensors: one launch of the
    backward kernel (counted on ``flash_attention_backward.launches``), in
    q's dtype. Returns the three in q's, k's and v's dtypes."""
    if q.device.type == "cpu":
        return flash_attention_backward_plain(q, k, v, meta_bits, lse, g, scale)
    b, l, h, dh = q.shape
    kvh = k.shape[2]
    _check_inputs(q, k, v, meta_bits, g)
    _check_lse(lse, q)
    if g.shape != q.shape:
        raise ValueError(f"flash_attention_backward: g {tuple(g.shape)} must be shaped like q "
                         f"{tuple(q.shape)}")
    if scale is None:
        scale = dh ** -0.5
    dtype = q.dtype
    q, g = q.contiguous(), g.to(dtype).contiguous()
    kc, vc = k.to(dtype).contiguous(), v.to(dtype).contiguous()
    meta_bits = meta_bits.contiguous()
    splits = _dkv_splits(b, l, kvh, q.device) if dtype == torch.bfloat16 else 1
    parts = 2 * splits * b * l * kvh * dh if splits > 1 else 0
    scratch = torch.empty(parts + b * h * l + b * kvh * dh, dtype=torch.float32,
                          device=q.device)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(kc), torch.empty_like(vc)
    lib = _cuda.library("attention")
    rc = lib.flash_attention_backward_launch(
        _cuda.dtype_code(dtype), q.data_ptr(), kc.data_ptr(), vc.data_ptr(),
        meta_bits.data_ptr(), g.data_ptr(), lse.data_ptr(), scratch.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, l, h, kvh, dh, splits, scale,
        _cuda.stream_of(q))
    _cuda.check(rc, "flash_attention_backward_launch")
    flash_attention_backward.launches += 1
    return dq, dk.to(k.dtype), dv.to(v.dtype)


flash_attention.launches = 0
flash_attention_backward.launches = 0
