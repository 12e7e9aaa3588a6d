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

The backward is JAX's design (its ``custom_vjp``, ``_flash_bwd``): there is
no backward kernel; ``_FlashAttention.backward`` recomputes
``flash_attention_plain`` from the saved q, k and v under autograd and
returns its input gradients. So the backward never reads the kernel's
output, and for the same upstream gradient dq, dk and dv equal those of
``flash_attention_plain``'s own autograd bit for bit. The dense recompute
is the backward itself, not a fallback: the forward on a CUDA tensor
always launches the kernel.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import _cuda
from .attention import dot_product_attention
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


class _FlashAttention(torch.autograd.Function):
    """Forward: kernel 2 (``flash_attention_launch``). Backward: the
    gradients of ``flash_attention_plain`` recomputed from q, k and v."""

    @staticmethod
    def forward(ctx, q, k, v, meta_bits, scale):
        ctx.save_for_backward(q, k, v, meta_bits)
        ctx.scale = scale
        return flash_attention_launch(q, k, v, meta_bits, scale)

    @staticmethod
    def backward(ctx, g):
        q, k, v, meta_bits = ctx.saved_tensors
        with torch.enable_grad():
            qkv = [t.detach().requires_grad_(need)
                   for t, need in zip((q, k, v), ctx.needs_input_grad[:3])]
            out = flash_attention_plain(*qkv, meta_bits, ctx.scale)
            wanted = [t for t in qkv if t.requires_grad]
            got = iter(torch.autograd.grad(out, wanted, g))
        return (*(next(got) if t.requires_grad else None for t in qkv), None, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    meta_bits: torch.Tensor, scale: Optional[float] = None) -> torch.Tensor:
    """q: [B, L, H, Dh]; k, v: [B, L, KVH, Dh]; meta_bits: [B, L] int32.
    Returns [B, L, H, Dh] in q.dtype, differentiable in q, k and v."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, meta_bits, scale)
    return _FlashAttention.apply(q, k, v, meta_bits, scale)


def flash_attention_launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           meta_bits: torch.Tensor,
                           scale: Optional[float] = None) -> torch.Tensor:
    """One launch of kernel 2 on CUDA tensors (counted on
    ``flash_attention.launches``); no autograd."""
    b, l, h, dh = q.shape
    kvh = k.shape[2]
    if k.shape != (b, l, kvh, dh) or v.shape != k.shape or meta_bits.shape != (b, l):
        raise ValueError(f"flash_attention shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} meta {tuple(meta_bits.shape)}")
    if h % kvh:
        raise ValueError(f"{h} query heads do not group over {kvh} kv heads")
    if meta_bits.dtype != torch.int32:
        raise TypeError(f"meta_bits must be int32, got {meta_bits.dtype}")
    for t in (k, v, meta_bits):
        if t.device != q.device:
            raise ValueError(f"flash_attention inputs on {q.device} and {t.device}")
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
        meta_bits.data_ptr(), out.data_ptr(), b, l, h, kvh, dh,
        scale, _cuda.stream_of(q))
    _cuda.check(rc, "flash_attention_launch")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
