"""SigLIP vision tower (SigLIP-SO400M-patch14-384), inference only.

Port of ``unigen_tpu/models/siglip.py``: a 14x14 stride-14 patch conv plus
learned position embeddings, pre-LN encoder layers (fp32 layer norm, tanh
GELU MLP), bidirectional attention over the patch grid. The tower drops its
last encoder layer and has no post-layernorm and no pooling head: its output
is the hidden state after ``num_layers_used`` layers, 729 features of width
1152 for 384 px images.

Parameters are a dict: ``patch_embed`` keeps the JAX HWIO kernel, and each
layer is a dict with layer norms ``ln1``/``ln2`` ({scale, bias}) and linear
weights in PyTorch's [out, in] layout (``q_w``, ``q_b``, ..., ``fc2_b``).
Attention runs through ``ops.flash_attention`` with every token marked
bidirectional, as the JAX package does on the TPU; the head dim is
zero-padded to one the kernel is built for (72 -> 80, 8 -> 16) with the real
``dh ** -0.5`` scale, which leaves the result unchanged.

An int8 tower (``ops.quantization.quantize_siglip_params``) holds ``<name>:
{'kernel_int8', 'scale', 'bias'}`` for q, k, v, o, fc1 and fc2 and runs them
W8A8 (q/k/v on one activation quantization), as the JAX package does; the
patch embedding and the layer norms stay float.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch
import torch.nn.functional as F

from ..ops.flash_attention import flash_attention, kernel_head_dim
from ..ops.masks import BIDIRQ_BIT
from ..ops.quantization import (dense_int8, dense_int8_prequant, is_quantized,
                                quantize_activations)


@dataclasses.dataclass(frozen=True)
class SiglipConfig:
    hidden_size: int = 1152
    intermediate_size: int = 4304
    num_hidden_layers: int = 27
    num_attention_heads: int = 16
    num_channels: int = 3
    image_size: int = 384
    patch_size: int = 14
    layer_norm_eps: float = 1e-6
    drop_last_layer: bool = True
    dtype: Any = torch.float32

    @property
    def num_layers_used(self) -> int:
        return self.num_hidden_layers - (1 if self.drop_last_layer else 0)

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @classmethod
    def so400m(cls, **kw) -> "SiglipConfig":
        return cls(**kw)

    @classmethod
    def tiny(cls, **kw) -> "SiglipConfig":
        defaults = dict(hidden_size=32, intermediate_size=64, num_hidden_layers=3,
                        num_attention_heads=4, image_size=28, patch_size=14)
        defaults.update(kw)
        return cls(**defaults)


def layer_norm(p: Dict[str, torch.Tensor], x: torch.Tensor, eps: float) -> torch.Tensor:
    """Layer norm in fp32 (population variance), cast back to x.dtype."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    xf = (xf - mean) * torch.rsqrt(var + eps)
    return (xf * p["scale"].float() + p["bias"].float()).to(x.dtype)


def _bidir_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     scale: float) -> torch.Tensor:
    """Unmasked self-attention over the patch grid; q, k, v [B, L, H, dh]."""
    b, l, _, dh = q.shape
    pad = kernel_head_dim(dh) - dh
    if pad:
        q, k, v = (F.pad(t, (0, pad)) for t in (q, k, v))
    meta = torch.full((b, l), BIDIRQ_BIT, dtype=torch.int32, device=q.device)
    out = flash_attention(q, k, v, meta, scale=scale)
    return out[..., :dh] if pad else out


def _dense(p: Dict, name: str, x: torch.Tensor) -> torch.Tensor:
    if is_quantized(p.get(name)):
        return dense_int8(p[name], x)
    return F.linear(x, p[f"{name}_w"], p[f"{name}_b"])


def _encoder_layer(p: Dict, cfg: SiglipConfig, x: torch.Tensor) -> torch.Tensor:
    b, l, d = x.shape
    h = cfg.num_attention_heads
    dh = d // h
    res = x
    x = layer_norm(p["ln1"], x, cfg.layer_norm_eps)
    if is_quantized(p.get("q")):
        # q/k/v share the input: one activation quantization for all three
        x8, xs = quantize_activations(x)
        q, k, v = (dense_int8_prequant(p[n], x8, xs, x.dtype).view(b, l, h, dh)
                   for n in ("q", "k", "v"))
    else:
        q, k, v = (_dense(p, n, x).view(b, l, h, dh) for n in ("q", "k", "v"))
    attn = _bidir_attention(q, k, v, dh ** -0.5).reshape(b, l, d)
    x = res + _dense(p, "o", attn)
    res = x
    x = layer_norm(p["ln2"], x, cfg.layer_norm_eps)
    x = F.gelu(_dense(p, "fc1", x), approximate="tanh")
    return res + _dense(p, "fc2", x)


@torch.no_grad()
def forward(params: Dict, cfg: SiglipConfig, pixel_values: torch.Tensor) -> torch.Tensor:
    """pixels [B, H, W, 3] (normalized to [-1, 1]) -> patch features [B, P, D]."""
    w = params["patch_embed"]["kernel"].to(cfg.dtype).permute(3, 2, 0, 1)   # HWIO -> OIHW
    x = F.conv2d(pixel_values.to(cfg.dtype).permute(0, 3, 1, 2), w, stride=cfg.patch_size)
    x = x.permute(0, 2, 3, 1) + params["patch_embed"]["bias"].to(cfg.dtype)
    b, gh, gw, d = x.shape
    x = x.reshape(b, gh * gw, d) + params["pos_embed"].to(cfg.dtype)[None]
    for lp in params["layers"]:
        x = _encoder_layer(lp, cfg, x)
    return x
