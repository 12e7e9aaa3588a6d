"""Fused GroupNorm + swish + conv3x3 for the MAGViTv2 decoder (NHWC, HWIO).

Port of ``unigen_tpu/ops/fused_conv.py::conv3x3_gn_swish``. The GroupNorm
statistics come from an fp32 pre-pass (``gn_affine``, plain PyTorch as JAX
leaves it to XLA) folded into a per-(batch, channel) affine ``x * A + B``; the
kernel ``csrc/fused_conv.cu`` applies affine + swish on its tile, zeroes the
SAME padding after the activation, and runs the 3x3 convolution with fp32
accumulation. ``gn_p=None`` is a plain conv3x3 (the upsample conv). On a CPU
tensor the wrapper runs ``conv3x3_gn_swish_plain``, the unfused composition,
which is also the kernel's reference on the card.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from . import _cuda


def _group_norm_f32(p: Dict, x: torch.Tensor, num_groups: int, eps: float) -> torch.Tensor:
    b, h, w, c = x.shape
    g = min(num_groups, c)
    xf = x.float().reshape(b, h, w, g, c // g)
    var, mean = torch.var_mean(xf, dim=(1, 2, 4), keepdim=True, unbiased=False)
    xf = ((xf - mean) * torch.rsqrt(var + eps)).reshape(b, h, w, c)
    return xf * p["scale"].float() + p["bias"].float()


def group_norm(p: Dict, x: torch.Tensor, num_groups: int = 32,
               eps: float = 1e-6) -> torch.Tensor:
    """GroupNorm in fp32 over NHWC, groups = min(num_groups, C), population variance."""
    return _group_norm_f32(p, x, num_groups, eps).to(x.dtype)


def swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def conv2d(p: Dict, x: torch.Tensor) -> torch.Tensor:
    """Stride-1 SAME convolution, NHWC activations and an HWIO kernel."""
    kernel = p["kernel"].to(x.dtype)
    kh, kw = kernel.shape[0], kernel.shape[1]
    y = F.conv2d(x.permute(0, 3, 1, 2), kernel.permute(3, 2, 0, 1),
                 padding=(kh // 2, kw // 2))
    return y.permute(0, 2, 3, 1).contiguous() + p["bias"].to(x.dtype)


def gn_affine(gn_p: Dict, x: torch.Tensor, num_groups: int = 32,
              eps: float = 1e-6) -> torch.Tensor:
    """GroupNorm folded into [B, 2, C] fp32: A (scale) and B (shift), x_norm = x*A + B."""
    b, h, w, c = x.shape
    g = min(num_groups, c)
    xf = x.float().reshape(b, h * w, g, c // g)
    var, mean = torch.var_mean(xf, dim=(1, 3), unbiased=False)   # [B, g]
    inv = torch.rsqrt(var + eps)
    scale = gn_p["scale"].float().reshape(g, c // g)
    bias = gn_p["bias"].float().reshape(g, c // g)
    a = (scale[None] * inv[..., None]).reshape(b, c)
    sh = (bias[None] - mean[..., None] * scale[None] * inv[..., None]).reshape(b, c)
    return torch.stack([a, sh], dim=1)


def conv3x3_gn_swish_plain(conv_p: Dict, gn_p: Optional[Dict], x: torch.Tensor,
                           num_groups: int = 32, eps: float = 1e-6) -> torch.Tensor:
    """The unfused composition: GroupNorm affine and swish in fp32 with one
    rounding to x.dtype, then the SAME conv3x3 and its bias."""
    if gn_p is not None:
        x = swish(_group_norm_f32(gn_p, x, num_groups, eps)).to(x.dtype)
    return conv2d(conv_p, x)


def conv3x3_gn_swish(conv_p: Dict, gn_p: Optional[Dict], x: torch.Tensor,
                     num_groups: int = 32, eps: float = 1e-6) -> torch.Tensor:
    """``conv3x3(swish(group_norm(x)))``, or a plain conv3x3 when ``gn_p`` is None.

    x: [B, H, W, C]; conv_p: {"kernel": [3, 3, C, Cout], "bias": [Cout]}.
    Returns [B, H, W, Cout] in x.dtype."""
    if x.device.type == "cpu":
        return conv3x3_gn_swish_plain(conv_p, gn_p, x, num_groups, eps)
    b, h, w, c = x.shape
    kernel = conv_p["kernel"]
    if kernel.shape[:3] != (3, 3, c):
        raise ValueError(f"conv3x3 kernel {tuple(kernel.shape)} for input {tuple(x.shape)}")
    cout = kernel.shape[3]
    if conv_p["bias"].shape != (cout,):
        raise ValueError(f"conv3x3 bias {tuple(conv_p['bias'].shape)} for {cout} channels")
    x = x.contiguous()
    wt = kernel.to(device=x.device, dtype=x.dtype).contiguous()
    bias = conv_p["bias"].to(device=x.device, dtype=x.dtype).contiguous()
    ab = gn_affine(gn_p, x, num_groups, eps).contiguous() if gn_p is not None else None
    out = torch.empty((b, h, w, cout), dtype=x.dtype, device=x.device)
    lib = _cuda.library("fused_conv")
    rc = lib.conv3x3_gn_swish_launch(
        _cuda.dtype_code(x.dtype), x.data_ptr(), None if ab is None else ab.data_ptr(),
        wt.data_ptr(), bias.data_ptr(), out.data_ptr(), b, h, w, c, cout,
        _cuda.stream_of(x))
    _cuda.check(rc, "conv3x3_gn_swish_launch")
    conv3x3_gn_swish.launches += 1
    return out


conv3x3_gn_swish.launches = 0
