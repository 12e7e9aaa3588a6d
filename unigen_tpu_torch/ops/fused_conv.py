"""Fused GroupNorm + swish + conv3x3 for the MAGViTv2 decoder (NHWC, HWIO).

Port of ``unigen_tpu/ops/fused_conv.py::conv3x3_gn_swish``. The GroupNorm
statistics are folded into a per-(batch, channel) affine ``x * A + B`` by
``gn_affine`` (one C call of ``csrc/fused_conv.cu``: a Welford partial pass
over pixel ranges and a finish pass, fp32); the conv kernel applies affine +
swish on its tile, zeroes the SAME padding after the activation, and runs the
3x3 convolution with fp32 accumulation. ``gn_p=None`` is a plain conv3x3 (the
upsample conv). On a CPU tensor the wrappers run ``gn_affine_plain`` and
``conv3x3_gn_swish_plain``, the unfused compositions, which are also the
kernels' references on the card.

The gradient is JAX's design (its ``custom_vjp``, ``_bwd``): there is no
backward kernel. On a CUDA tensor ``conv3x3_gn_swish`` runs through
``_ConvGnSwish``, whose forward is the two launches above and whose backward
recomputes ``conv3x3_gn_swish_plain`` from the saved input and parameters
under autograd, so for one upstream gradient the input, conv and GroupNorm
gradients are those of the plain version's own autograd.
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


def conv2d(p: Dict, x: torch.Tensor, stride: int = 1, padding: str = "SAME") -> torch.Tensor:
    """Convolution of NHWC activations with an HWIO kernel: ``"SAME"`` pads
    (kh // 2, kw // 2) and keeps the size at stride 1 (odd kernels);
    ``"VALID"`` pads nothing."""
    kernel = p["kernel"].to(x.dtype)
    kh, kw = kernel.shape[0], kernel.shape[1]
    if padding not in ("SAME", "VALID"):
        raise ValueError(f"padding must be 'SAME' or 'VALID', got {padding!r}")
    pad = (kh // 2, kw // 2) if padding == "SAME" else (0, 0)
    y = F.conv2d(x.permute(0, 3, 1, 2), kernel.permute(3, 2, 0, 1), stride=stride,
                 padding=pad)
    return y.permute(0, 2, 3, 1).contiguous() + p["bias"].to(x.dtype)


def gn_affine_plain(gn_p: Dict, x: torch.Tensor, num_groups: int = 32,
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


GN_MAX_CHANNELS = 2048     # 8 channels a thread, 256 threads (csrc/fused_conv.cu)
_SMS = 132                 # streaming multiprocessors of an H100 SXM


def gn_splits(b: int, hw: int, c: int) -> int:
    """Pixel ranges of each image in the statistics' partial pass: about 16
    16-byte loads a thread (256 threads, 8 channels each), at most one wave
    of three blocks an SM over the batch, at least one pixel a range."""
    loads = hw * -(-c // 8)
    return max(1, min(hw, -(-loads // (256 * 16)), 3 * _SMS // b))


def _check_gn(gn_p: Dict, x: torch.Tensor, num_groups: int) -> int:
    """The statistics kernel's argument checks; returns the number of groups."""
    if x.dim() != 4:
        raise ValueError(f"GroupNorm input {tuple(x.shape)}: expected [B, H, W, C]")
    _cuda.dtype_code(x.dtype)
    c = x.shape[3]
    g = min(num_groups, c)
    if g < 1 or c % g or c > GN_MAX_CHANNELS:
        raise ValueError(f"GroupNorm of {c} channels in {num_groups} groups: the kernel takes "
                         f"C <= {GN_MAX_CHANNELS} in groups dividing C")
    for name in ("scale", "bias"):
        p = gn_p[name]
        if p.shape != (c,):
            raise ValueError(f"GroupNorm {name} {tuple(p.shape)} for {c} channels")
        if p.device != x.device:
            raise ValueError(f"GroupNorm {name} on {p.device}, input on {x.device}")
    _cuda.dtype_code(gn_p["scale"].dtype)
    if gn_p["scale"].dtype != gn_p["bias"].dtype:
        raise TypeError(f"GroupNorm scale {gn_p['scale'].dtype} and bias {gn_p['bias'].dtype}")
    return g


def gn_affine(gn_p: Dict, x: torch.Tensor, num_groups: int = 32,
              eps: float = 1e-6) -> torch.Tensor:
    """GroupNorm folded into [B, 2, C] fp32: A (scale) and B (shift), x_norm = x*A + B.

    x: [B, H, W, C] fp32 or bf16; groups = min(num_groups, C), population
    variance; scale and bias [C] in one type, fp32 or bf16."""
    if x.device.type == "cpu":
        return gn_affine_plain(gn_p, x, num_groups, eps)
    g = _check_gn(gn_p, x, num_groups)
    b, h, w, c = x.shape
    x = x.contiguous()
    scale, bias = gn_p["scale"].contiguous(), gn_p["bias"].contiguous()
    nsplit = gn_splits(b, h * w, c)
    ab = torch.empty((b, 2, c), dtype=torch.float32, device=x.device)
    scratch = torch.empty((b, nsplit, g, 3), dtype=torch.float32, device=x.device)
    lib = _cuda.library("fused_conv")
    rc = lib.gn_affine_launch(
        _cuda.dtype_code(x.dtype), x.data_ptr(), _cuda.dtype_code(scale.dtype),
        scale.data_ptr(), bias.data_ptr(), ab.data_ptr(), scratch.data_ptr(), b, h * w, c, g,
        nsplit, float(eps), _cuda.stream_of(x))
    _cuda.check(rc, "gn_affine_launch")
    gn_affine.launches += 1
    return ab


gn_affine.launches = 0


def conv3x3_gn_swish_plain(conv_p: Dict, gn_p: Optional[Dict], x: torch.Tensor,
                           num_groups: int = 32, eps: float = 1e-6) -> torch.Tensor:
    """The unfused composition: GroupNorm affine and swish in fp32 with one
    rounding to x.dtype, then the SAME conv3x3 and its bias."""
    if gn_p is not None:
        x = swish(_group_norm_f32(gn_p, x, num_groups, eps)).to(x.dtype)
    return conv2d(conv_p, x)


def conv3x3_gn_swish_launch(conv_p: Dict, gn_p: Optional[Dict], x: torch.Tensor,
                            num_groups: int = 32, eps: float = 1e-6) -> torch.Tensor:
    """The forward on the card: ``gn_affine`` (when ``gn_p`` is given) and
    ``csrc/fused_conv.cu``'s conv on checked CUDA inputs, each counted; the
    output carries no gradient."""
    if x.dim() != 4:
        raise ValueError(f"conv3x3 input {tuple(x.shape)}: expected [B, H, W, C]")
    dtype = _cuda.dtype_code(x.dtype)
    b, h, w, c = x.shape
    kernel = conv_p["kernel"]
    if kernel.dim() != 4 or kernel.shape[:3] != (3, 3, c):
        raise ValueError(f"conv3x3 kernel {tuple(kernel.shape)} for input {tuple(x.shape)}")
    cout = kernel.shape[3]
    if conv_p["bias"].shape != (cout,):
        raise ValueError(f"conv3x3 bias {tuple(conv_p['bias'].shape)} for {cout} channels")
    for name, p in (("kernel", kernel), ("bias", conv_p["bias"])):
        if p.device != x.device:
            raise ValueError(f"conv3x3 {name} on {p.device}, input on {x.device}")
    x = x.contiguous()
    wt = kernel.to(dtype=x.dtype).contiguous()
    bias = conv_p["bias"].to(dtype=x.dtype).contiguous()
    ab = gn_affine(gn_p, x, num_groups, eps) if gn_p is not None else None
    out = torch.empty((b, h, w, cout), dtype=x.dtype, device=x.device)
    lib = _cuda.library("fused_conv")
    rc = lib.conv3x3_gn_swish_launch(
        dtype, x.data_ptr(), None if ab is None else ab.data_ptr(),
        wt.data_ptr(), bias.data_ptr(), out.data_ptr(), b, h, w, c, cout,
        _cuda.stream_of(x))
    _cuda.check(rc, "conv3x3_gn_swish_launch")
    conv3x3_gn_swish.launches += 1
    return out


def _params(kernel, bias, gn_scale, gn_bias):
    gn_p = None if gn_scale is None else {"scale": gn_scale, "bias": gn_bias}
    return {"kernel": kernel, "bias": bias}, gn_p


class _ConvGnSwish(torch.autograd.Function):
    """Forward: ``conv3x3_gn_swish_launch``. Backward: the gradients of
    ``conv3x3_gn_swish_plain`` recomputed from x and the parameters."""

    @staticmethod
    def forward(ctx, x, kernel, bias, gn_scale, gn_bias, num_groups, eps):
        ctx.save_for_backward(x, kernel, bias, gn_scale, gn_bias)
        ctx.num_groups, ctx.eps = num_groups, eps
        return conv3x3_gn_swish_launch(*_params(kernel, bias, gn_scale, gn_bias), x,
                                       num_groups, eps)

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        with torch.enable_grad():
            inputs = [None if t is None else t.detach().requires_grad_(need)
                      for t, need in zip(saved, ctx.needs_input_grad[:5])]
            x, kernel, bias, gn_scale, gn_bias = inputs
            out = conv3x3_gn_swish_plain(*_params(kernel, bias, gn_scale, gn_bias), x,
                                         ctx.num_groups, ctx.eps)
            wanted = [t for t in inputs if t is not None and t.requires_grad]
            got = iter(torch.autograd.grad(out, wanted, g))
        return (*(next(got) if t is not None and t.requires_grad else None for t in inputs),
                None, None)


def conv3x3_gn_swish(conv_p: Dict, gn_p: Optional[Dict], x: torch.Tensor,
                     num_groups: int = 32, eps: float = 1e-6) -> torch.Tensor:
    """``conv3x3(swish(group_norm(x)))``, or a plain conv3x3 when ``gn_p`` is None.

    x: [B, H, W, C]; conv_p: {"kernel": [3, 3, C, Cout], "bias": [Cout]}.
    Returns [B, H, W, Cout] in x.dtype, differentiable in x and every
    parameter on both devices."""
    if x.device.type == "cpu":
        return conv3x3_gn_swish_plain(conv_p, gn_p, x, num_groups, eps)
    gn = (None, None) if gn_p is None else (gn_p["scale"], gn_p["bias"])
    return _ConvGnSwish.apply(x, conv_p["kernel"], conv_p["bias"], *gn, num_groups, eps)


conv3x3_gn_swish.launches = 0
