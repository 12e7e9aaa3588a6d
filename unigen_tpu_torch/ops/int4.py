"""W4A8 dense layers: int4-packed weights, int8 activations.

Port of ``unigen_tpu/ops/int4.py``. The scheme and the byte layout are the
JAX package's, so a tree that JAX packed loads unchanged:

* weights: symmetric int4 per (group of ``group`` input rows, output
  column), ``w ~ w_int4 * scale4[g, n]``, clipped to [-7, 7];
* packing: within each group, row j of the low half and row j of the high
  half share one byte, ``(row j+half) << 4 | (row j & 0xF)``; N is padded to a
  multiple of 512 with zero columns; ``scale4`` is ``[K / group, Npad]`` fp32;
* a ``bias [N]`` is always present (zeros when the layer had none): it is
  the only record of the unpadded N;
* activations: dynamic per-token int8 (``ops.quantization``);
* accumulation: exact int32 per group, then ``acc += part * scale4[g]`` in
  fp32, group by group in order.

``dense_int4_prequant`` (the product with the epilogue ``* act_scale + bias``
and the cast inside the same launch, ``[T, n]``) and ``w4a8_matmul`` (the JAX
kernel's counterpart, fp32 ``[T, Npad]``: the same launch with scale 1 and a
zero bias) launch the hand-written kernel ``csrc/int4.cu`` on a CUDA tensor
and run their plain versions on a CPU tensor; the plain versions are also the
kernel's reference on the card. Both count their launches on
``w4a8_matmul.launches``.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from . import _cuda
from .quantization import QWEN2_PROJECTIONS, quantize_activations, quantize_layers

KEY = "kernel_int4"
_N_MULTIPLE = 512
# At T <= 16 a product with fewer 64-column tiles than this (about four
# blocks per SM of an H100) is split over its groups (csrc/int4.cu). On the
# card the split won at 140 tiles (the gate) and lost at 2,498 (the head);
# between them the threshold is an estimate.
_SPLIT_BELOW_TILES = 512


def pack_int4(w: torch.Tensor, group: int = 256) -> Tuple[torch.Tensor, torch.Tensor]:
    """[K, N] float -> (packed int8 [K // 2, Npad], scale4 fp32 [K // group, Npad]).

    Npad rounds N up to a multiple of 512; padded columns quantize zeros.
    K must be a multiple of the even ``group``. Bit-identical to JAX."""
    k, n = w.shape
    if k % group or group % 2:
        raise ValueError(f"K={k} must be a multiple of even group={group}")
    npad = -(-n // _N_MULTIPLE) * _N_MULTIPLE
    wf = w.float()
    if npad != n:
        wf = torch.nn.functional.pad(wf, (0, npad - n))
    g = k // group
    wg = wf.reshape(g, group, npad)
    scale = torch.clamp(wg.abs().amax(dim=1) / 7.0, min=1e-8)          # [g, Npad]
    q = torch.clamp(torch.round(wg / scale[:, None, :]), -7, 7).to(torch.int32)
    half = group // 2
    lo, hi = q[:, :half], q[:, half:]
    packed = ((hi << 4) | (lo & 0xF)).to(torch.int8)                    # wraps like JAX
    # contiguous whatever w's strides (a transposed [N, K] weight with N a multiple
    # of 512 would otherwise leave it transposed, and every launch would copy it)
    return packed.reshape(k // 2, npad).contiguous(), scale


def unpack_int4(packed: torch.Tensor, group: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """[K // 2, Npad] packed -> (lo, hi), each [K // group, group // 2, Npad]
    int32 in [-8, 7]: lo sign-extends the low nibble, hi is the arithmetic
    shift of the byte."""
    k2, npad = packed.shape
    half = group // 2
    p = packed.to(torch.int32).reshape(k2 // half, half, npad)
    return (p << 28) >> 28, p >> 4


def w4a8_matmul_plain(x_int8: torch.Tensor, packed: torch.Tensor, scale4: torch.Tensor,
                      *, group: int) -> torch.Tensor:
    """[T, K] int8 x packed [K // 2, Npad] -> [T, Npad] fp32, the kernel's
    arithmetic in plain torch. Each half-group product runs in float64 on
    integer values: exact whatever the device's fp32 matmul precision (the
    sums are integers below 2^24, so the fp32 cast of a group's part is exact
    too). The scales are folded in fp32 in group order, as the kernel does."""
    t, k = x_int8.shape
    groups, half = k // group, group // 2
    lo, hi = unpack_int4(packed, group)
    xg = x_int8.to(torch.float64).reshape(t, groups, 2, half)
    acc = torch.zeros((t, packed.shape[1]), dtype=torch.float32, device=x_int8.device)
    for g in range(groups):
        part = xg[:, g, 0] @ lo[g].to(torch.float64) + xg[:, g, 1] @ hi[g].to(torch.float64)
        acc = acc + part.float() * scale4[g][None, :]
    return acc


def splits_over_groups(t: int, n: int) -> bool:
    """Whether kernel 4 runs a [t, K] x [K, n] product (n stored columns)
    split over its groups (a part per group, then an ordered fold) rather than
    one block per 64 columns walking every group. Both give the same bits."""
    return t <= 16 and -(-n // 64) < _SPLIT_BELOW_TILES


def _dense_launch(x_int8: torch.Tensor, packed: torch.Tensor, scale4: torch.Tensor,
                  act_scale: torch.Tensor, bias: torch.Tensor, out_dtype, group: int,
                  split: bool) -> torch.Tensor:
    """The fused dense layer (``w4a8_dense_launch``) on checked, contiguous
    CUDA inputs, split over the groups or not: [T, n] in ``out_dtype``."""
    t, k = x_int8.shape
    npad, n = packed.shape[1], bias.shape[0]
    out = torch.empty((t, n), dtype=out_dtype, device=x_int8.device)
    # the split route's per-group parts of the stored columns
    scratch = (torch.empty((k // group, t, n), dtype=torch.float32, device=x_int8.device)
               if split else None)
    rc = _cuda.library("int4").w4a8_dense_launch(
        x_int8.data_ptr(), packed.data_ptr(), scale4.data_ptr(), act_scale.data_ptr(),
        bias.data_ptr(), _cuda.dtype_code(bias.dtype), out.data_ptr(),
        _cuda.dtype_code(out_dtype), None if scratch is None else scratch.data_ptr(),
        t, k, npad, n, group, _cuda.stream_of(x_int8))
    _cuda.check(rc, "w4a8_dense_launch")
    return out


def _check_product(what: str, x_int8: torch.Tensor, packed: torch.Tensor,
                   scale4: torch.Tensor, group: int) -> None:
    t, k = x_int8.shape
    n = packed.shape[1]
    if group <= 0 or group % 2 or k % group:
        raise ValueError(f"K={k} must be a multiple of even group={group}")
    if t < 1 or packed.shape != (k // 2, n) or scale4.shape != (k // group, n):
        raise ValueError(f"{what} shapes x {tuple(x_int8.shape)} packed "
                         f"{tuple(packed.shape)} scale4 {tuple(scale4.shape)} group {group}")
    if x_int8.dtype != torch.int8 or packed.dtype != torch.int8 or scale4.dtype != torch.float32:
        raise TypeError(f"{what} takes int8, int8, float32; got {x_int8.dtype}, "
                        f"{packed.dtype}, {scale4.dtype}")
    for a in (packed, scale4):
        if a.device != x_int8.device:
            raise ValueError(f"{what} inputs on {x_int8.device} and {a.device}")


def w4a8_matmul(x_int8: torch.Tensor, packed: torch.Tensor, scale4: torch.Tensor,
                *, group: int) -> torch.Tensor:
    """[T, K] int8 x int4-packed [K // 2, N] -> [T, N] fp32 with the group
    scales folded in. The caller applies the per-token activation scales and
    the bias. On the card: the fused launch with scale 1 and an fp32 zero
    bias, whose epilogue ``v * 1 + 0`` is exact."""
    if x_int8.device.type == "cpu":
        return w4a8_matmul_plain(x_int8, packed, scale4, group=group)
    _check_product("w4a8_matmul", x_int8, packed, scale4, group)
    t, n = x_int8.shape[0], packed.shape[1]
    ones = torch.ones((t,), dtype=torch.float32, device=x_int8.device)
    zeros = torch.zeros((n,), dtype=torch.float32, device=x_int8.device)
    out = _dense_launch(x_int8.contiguous(), packed.contiguous(), scale4.contiguous(), ones,
                        zeros, torch.float32, group, splits_over_groups(t, n))
    w4a8_matmul.launches += 1
    return out


w4a8_matmul.launches = 0


def quantize_dense_int4(p: Dict[str, torch.Tensor], group: int = 256) -> Dict[str, torch.Tensor]:
    """{'kernel': [K, N], 'bias'?} -> {'kernel_int4', 'scale4', 'bias'}; the
    bias is zeros (fp32) when the layer has none."""
    w = p["kernel"]
    packed, scale = pack_int4(w, group)
    bias = p.get("bias")
    if bias is None:
        bias = torch.zeros((w.shape[1],), dtype=torch.float32, device=w.device)
    return {KEY: packed, "scale4": scale, "bias": bias}


def dense_int4_prequant_plain(p: Dict[str, torch.Tensor], x_int8: torch.Tensor,
                              act_scale: torch.Tensor, out_dtype) -> torch.Tensor:
    """W4A8 matmul over pre-quantized activations (shared-input layers), with
    JAX's epilogue order: ``y[:, :n] * act_scale + bias.float()``, then cast."""
    n = p["bias"].shape[0]
    lead, k = x_int8.shape[:-1], x_int8.shape[-1]
    groups = p["scale4"].shape[-2]
    y = w4a8_matmul_plain(x_int8.reshape(-1, k), p[KEY], p["scale4"], group=k // groups)
    # scaled on the [T, n] view of the padded product: no copy of the slice
    y = y[:, :n] * act_scale.reshape(-1, 1)
    y = y + p["bias"].float()
    return y.reshape(*lead, n).to(out_dtype)


def dense_int4_prequant(p: Dict[str, torch.Tensor], x_int8: torch.Tensor,
                        act_scale: torch.Tensor, out_dtype) -> torch.Tensor:
    """``dense_int4_prequant_plain`` in one launch of ``csrc/int4.cu`` on a
    CUDA tensor: the epilogue runs in the kernel's store (or in the split
    route's ordered fold) and only the first n columns are written, in
    ``out_dtype`` (fp32 or bf16); the bias is read in its stored type."""
    if x_int8.device.type == "cpu":
        return dense_int4_prequant_plain(p, x_int8, act_scale, out_dtype)
    packed, scale4, bias = p[KEY], p["scale4"], p["bias"]
    lead, k = x_int8.shape[:-1], x_int8.shape[-1]
    x2 = x_int8.reshape(-1, k)
    t, npad, n = x2.shape[0], packed.shape[1], bias.shape[0]
    groups = scale4.shape[0] if scale4.dim() == 2 else 0
    group = k // groups if groups else 0
    _check_product("dense_int4_prequant", x2, packed, scale4, group)
    for dt in (bias.dtype, out_dtype):
        _cuda.dtype_code(dt)                                  # fp32 or bf16, else TypeError
    if bias.dim() != 1 or not 1 <= n <= npad or act_scale.numel() != t:
        raise ValueError(f"dense_int4_prequant: bias {tuple(bias.shape)} for {npad} columns, "
                         f"act_scale {tuple(act_scale.shape)} for {t} rows")
    if act_scale.dtype != torch.float32:
        raise TypeError(f"dense_int4_prequant: act_scale must be float32, got {act_scale.dtype}")
    for a in (act_scale, bias):
        if a.device != x2.device:
            raise ValueError(f"dense_int4_prequant inputs on {x2.device} and {a.device}")
    out = _dense_launch(x2.contiguous(), packed.contiguous(), scale4.contiguous(),
                        act_scale.contiguous(), bias.contiguous(), out_dtype, group,
                        splits_over_groups(t, n))
    w4a8_matmul.launches += 1
    return out.reshape(*lead, n)


def dense_int4(p: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """W4A8 matmul with dynamic per-token activation scales; returns x.dtype."""
    x_int8, act_scale = quantize_activations(x)
    return dense_int4_prequant(p, x_int8, act_scale, x.dtype)


def is_quantized_int4(p) -> bool:
    return isinstance(p, dict) and KEY in p


def quantize_qwen2_params_int4(params: Dict, group: int = 256) -> Dict:
    """Int4-pack every transformer dense layer of the port's Qwen2 params:
    each layer's ``<name>_w [N, K]`` (and ``<name>_b``) becomes ``<name>``:
    ``{'kernel_int4', 'scale4', 'bias'}``; norms and embeddings stay."""
    return dict(params, layers=quantize_layers(params["layers"], QWEN2_PROJECTIONS,
                                               lambda d: quantize_dense_int4(d, group)))


def quantize_unigen_params_int4(params: Dict, cfg=None, lm_head: bool = True,
                                group: int = 256) -> Dict:
    """Backbone (and, with ``cfg``, the text head as ``lm_head_q``) to W4A8;
    projectors, embeddings and norms stay in their float type."""
    from ..models import qwen2
    out = dict(params)
    out["llm"] = quantize_qwen2_params_int4(params["llm"], group)
    if lm_head and cfg is not None:
        out["llm"]["lm_head_q"] = quantize_dense_int4(
            {"kernel": qwen2.lm_head_weight(params["llm"], cfg.llm).t()}, group)
    return out
