"""Dynamic per-token int8 activation quantization.

The port's copy of ``unigen_tpu/ops/quantization.py::quantize_activations``,
the one piece of the W8A8 module that the W4A8 path (``ops.int4``) needs.
Layers that share an input (q/k/v; gate/up) quantize it once.

``quantize_activations`` launches the hand-written kernel in
``csrc/int4.cu`` (one block a token) on a CUDA tensor and runs
``quantize_activations_plain`` on a CPU tensor; the plain version is also the
kernel's reference on the card.
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import _cuda


def quantize_activations_plain(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-token symmetric int8: (x_int8, act_scale [..., 1] fp32).

    fp32 math, ``max(|x|) / 127`` floored at 1e-8, round half to even (as
    ``jnp.round``), clipped to +-127: bit-identical to the JAX function. The
    divisor 127 is a tensor on x's device: on CUDA, torch divides by a Python
    scalar as a multiplication by its reciprocal, which is not IEEE division.
    """
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    act_scale = torch.clamp(amax / torch.full((), 127.0, device=x.device), min=1e-8)
    x_int8 = torch.clamp(torch.round(xf / act_scale), -127, 127).to(torch.int8)
    return x_int8, act_scale


def quantize_activations(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-token symmetric int8 of x [..., K] (fp32 or bf16): (x_int8 [..., K],
    act_scale [..., 1] fp32), bit-identical to ``quantize_activations_plain``."""
    if x.device.type == "cpu":
        return quantize_activations_plain(x)
    code = _cuda.dtype_code(x.dtype)
    k = x.shape[-1] if x.dim() else 0
    if k < 1 or x.numel() == 0:
        raise ValueError(f"quantize_activations takes [..., K] with K >= 1, got {tuple(x.shape)}")
    x = x.contiguous()
    x_int8 = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    act_scale = torch.empty((*x.shape[:-1], 1), dtype=torch.float32, device=x.device)
    rc = _cuda.library("int4").quantize_activations_launch(
        code, x.data_ptr(), x_int8.data_ptr(), act_scale.data_ptr(),
        x.numel() // k, k, _cuda.stream_of(x))
    _cuda.check(rc, "quantize_activations_launch")
    quantize_activations.launches += 1
    return x_int8, act_scale


quantize_activations.launches = 0
