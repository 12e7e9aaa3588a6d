"""Dynamic per-token int8 activation quantization.

The port's copy of ``unigen_tpu/ops/quantization.py::quantize_activations``,
the one piece of the W8A8 module that the W4A8 path (``ops.int4``) needs.
Layers that share an input (q/k/v; gate/up) quantize it once.
"""
from __future__ import annotations

from typing import Tuple

import torch


def quantize_activations(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-token symmetric int8: (x_int8, act_scale [..., 1] fp32).

    fp32 math, ``max(|x|) / 127`` floored at 1e-8, round half to even (as
    ``jnp.round``), clipped to +-127: bit-identical to the JAX function.
    """
    xf = x.float()
    act_scale = torch.clamp(xf.abs().amax(dim=-1, keepdim=True) / 127.0, min=1e-8)
    x_int8 = torch.clamp(torch.round(xf / act_scale), -127, 127).to(torch.int8)
    return x_int8, act_scale
