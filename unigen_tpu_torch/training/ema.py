"""Exponential moving average of the parameters.

Port of ``unigen_tpu/training/ema.py``: the warm-up-ramped decay
``min(decay, 1 - (1 + s / inv_gamma) ** -power)`` (or ``(1 + s) / (10 + s)``),
computed on the device. The average is kept in each leaf's dtype and
updated in fp32: ``e * decay + (1 - decay) * p``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from ..weights import map_tree
from .optimizer import named_leaves


class EMAState(NamedTuple):
    params: Any            # a tree like the parameters, no autograd
    step: torch.Tensor     # int32 []


@dataclasses.dataclass(frozen=True)
class EMAConfig:
    decay: float = 0.9999
    min_decay: float = 0.0
    update_after_step: int = 0
    use_ema_warmup: bool = True
    inv_gamma: float = 1.0
    power: float = 2.0 / 3.0


def ema_init(params: Any) -> EMAState:
    device = next(named_leaves(params))[1].device
    return EMAState(map_tree(params, lambda t: t.detach().clone()),
                    torch.zeros((), dtype=torch.int32, device=device))


def ema_decay_at(cfg: EMAConfig, step) -> torch.Tensor:
    """The decay at ``step`` (int or int tensor), fp32."""
    s = torch.clamp(torch.as_tensor(step) - cfg.update_after_step - 1, min=0).to(torch.float32)
    if cfg.use_ema_warmup:
        decay = 1.0 - (1.0 + s / cfg.inv_gamma) ** -cfg.power
    else:
        decay = (1.0 + s) / (10.0 + s)
    decay = torch.where(s <= 0, torch.zeros_like(decay), decay)
    return torch.clamp(decay, cfg.min_decay, cfg.decay)


@torch.no_grad()
def ema_update(cfg: EMAConfig, state: EMAState, params: Any) -> EMAState:
    """Moves the average toward ``params`` in place; returns the new state."""
    decay = ema_decay_at(cfg, state.step + 1)
    for (_, e), (_, p) in zip(named_leaves(state.params), named_leaves(params)):
        e.copy_(e.float() * decay + (1.0 - decay) * p.float())
    return EMAState(state.params, state.step + 1)
