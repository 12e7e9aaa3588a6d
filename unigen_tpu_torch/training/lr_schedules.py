"""Learning-rate schedules: step -> scale of the base learning rate.

The port's copy of ``unigen_tpu/training/lr_schedules.py`` (the reference's
HF-style set), in fp32 on a tensor: the step may be a Python int or a
device tensor (the optimizer's update count), and the result is a float32
tensor on the step's device, so a schedule never reads the card back.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch

Schedule = Callable


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def constant_schedule(**_):
    return lambda step: torch.ones_like(_f32(step))


def constant_with_warmup(num_warmup_steps: int, **_):
    def fn(step):
        step = _f32(step)
        return torch.where(step < num_warmup_steps, step / max(1.0, num_warmup_steps),
                           torch.ones_like(step))
    return fn


def linear_with_warmup(num_warmup_steps: int, num_training_steps: int, **_):
    def fn(step):
        step = _f32(step)
        warm = step / max(1, num_warmup_steps)
        decay = torch.clamp((num_training_steps - step)
                            / max(1, num_training_steps - num_warmup_steps), min=0.0)
        return torch.where(step < num_warmup_steps, warm, decay)
    return fn


def cosine_with_warmup(num_warmup_steps: int, num_training_steps: int,
                       num_cycles: float = 0.5, min_scale: float = 0.0, **_):
    """Half-cosine decay with a min_scale floor."""
    def fn(step):
        step = _f32(step)
        warm = step / max(1, num_warmup_steps)
        progress = (step - num_warmup_steps) / max(1, num_training_steps - num_warmup_steps)
        cos = min_scale + 0.5 * (1.0 - min_scale) * (
            1.0 + torch.cos(math.pi * num_cycles * 2.0 * progress))
        return torch.where(step < num_warmup_steps, warm, torch.clamp(cos, min=min_scale))
    return fn


def cosine_with_hard_restarts(num_warmup_steps: int, num_training_steps: int,
                              num_cycles: int = 1, **_):
    def fn(step):
        step = _f32(step)
        warm = step / max(1, num_warmup_steps)
        progress = (step - num_warmup_steps) / max(1, num_training_steps - num_warmup_steps)
        cyc = torch.clamp(0.5 * (1.0 + torch.cos(math.pi * torch.remainder(
            num_cycles * progress, 1.0))), min=0.0)
        decay = torch.where(progress >= 1.0, torch.zeros_like(cyc), cyc)
        return torch.where(step < num_warmup_steps, warm, decay)
    return fn


def polynomial_with_warmup(num_warmup_steps: int, num_training_steps: int,
                           lr_init: float, lr_end: float = 1e-7, power: float = 1.0, **_):
    if not lr_init > lr_end:
        raise ValueError(f"lr_end ({lr_end}) must be smaller than initial lr ({lr_init})")

    def fn(step):
        step = _f32(step)
        warm = step / max(1, num_warmup_steps)
        lr_range = lr_init - lr_end
        decay_steps = num_training_steps - num_warmup_steps
        pct_remaining = 1 - (step - num_warmup_steps) / decay_steps
        decay = (lr_range * pct_remaining ** power + lr_end) / lr_init
        out = torch.where(step > num_training_steps,
                          torch.full_like(decay, lr_end / lr_init), decay)
        return torch.where(step < num_warmup_steps, warm, out)
    return fn


_SCHEDULES = {
    "constant": constant_schedule,
    "constant_with_warmup": constant_with_warmup,
    "linear": linear_with_warmup,
    "cosine": cosine_with_warmup,
    "cosine_with_restarts": cosine_with_hard_restarts,
    "polynomial": polynomial_with_warmup,
}


def get_scheduler(name: str, num_warmup_steps: Optional[int] = None,
                  num_training_steps: Optional[int] = None, **kwargs) -> Schedule:
    """Dispatch by name, as the JAX package's ``get_scheduler``."""
    if name not in _SCHEDULES:
        raise ValueError(f"Unknown scheduler {name}")
    if name == "constant":
        return constant_schedule()
    if num_warmup_steps is None:
        raise ValueError(f"{name} requires num_warmup_steps")
    if name == "constant_with_warmup":
        return constant_with_warmup(num_warmup_steps, **kwargs)
    if num_training_steps is None:
        raise ValueError(f"{name} requires num_training_steps")
    return _SCHEDULES[name](num_warmup_steps=num_warmup_steps,
                            num_training_steps=num_training_steps, **kwargs)
