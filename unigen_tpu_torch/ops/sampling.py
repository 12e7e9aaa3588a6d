"""Sampling primitives for MaskGIT parallel decoding and text decoding.

Counterpart of ``unigen_tpu/ops/sampling.py``. Randomness comes from an
explicit ``torch.Generator`` in place of a JAX key; the ``noise=`` hooks take
pre-drawn uniforms so that both frameworks can be fed the same numbers.
``derived_generator`` stands in for ``jax.random.fold_in``.
"""
from __future__ import annotations

import math
from functools import partial
from typing import Callable, Optional

import numpy as np
import torch

_LOG_EPS = 1e-20


def derived_generator(seed: int, *index: int, device="cpu") -> torch.Generator:
    """A generator on ``device`` seeded from a fixed function of ``(seed,
    *index)`` (numpy's ``SeedSequence``), the stand-in for
    ``jax.random.fold_in``: the same seed and index give the same draws in
    every process and shard, whatever was drawn before. The seed and each
    index lie in [0, 2**64). SeedSequence splits a large int into 32-bit
    words and pads with zeros, so each value goes in as two words after the
    number of indices: no two keys share an entropy."""
    words = [len(index)]
    for v in (seed, *index):
        v = int(v)
        if not 0 <= v < 2 ** 64:
            raise ValueError(f"derived_generator takes values in [0, 2**64), got {v}")
        words += [v & 0xFFFFFFFF, v >> 32]
    state = np.random.SeedSequence(words).generate_state(1, np.uint64)[0]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(state))
    return gen


def safe_log(t: torch.Tensor, eps: float = _LOG_EPS) -> torch.Tensor:
    """log with the input clamped away from zero."""
    return torch.log(torch.clamp(t, min=eps))


def gumbel_noise(generator: Optional[torch.Generator], shape, device,
                 dtype=torch.float32) -> torch.Tensor:
    """Standard Gumbel noise -log(-log(U)), U ~ uniform[0, 1)."""
    u = torch.rand(shape, generator=generator, device=device, dtype=dtype)
    return -safe_log(-safe_log(u))


def sample_categorical(generator: Optional[torch.Generator], probs: torch.Tensor,
                       noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Indices drawn from (possibly unnormalized) ``probs`` by the Gumbel-max
    trick over log-probabilities. ``noise``: optional uniform[0, 1) of
    probs.shape used instead of the generator (the shared-noise hook)."""
    if noise is not None:
        g = -safe_log(-safe_log(noise.to(probs.dtype)))
    else:
        g = gumbel_noise(generator, probs.shape, probs.device, probs.dtype)
    return torch.argmax(safe_log(probs) + g, dim=-1)


def mask_by_random_topk(generator: Optional[torch.Generator], mask_len: torch.Tensor,
                        probs: torch.Tensor, temperature=1.0,
                        noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[B, N] bool: True where the token is re-masked for the next MaskGIT step.

    ``mask_len``: [B, 1] number of tokens to re-mask per row; ``probs``: [B, N]
    confidences; ``noise``: optional uniform[0, 1) [B, N] used instead of the
    generator (the shared-noise hook).
    """
    if noise is not None:
        g = -safe_log(-safe_log(noise.to(probs.dtype)))
    else:
        g = gumbel_noise(generator, probs.shape, probs.device, probs.dtype)
    confidence = safe_log(probs) + temperature * g
    sorted_confidence = torch.sort(confidence, dim=-1).values
    cut_off = torch.gather(sorted_confidence, -1, mask_len.long())
    return confidence < cut_off


def cosine_schedule(t: torch.Tensor) -> torch.Tensor:
    return torch.cos(t * math.pi * 0.5)


def linear_schedule(t: torch.Tensor) -> torch.Tensor:
    return torch.clamp(1.0 - t, 1e-6, 1.0)


def pow_schedule(t: torch.Tensor, exponent: float) -> torch.Tensor:
    return torch.clamp(1.0 - t ** exponent, 1e-6, 1.0)


def sigmoid_schedule(t: torch.Tensor, start: float = -3.0, end: float = 3.0,
                     tau: float = 1.0, clip_min: float = 1e-6) -> torch.Tensor:
    v_start = torch.sigmoid(torch.tensor(start / tau, dtype=torch.float32))
    v_end = torch.sigmoid(torch.tensor(end / tau, dtype=torch.float32))
    output = torch.sigmoid((t * (end - start) + start) / tau)
    output = (v_end.to(t.device) - output) / (v_end - v_start).to(t.device)
    return torch.clamp(output, clip_min, 1.0)


def get_mask_schedule(method: str, **schedule_kwargs) -> Callable[[torch.Tensor], torch.Tensor]:
    """Dispatch by name, including the 'powN' spelling."""
    if method == "cosine":
        return cosine_schedule
    if method == "linear":
        return linear_schedule
    if "pow" in method:
        return partial(pow_schedule, exponent=float(method.replace("pow", "")))
    if method == "sigmoid":
        return partial(sigmoid_schedule, **schedule_kwargs)
    raise ValueError(f"Unknown schedule method: {method}")
