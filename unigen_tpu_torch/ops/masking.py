"""Training-time token corruption for MaskGIT-style masked-token prediction.

Port of ``unigen_tpu/ops/masking.py``: vectorized over the batch, the
contiguous-rectangle mask by broadcast comparisons, ``noise_type`` honoured
(``mask`` or ``random_replace``).

Randomness: JAX splits one key into five streams; here every draw comes from
an explicit ``torch.Generator`` through ``draw_masking``, or is handed in as
a ``MaskDraws`` (the way the samplers take ``noise=``). Given JAX's draws
(``jax.random.uniform`` of its timestep, choice and mask keys, its
replacement tokens and eval indices), the tokens equal JAX's.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch


class MaskedTokens(NamedTuple):
    input_ids: torch.Tensor              # [B, N] corrupted tokens
    labels: torch.Tensor                 # [B, N] targets (-100 on unmasked unless predict_all)
    loss_weight: Optional[torch.Tensor]  # [B, N] or None
    mask_prob: torch.Tensor              # [B] per-sample masking rate


class MaskDraws(NamedTuple):
    """The random inputs of one ``mask_or_random_replace_tokens`` call."""
    timesteps: torch.Tensor              # [B] uniform [0, 1): the schedule's t
    scores: torch.Tensor                 # [B, N] uniform: the random mask's ranks
    replace: Optional[torch.Tensor] = None   # [B, N] int tokens for random_replace
    choice: Optional[torch.Tensor] = None    # [] uniform: contiguous or random mask
    rect: Optional[torch.Tensor] = None      # [3, B] uniform: height, row and column start
    eval_idx: Optional[torch.Tensor] = None  # [B] int index into eval_mask_ratios


def draw_masking(generator: Optional[torch.Generator], batch_size: int, seq_len: int, *,
                 codebook_size: int = 8192, n_eval_ratios: int = 0,
                 device=None) -> MaskDraws:
    """Every draw a call may need, from ``generator`` on ``device``."""
    def uniform(*shape):
        return torch.rand(shape, generator=generator, device=device)
    return MaskDraws(
        timesteps=uniform(batch_size), scores=uniform(batch_size, seq_len),
        replace=torch.randint(0, codebook_size, (batch_size, seq_len), generator=generator,
                              device=device),
        choice=uniform(), rect=uniform(3, batch_size),
        eval_idx=(torch.randint(0, n_eval_ratios, (batch_size,), generator=generator,
                                device=device) if n_eval_ratios else None))


def _loss_weight(t: torch.Tensor, mask: torch.Tensor, min_val: float = 0.3) -> torch.Tensor:
    """Per-token loss weight."""
    return 1.0 - (1.0 - mask) * ((1.0 - t) * (1.0 - min_val))[:, None]


def _random_mask(scores: torch.Tensor, num_masked: torch.Tensor) -> torch.Tensor:
    """The ``num_masked`` positions of each row with the smallest scores."""
    rank = torch.argsort(torch.argsort(scores, dim=-1, stable=True), dim=-1, stable=True)
    return rank < num_masked[:, None]


def _contiguous_mask(rect: torch.Tensor, seq_len: int, num_masked: torch.Tensor
                     ) -> torch.Tensor:
    """A rectangle of ~num_masked tokens on the sqrt(N) grid."""
    resolution = int(seq_len ** 0.5)
    b = num_masked.shape[0]
    n = num_masked.to(torch.int32)
    h_lo = torch.ceil(n / resolution).to(torch.int32)
    h_hi = torch.clamp(n, max=resolution)
    height = h_lo + (rect[0] * (h_hi - h_lo + 1)).to(torch.int32)     # randint [h_lo, h_hi]
    height = torch.clamp(height, max=resolution)
    width = torch.clamp(torch.ceil(n / height).to(torch.int32), max=resolution)
    sh = (rect[1] * (resolution - height + 1)).to(torch.int32)
    sw = (rect[2] * (resolution - width + 1)).to(torch.int32)
    idx = torch.arange(resolution, device=rect.device)
    rows, cols = idx[None, :, None], idx[None, None, :]
    in_rect = ((rows >= sh[:, None, None]) & (rows < (sh + height)[:, None, None])
               & (cols >= sw[:, None, None]) & (cols < (sw + width)[:, None, None]))
    return in_rect.reshape(b, seq_len)


def mask_or_random_replace_tokens(
    draws: "MaskDraws | torch.Generator | None",
    image_tokens: torch.Tensor,
    mask_id: int,
    mask_schedule: Callable[[torch.Tensor], torch.Tensor],
    *,
    min_masking_rate: float = 0.0,
    mask_contiguous_region_prob: Optional[float] = None,
    noise_type: str = "mask",
    predict_all_tokens: bool = False,
    codebook_size: int = 8192,
    eval_mask_ratios: Optional[list] = None,
    is_train: bool = True,
    ignore_id: int = -100,
) -> MaskedTokens:
    """Corrupt VQ tokens [B, N] for masked-token training. ``draws`` is a
    ``MaskDraws`` or a generator to draw one from (``draw_masking``)."""
    b, seq_len = image_tokens.shape
    dev = image_tokens.device
    if not isinstance(draws, MaskDraws):
        draws = draw_masking(draws, b, seq_len, codebook_size=codebook_size,
                             n_eval_ratios=len(eval_mask_ratios or ()), device=dev)
    if not is_train and eval_mask_ratios:
        mask_prob = torch.as_tensor(eval_mask_ratios, dtype=torch.float32,
                                    device=dev)[draws.eval_idx]
    else:
        mask_prob = torch.clamp(mask_schedule(draws.timesteps), min=min_masking_rate)

    num_token_masked = torch.clamp(torch.round(seq_len * mask_prob), min=1.0)

    if mask_contiguous_region_prob is None or mask_contiguous_region_prob == 0.0:
        mask = _random_mask(draws.scores, num_token_masked)
    else:
        # both candidates on the device and a select: no read-back of the choice
        mask = torch.where(draws.choice < mask_contiguous_region_prob,
                           _contiguous_mask(draws.rect, seq_len, num_token_masked),
                           _random_mask(draws.scores, num_token_masked))

    if noise_type == "mask":
        input_ids = torch.where(mask, torch.full_like(image_tokens, mask_id), image_tokens)
    elif noise_type == "random_replace":
        input_ids = torch.where(mask, draws.replace.to(image_tokens.dtype), image_tokens)
    else:
        raise ValueError(f"noise_type {noise_type} not supported")

    if predict_all_tokens or noise_type == "random_replace":
        labels = image_tokens
        loss_weight = _loss_weight(mask_prob, mask.float())
    else:
        labels = torch.where(mask, image_tokens, torch.full_like(image_tokens, ignore_id))
        loss_weight = None
    return MaskedTokens(input_ids, labels, loss_weight, mask_prob)
