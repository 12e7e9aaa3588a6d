"""Per-mask-rate-bucket entropy and cross-entropy diagnostics for masked-token
training.

Port of ``unigen_tpu/training/diagnostics.py`` (reference
models/training_utils.py:297-432): for each masking-rate bucket, the mean
prediction entropy and CE of the masked positions of the image block, in
fp32, on the logits' device; nothing is read back to the host.
"""
from __future__ import annotations

from typing import Dict

import torch


def masked_token_diagnostics(
    logits: torch.Tensor,      # [B, N, V] image-block logits
    labels: torch.Tensor,      # [B, N] codebook labels (-100 on unmasked)
    mask_prob: torch.Tensor,   # [B] per-sample masking rate
    num_buckets: int = 10,
) -> Dict[str, torch.Tensor]:
    """Per-bucket mean entropy / CE / token counts, each [num_buckets]."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    entropy = -(logp.exp() * logp).sum(-1)                                   # [B, N]

    valid = labels != -100
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]                   # [B, N]

    bucket = torch.clamp((mask_prob.float() * num_buckets).to(torch.int32), 0, num_buckets - 1)
    onehot = torch.nn.functional.one_hot(bucket.long(), num_buckets).float()  # [B, K]

    zero = torch.zeros((), dtype=torch.float32, device=logits.device)
    tok_per_sample = valid.sum(-1).float()                                   # [B]
    ent_per_sample = torch.where(valid, entropy, zero).sum(-1)
    nll_per_sample = torch.where(valid, nll, zero).sum(-1)

    counts = onehot.T @ tok_per_sample                                       # [K]
    ent = onehot.T @ ent_per_sample / torch.clamp(counts, min=1.0)
    ce = onehot.T @ nll_per_sample / torch.clamp(counts, min=1.0)
    return {"bucket_entropy": ent, "bucket_ce": ce, "bucket_tokens": counts}
