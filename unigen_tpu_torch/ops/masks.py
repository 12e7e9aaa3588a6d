"""Attention masks for the unified text/image token sequences.

Counterpart of ``unigen_tpu/ops/masks.py`` (the parts the t2i, the discrete
and the SigLIP understanding paths use) and
of the kernel bitfield in ``unigen_tpu/ops/flash_attention.py::pack_meta``:

    visible(q, k) = ~pad[q] & ~pad[k] & (k <= q | bidir_q[q] | bidir_k[k])
                    & seg[q] == seg[k]

Boolean masks are True where visible.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

PAD_BIT, BIDIRQ_BIT, BIDIRK_BIT = 1, 2, 4
SEG_SHIFT = 3  # packed-segment id lives in bits [3, 31]


class AttnMeta(NamedTuple):
    """Per-token attention metadata, the kernel-side replacement for [L, L] masks."""
    pad: torch.Tensor      # [B, L] bool: token is padding
    bidir_q: torch.Tensor  # [B, L] bool: query attends bidirectionally
    bidir_k: torch.Tensor  # [B, L] bool: key visible to all queries
    seg: Optional[torch.Tensor] = None  # [B, L] int32 packed-segment id

    def visibility(self) -> torch.Tensor:
        """Materialize [B, 1, L, L] bool."""
        pos = torch.arange(self.pad.shape[-1], device=self.pad.device)
        causal = pos[:, None] >= pos[None, :]
        vis = causal[None] | self.bidir_q[:, :, None] | self.bidir_k[:, None, :]
        vis = vis & ~self.pad[:, :, None] & ~self.pad[:, None, :]
        if self.seg is not None:
            vis = vis & (self.seg[:, :, None] == self.seg[:, None, :])
        return vis[:, None]


def image_segments(input_ids: torch.Tensor, soi_id: int, eoi_id: int) -> torch.Tensor:
    """[B, L] bool: token lies in an [soi..eoi] image segment, inclusive."""
    is_soi = input_ids == soi_id
    is_eoi = input_ids == eoi_id
    cum_soi = torch.cumsum(is_soi.long(), dim=1)
    cum_eoi = torch.cumsum(is_eoi.long(), dim=1)
    return (cum_soi > cum_eoi) | is_soi | is_eoi


def lm_attn_meta(input_ids: torch.Tensor, pad_id: Optional[int]) -> AttnMeta:
    """Plain causal with pad exclusion as metadata (no pads when pad_id is None)."""
    pad = (input_ids == pad_id) if pad_id is not None else torch.zeros_like(
        input_ids, dtype=torch.bool)
    z = torch.zeros_like(pad)
    return AttnMeta(pad=pad, bidir_q=z, bidir_k=z)


def t2i_attn_meta(input_ids: torch.Tensor, pad_id: int, soi_id: int,
                  eoi_id: int) -> AttnMeta:
    """Causal text, bidirectional image block."""
    in_img = image_segments(input_ids, soi_id, eoi_id)
    pad = input_ids == pad_id
    return AttnMeta(pad=pad, bidir_q=in_img & ~pad, bidir_k=torch.zeros_like(pad))


def mmu_attn_meta(input_ids: torch.Tensor, eoi_id: int,
                  prompt_len: torch.Tensor) -> AttnMeta:
    """Metadata form of the JAX package's ``create_attention_mask_for_mmu``
    and the prompt-length keep mask: causal, with every column up to and
    including each row's first ``<|eoi|>`` (task tokens and the image block)
    visible to all queries; pad at and beyond each row's ``prompt_len`` (not
    from the pad id). On every non-pad query row it equals the dense
    ``(causal | prefix) & keep_q & keep_k``."""
    pos = torch.arange(input_ids.shape[-1], device=input_ids.device)[None]
    eoi_pos = torch.argmax((input_ids == eoi_id).to(torch.int32), dim=-1, keepdim=True)
    pad = pos >= prompt_len.to(input_ids.device)[:, None]
    return AttnMeta(pad=pad, bidir_q=torch.zeros_like(pad), bidir_k=(pos <= eoi_pos) & ~pad)


def mmu_vit_attn_meta(batch_size: int, seq_len: int, *, num_tokens: int,
                      prefix_length: int, prompt_len: Optional[torch.Tensor] = None,
                      device=None) -> AttnMeta:
    """Metadata form of the JAX package's ``create_attention_mask_for_mmu_vit``
    (int ``num_tokens``) and the prompt-length keep mask: bidir_k on the continuous-image block
    [prefix_length, prefix_length + num_tokens), pad at and beyond each row's
    ``prompt_len``. On every non-pad query row it equals the dense
    ``(causal | block) & keep_q & keep_k``; pad query rows see nothing here
    (they are never visible to a real query)."""
    if prompt_len is not None:
        device = prompt_len.device
    pos = torch.arange(seq_len, device=device)[None].expand(batch_size, seq_len)
    block = (pos >= prefix_length) & (pos < prefix_length + num_tokens)
    pad = (pos >= prompt_len[:, None]) if prompt_len is not None else torch.zeros_like(block)
    return AttnMeta(pad=pad, bidir_q=torch.zeros_like(pad), bidir_k=block & ~pad)


def pack_meta(meta: AttnMeta) -> torch.Tensor:
    """AttnMeta -> [B, L] int32 bitfield consumed by the flash kernel."""
    bits = (meta.pad.to(torch.int32) * PAD_BIT
             + meta.bidir_q.to(torch.int32) * BIDIRQ_BIT
             + meta.bidir_k.to(torch.int32) * BIDIRK_BIT)
    if meta.seg is not None:
        bits = bits + (meta.seg.to(torch.int32) << SEG_SHIFT)
    return bits.to(torch.int32)


def unpack_meta(bits: torch.Tensor) -> AttnMeta:
    """Inverse of ``pack_meta``."""
    return AttnMeta(pad=(bits & PAD_BIT) != 0, bidir_q=(bits & BIDIRQ_BIT) != 0,
                    bidir_k=(bits & BIDIRK_BIT) != 0, seg=bits >> SEG_SHIFT)


def create_attention_mask_predict_next(
    input_ids: torch.Tensor,
    pad_id: int,
    soi_id: int,
    eoi_id: int,
    rm_pad_in_image: bool = False,
) -> torch.Tensor:
    """The t2i 'omni' block mask: [B, 1, L, L] bool.

    Text tokens are causal; tokens inside [soi..eoi] image segments attend to
    every token; with ``rm_pad_in_image`` the left-padding columns are removed
    for post-pad text rows and for image rows at/after the soi position.
    """
    n, l = input_ids.shape
    dev = input_ids.device
    is_pad = input_ids == pad_id
    in_img = image_segments(input_ids, soi_id, eoi_id)
    is_text = ~in_img

    pos = torch.arange(l, device=dev)
    causal = pos[:, None] >= pos[None, :]
    mask_text = is_text[:, :, None] & causal[None]
    mask_bi = torch.ones((n, l, l), dtype=torch.bool, device=dev)

    if rm_pad_in_image:
        has_pad = is_pad.any(dim=1)
        # last padding index per row (left padding): argmax of the reversed flags
        last_pad = (l - 1) - torch.argmax(torch.flip(is_pad, [1]).to(torch.int32), dim=1)
        q_after_pad = pos[None, :, None] > last_pad[:, None, None]
        k_in_pad_block = pos[None, None, :] <= last_pad[:, None, None]
        rm_text = has_pad[:, None, None] & q_after_pad & k_in_pad_block
        mask_text = mask_text & ~rm_text
        soi_pos = torch.argmax((input_ids == soi_id).to(torch.int32), dim=1)
        q_after_soi = pos[None, :, None] >= soi_pos[:, None, None]
        rm_img = q_after_soi & is_pad[:, None, :]
        mask_bi = mask_bi & ~rm_img

    mask = torch.where(in_img[:, :, None], mask_bi, mask_text)
    return mask[:, None]
