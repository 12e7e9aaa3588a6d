"""In-training visual checks.

Port of ``unigen_tpu/training/visualization.py`` (reference train.py:847-875):
periodic image generation (``generate_images``, :969-1084) and
[original | VQ reconstruction | model prediction] triptychs
(``visualize_predictions``, :892-967), returned as uint8 arrays;
``save_image_grid`` writes them as one PNG with
``evaluation/geneval.png_bytes`` (no PIL).

The prediction's forward runs kernel 2 on the t2i bits of ``ops.masks``
(``t2i_attn_meta``), as the train step does, where JAX builds the dense
``create_attention_mask_predict_next`` mask: only the rows of pad queries
differ, and no image-block logit reads them (ROADMAP, "Deliberate
differences"). The encode and both decodes run the VQ model (kernel 3 on the
card) in its own dtype.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..evaluation.geneval import png_bytes
from ..models import magvit, unigen
from ..models.magvit import MagvitConfig
from ..models.unigen import UniGenConfig
from ..ops import masking as MK
from ..ops import masks as M
from ..ops import sampling as S
from ..pipeline import UniGenPipeline, pixels_to_uint8


def generate_images(pipeline: UniGenPipeline, validation_prompts: Sequence[str],
                    generator: Optional[torch.Generator], *, guidance_scale: float = 2.0,
                    timesteps: int = 16, max_text_len: int = 128) -> np.ndarray:
    """Training-time sample generation at the train-time protocol (guidance 2.0,
    16 steps: reference configs/unigen_1_5b/unigen_pt1.yaml:99-100)."""
    px = pipeline.generate_images(list(validation_prompts), generator,
                                  guidance_scale=guidance_scale, timesteps=timesteps,
                                  max_text_len=max_text_len)
    return pixels_to_uint8(px)


@torch.no_grad()
def visualize_predictions(
    params,
    cfg: UniGenConfig,
    vq_params,
    vq_cfg: MagvitConfig,
    pixels: torch.Tensor,      # [B, H, W, 3] the training batch images
    input_ids: torch.Tensor,   # [B, L] the (masked) t2i training sequences
    pad_id: int, soi_id: int, eoi_id: int,
    specs=None,
) -> np.ndarray:
    """[original | VQ reconstruction | model argmax prediction] triptychs
    (reference: train.py:892-967). Returns [B, H, 3W, 3] uint8. ``specs``:
    the spec tree of a sharded ``params``."""
    n = cfg.num_vq_tokens
    codes = magvit.get_code(vq_params, vq_cfg, pixels)
    recon = magvit.decode_code(vq_params, vq_cfg, codes)

    bits = M.pack_meta(M.t2i_attn_meta(input_ids, pad_id, soi_id, eoi_id))
    logits = unigen.forward(params, cfg, input_ids=input_ids, meta_bits=bits,
                            batch_size_t2i=input_ids.shape[0], specs=specs)
    img_logits = logits[:, -(n + 1):-1]
    if not cfg.use_gen_projector:
        img_logits = img_logits[..., cfg.text_vocab_len:cfg.text_vocab_len + cfg.codebook_size]
    pred = torch.argmax(img_logits, dim=-1)
    # keep the known tokens; predict only the masked ones (reference :930-940)
    block = input_ids[:, -(n + 1):-1]
    known = block if cfg.use_gen_projector else \
        torch.clamp(block - cfg.text_vocab_len, 0, cfg.codebook_size - 1)
    predicted = magvit.decode_code(vq_params, vq_cfg,
                                   torch.where(block == cfg.mask_token_id, pred, known))

    trip = torch.cat([pixels, recon.to(pixels.dtype), predicted.to(pixels.dtype)], dim=2)
    return pixels_to_uint8(trip)


@torch.no_grad()
def masked_t2i_inputs(vq_params, vq_cfg: MagvitConfig, cfg: UniGenConfig,
                      template: torch.Tensor, pixels: torch.Tensor,
                      key: "MK.MaskDraws | torch.Generator | None", *,
                      mask_schedule: str = "cosine",
                      min_masking_rate: float = 0.0) -> torch.Tensor:
    """Rebuild the train step's masked t2i sequence for visualization:
    VQ-encode the batch images, MaskGIT-corrupt them (``key``: a generator,
    or JAX's draws as ``MaskDraws``), splice them into the prompt template at
    the image slot (the layout of ``train_step.TrainStep.build_inputs``)."""
    n = cfg.num_vq_tokens
    codes = magvit.get_code(vq_params, vq_cfg, pixels)
    masked = MK.mask_or_random_replace_tokens(
        key, codes, cfg.codebook_size, S.get_mask_schedule(mask_schedule),
        min_masking_rate=min_masking_rate, codebook_size=cfg.codebook_size)
    img = masked.input_ids
    if not cfg.use_gen_projector:
        img = torch.where(img == cfg.codebook_size, torch.full_like(img, cfg.mask_token_id),
                          img + cfg.text_vocab_len)
    start = template.shape[1] - n - 1
    return torch.cat([template[:, :start], img.to(template.dtype),
                      template[:, start + n:]], dim=1)


def save_image_grid(images: np.ndarray, path: str, cols: Optional[int] = None) -> None:
    """uint8 [B, H, W, 3] -> one grid PNG."""
    b, h, w, _ = images.shape
    cols = cols or min(b, 4)
    rows = (b + cols - 1) // cols
    canvas = np.zeros((rows * h, cols * w, 3), np.uint8)
    for i in range(b):
        r, c = divmod(i, cols)
        canvas[r * h:(r + 1) * h, c * w:(c + 1) * w] = images[i]
    with open(path, "wb") as f:
        f.write(png_bytes(canvas))
