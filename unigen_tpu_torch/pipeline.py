"""High-level inference pipeline: prompts -> images.

Port of ``unigen_tpu/pipeline.py::UniGenPipeline.generate_images`` (mode
``"mask"``), ``decode_codes`` and ``pixels_to_uint8``: host-side prompt
assembly, the MaskGIT sampler, then the MAGViTv2 decoder, all on the
pipeline's device.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch

from .generation import t2i_generate
from .models import magvit, unigen
from .ops import masks as M
from .ops import sampling as S
from .prompting import UniPrompting
from .weights import tree_to


@torch.no_grad()
def _generate_codes(params, cfg, ids, uncond_ids, generator, *, pad_id, soi_id, eoi_id,
                    guidance_scale, timesteps, temperature, mask_schedule, noise=None):
    both = torch.cat([ids, uncond_ids], dim=0)
    attn = M.create_attention_mask_predict_next(both, pad_id=pad_id, soi_id=soi_id,
                                                eoi_id=eoi_id, rm_pad_in_image=True)
    if guidance_scale <= 1:
        attn = attn[: ids.shape[0]]
    return t2i_generate(params, cfg, generator, ids, attn, uncond_input_ids=uncond_ids,
                        temperature=temperature, timesteps=timesteps,
                        guidance_scale=guidance_scale,
                        noise_schedule=S.get_mask_schedule(mask_schedule),
                        pad_id=pad_id, noise=noise)


@dataclasses.dataclass
class UniGenPipeline:
    params: Any
    cfg: unigen.UniGenConfig
    vq_params: Any
    vq_cfg: magvit.MagvitConfig
    prompting: UniPrompting
    device: torch.device

    def to(self, device) -> "UniGenPipeline":
        """A pipeline with every parameter moved to ``device``."""
        device = torch.device(device)
        return dataclasses.replace(self, params=tree_to(self.params, device),
                                   vq_params=tree_to(self.vq_params, device), device=device)

    def prompt_ids(self, prompts: Sequence[str], max_text_len: int = 128
                   ) -> Tuple[np.ndarray, np.ndarray]:
        """(cond ids, uncond ids), each [B, L] int64, for the t2i_gen task."""
        n = self.cfg.num_vq_tokens
        mask_img = np.full((len(prompts), n), self.cfg.mask_token_id, np.int64)
        ids, _ = self.prompting((list(prompts), mask_img, max_text_len), "t2i_gen")
        uncond_ids, _ = self.prompting(([""] * len(prompts), mask_img, max_text_len),
                                       "t2i_gen")
        return ids, uncond_ids

    def generate_images(
        self,
        prompts: Sequence[str],
        generator: Optional[torch.Generator],
        *,
        guidance_scale: float = 6.0,
        timesteps: int = 50,
        temperature: float = 1.0,
        max_text_len: int = 128,
        mask_schedule: str = "cosine",
        mode: str = "mask",
        return_codes: bool = False,
        noise: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    ) -> torch.Tensor:
        """prompts -> pixels in [-1, 1], [B, H, W, 3] (GenEval protocol
        defaults: guidance 6, 50 steps, 128-token text budget). ``generator``
        lives on the pipeline's device; ``noise`` is the shared-noise hook of
        ``t2i_generate``."""
        if mode != "mask":
            raise NotImplementedError(f"mode {mode!r} is not ported yet; only 'mask'")
        ids, uncond_ids = self.prompt_ids(prompts, max_text_len)
        sp = self.prompting.sptids_dict
        codes = _generate_codes(
            self.params, self.cfg, torch.as_tensor(ids, device=self.device),
            torch.as_tensor(uncond_ids, device=self.device), generator,
            pad_id=self.prompting.pad_id, soi_id=sp["<|soi|>"], eoi_id=sp["<|eoi|>"],
            guidance_scale=guidance_scale, timesteps=timesteps, temperature=temperature,
            mask_schedule=mask_schedule, noise=noise)
        if return_codes:
            return codes
        return self.decode_codes(codes)

    def decode_codes(self, codes: torch.Tensor) -> torch.Tensor:
        """Codebook ids -> pixels in [-1, 1] (clamped into the codebook first)."""
        codes = torch.clamp(codes, 0, self.cfg.codebook_size - 1)
        return magvit.decode_code(self.vq_params, self.vq_cfg, codes)


def pixels_to_uint8(pixels) -> np.ndarray:
    """[-1, 1] floats -> uint8 HWC images. uint8 input passes through unchanged."""
    if isinstance(pixels, torch.Tensor):
        pixels = pixels.detach().float().cpu().numpy()
    arr = np.asarray(pixels)
    if arr.dtype == np.uint8:
        return arr
    x = np.clip((arr.astype(np.float32) + 1.0) / 2.0, 0.0, 1.0)
    return (x * 255.0).round().astype(np.uint8)
