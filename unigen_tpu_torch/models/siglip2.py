"""SigLIP2-NaFlex vision tower: images at their own aspect ratio, inference only.

Port of ``unigen_tpu/models/siglip2.py``. Patchified pixels [B, N, 3 p p]
enter through a linear patch embedding; the learned 16 x 16 position grid is
resized bilinearly (antialiased) to each image's (h, w) patch grid, padding
slots repeating entry 0; then SigLIP's pre-LN layers (``models/siglip.py``'s
layer code: fp32 layer norm, tanh GELU MLP), the last one dropped, no head.
Padding rides in ``pixel_attention_mask`` [B, N]: it masks keys only, so a
pad query row attends to its image's patches, as in JAX and HF.

The attention is kernel 1, ``ops.chunk_attention.chunk_attention(q, k, v,
kvalid)`` with q = k = v's sequence and the mask as its per-row key mask:
exactly JAX's function. Kernel 2's pad bit would also blank the pad query
rows (their output the mean of V), and those rows reach the backbone in the
NaFlex SFT step, where the pad-patch slots stay causal keys for the text
after them (``ops.masks.mmu_vit_attn_meta``). The head dim 72 is zero-padded
to 80 with the real ``72 ** -0.5`` scale, as the SigLIP tower pads it.

Parameters are a dict: ``patch_embed`` {w [D, 3 p p], b [D]}, ``pos_embed``
[num_patches, D] and one dict per layer in ``models/siglip.py``'s layout.
A sharded tower runs with its spec tree (``specs=``), a whole one without,
checked as ``models/siglip.py`` checks its tower.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.chunk_attention import chunk_attention
from ..ops.flash_attention import kernel_head_dim
from ..parallel import collectives as C
from ..utils.persistence import take
from .siglip import _encoder_layer, check_layers, hf_encoder_layers


@dataclasses.dataclass(frozen=True)
class Siglip2Config:
    hidden_size: int = 1152
    intermediate_size: int = 4304
    num_hidden_layers: int = 27
    num_attention_heads: int = 16
    num_channels: int = 3
    num_patches: int = 256           # 16 x 16 base position grid
    patch_size: int = 16
    layer_norm_eps: float = 1e-6
    drop_last_layer: bool = True
    dtype: Any = torch.float32

    @property
    def num_layers_used(self) -> int:
        return self.num_hidden_layers - (1 if self.drop_last_layer else 0)

    @property
    def patch_dim(self) -> int:
        return self.num_channels * self.patch_size * self.patch_size

    @classmethod
    def naflex(cls, **kw) -> "Siglip2Config":
        """``google/siglip2-so400m-patch16-naflex``'s shape."""
        return cls(**kw)

    @classmethod
    def tiny(cls, **kw) -> "Siglip2Config":
        defaults = dict(hidden_size=32, intermediate_size=64, num_hidden_layers=3,
                        num_attention_heads=4, num_patches=16, patch_size=4)
        defaults.update(kw)
        return cls(**defaults)


def patchify(image: np.ndarray, patch_size: int) -> Tuple[np.ndarray, Tuple[int, int]]:
    """[H, W, 3] -> ([h*w, 3*p*p], (h, w)); H and W are cut to multiples of p."""
    h, w = image.shape[0] // patch_size, image.shape[1] // patch_size
    x = image[: h * patch_size, : w * patch_size]
    x = x.reshape(h, patch_size, w, patch_size, -1).transpose(0, 2, 1, 3, 4)
    return x.reshape(h * w, -1), (h, w)


def resize_positional_embeddings(pos_weight: torch.Tensor, spatial_shapes,
                                 max_length: int) -> torch.Tensor:
    """[B, max_length, D] fp32 on ``pos_weight``'s device: the square grid
    resized to each image's (h, w) (``spatial_shapes`` [B, 2], array or
    tensor) by ``F.interpolate(mode="bilinear", antialias=True)``, padding
    slots repeating entry 0. Each distinct shape is resized once a call."""
    shapes = [tuple(int(v) for v in hw) for hw in np.asarray(torch.as_tensor(
        spatial_shapes).cpu())]
    n, d = pos_weight.shape
    side = int(round(n ** 0.5))
    grid = pos_weight.float().reshape(side, side, d).permute(2, 0, 1)[None]
    resized = {}
    for h, w in dict.fromkeys(shapes):
        r = F.interpolate(grid, size=(h, w), mode="bilinear", align_corners=False,
                          antialias=True)
        resized[h, w] = r[0].reshape(d, h * w).t()
    out = torch.empty((len(shapes), max_length, d), dtype=torch.float32,
                      device=pos_weight.device)
    for i, hw in enumerate(shapes):
        r = resized[hw]
        out[i, :r.shape[0]] = r
        out[i, r.shape[0]:] = r[0]
    return out


def _key_masked_attention(kvalid: torch.Tensor):
    """Attention over the patches with key mask ``kvalid`` [B, N] (kernel 1),
    q/k/v [B, N, H, dh] zero-padded to the kernel's head dim."""
    def attend(q, k, v, scale):
        dh = q.shape[-1]
        pad = kernel_head_dim(dh) - dh
        if pad:
            q, k, v = (F.pad(t, (0, pad)) for t in (q, k, v))
        out = chunk_attention(q, k, v, kvalid, scale=scale)
        return out[..., :dh] if pad else out
    return attend


def encoder_forward(params: Dict, cfg: Siglip2Config, embeddings: torch.Tensor,
                    pixel_attention_mask: torch.Tensor, specs: Optional[Dict] = None
                    ) -> torch.Tensor:
    """The pre-LN layers over [B, N, D] with padded keys masked; pad query
    rows are computed too."""
    if specs is None:
        check_layers(params["layers"], cfg)
    attend = _key_masked_attention(pixel_attention_mask.to(embeddings.device).bool()
                                   .contiguous())
    x = embeddings
    for i, lp in enumerate(params["layers"]):
        x = _encoder_layer(lp, cfg, x, attend, C.sub(specs, "layers", i))
    return x


@torch.no_grad()
def forward_with_pos(params: Dict, cfg: Siglip2Config, pixel_values: torch.Tensor,
                     pixel_attention_mask: torch.Tensor, pos_embeds: torch.Tensor,
                     specs: Optional[Dict] = None) -> torch.Tensor:
    """pixel_values [B, N, 3 p p] and pre-resized ``pos_embeds`` [B, N, D]
    -> features [B, N, D] (the NaFlex SFT step resizes once a batch)."""
    if specs is None:
        C.expect_whole("patch_embed/w's shape", tuple(params["patch_embed"]["w"].shape),
                (cfg.hidden_size, cfg.patch_dim))
    pe, _ = C.gather_tree(params["patch_embed"], C.sub(specs, "patch_embed"))
    x = F.linear(pixel_values.to(cfg.dtype), pe["w"].to(cfg.dtype), pe["b"].to(cfg.dtype))
    x = x + pos_embeds.to(cfg.dtype)
    return encoder_forward(params, cfg, x, pixel_attention_mask, specs)


@torch.no_grad()
def forward(params: Dict, cfg: Siglip2Config, pixel_values: torch.Tensor,
            pixel_attention_mask: torch.Tensor, spatial_shapes,
            specs: Optional[Dict] = None) -> torch.Tensor:
    """pixel_values [B, N, 3 p p] (normalized to [-1, 1]), the patch mask
    [B, N] and each image's (h, w) in patches [B, 2] -> features [B, N, D].
    ``specs`` None: the tower is whole, and checked so."""
    if specs is None:
        C.expect_whole("pos_embed's shape", tuple(params["pos_embed"].shape),
                (cfg.num_patches, cfg.hidden_size))
    pos = resize_positional_embeddings(
        C.gather_fsdp(params["pos_embed"], C.sub(specs, "pos_embed"))[0], spatial_shapes,
        pixel_values.shape[1])
    return forward_with_pos(params, cfg, pixel_values, pixel_attention_mask, pos, specs)


def convert_hf_state_dict(sd: Dict[str, torch.Tensor], cfg: Siglip2Config,
                          prefix: str = "vision_model.", device="cpu") -> Dict:
    """A HF ``Siglip2VisionModel`` state dict -> the port's NaFlex tower, each
    leaf on ``device`` in ``cfg.dtype``: the patch embedding is an HF
    ``nn.Linear``, [D, 3 p p] as the port's ``w``; the first
    ``num_layers_used`` layers. A missing key raises ``KeyError`` naming it."""
    patch = prefix + "embeddings.patch_embedding."
    return {"patch_embed": {"w": take(sd, patch + "weight", device, cfg.dtype),
                            "b": take(sd, patch + "bias", device, cfg.dtype)},
            "pos_embed": take(sd, prefix + "embeddings.position_embedding.weight", device,
                              cfg.dtype),
            "layers": hf_encoder_layers(sd, cfg, prefix, device)}
