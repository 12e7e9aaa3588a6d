"""Checkpoint interop: reference and HF torch weights into the port's parameters.

Port of ``unigen_tpu/utils/hf_import.py``. Reads the reference's persistence
formats (single or sharded ``*.safetensors`` with an ``*.index.json``, or
``pytorch_model*.bin``; ``utils/persistence.load_state_dict``) and maps them
straight into the port's layout, not through the JAX tree: an HF
``nn.Linear`` weight is [out, in], the port's own layout, and convolutions go
from OIHW to HWIO. Importers exist for every model: the Qwen2 backbone, the
whole UniGen (projectors and heads included), MAGViTv2 and the SigLIP
towers, with the vocabulary resize applied on load (the reference's
train.py:247-255). Each leaf goes to ``device`` in the config's dtype, one
leaf at a time, so the host never holds a second copy of the model; a key a
converter needs and does not find raises ``KeyError`` naming it.
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping, Union

import torch

from ..models import magvit, qwen2, siglip
from .persistence import load_state_dict, take

__all__ = ["load_state_dict", "resize_embedding", "import_qwen2", "import_unigen",
           "import_magvit", "import_siglip"]

StateDict = Mapping[str, torch.Tensor]


def _state_dict(path_or_sd: Union[str, StateDict]) -> StateDict:
    return path_or_sd if isinstance(path_or_sd, Mapping) else load_state_dict(path_or_sd)


def resize_embedding(weight: torch.Tensor, new_vocab: int) -> torch.Tensor:
    """Grow or shrink a [V, D] table: shrinking slices; new rows are the mean
    row (the on-load vocab fixup, reference train.py:247-255). The mean is
    taken in float32 on the host as numpy takes it (rows summed in order),
    so an fp32 table resizes bit for bit as the JAX package resizes it; a
    bf16 table's mean is rounded once, from the float32 mean."""
    v, d = weight.shape
    if new_vocab == v:
        return weight
    if new_vocab < v:
        return weight[:new_vocab]
    mean = weight.detach().to("cpu", torch.float32).numpy().mean(axis=0)
    extra = torch.from_numpy(mean).to(weight.device, weight.dtype).expand(new_vocab - v, d)
    return torch.cat([weight, extra])


def import_qwen2(path_or_sd, cfg: qwen2.Qwen2Config, prefix: str = "model.",
                 device="cpu") -> Dict[str, Any]:
    """A Qwen2 checkpoint -> the port's backbone, ``embed_tokens`` (and an
    untied ``lm_head``) resized to ``cfg.vocab_size``."""
    sd = _state_dict(path_or_sd)
    embed_key = prefix + "embed_tokens.weight"
    if embed_key in sd and sd[embed_key].shape[0] != cfg.vocab_size:
        sd = dict(sd)
        sd[embed_key] = resize_embedding(sd[embed_key], cfg.vocab_size)
        if "lm_head.weight" in sd:
            sd["lm_head.weight"] = resize_embedding(sd["lm_head.weight"], cfg.vocab_size)
    return qwen2.convert_hf_state_dict(sd, cfg, prefix=prefix, device=device)


def _mlp_from_sd(sd: StateDict, prefix: str, device, dtype) -> List[Dict[str, torch.Tensor]]:
    """torch ``nn.Sequential([Linear, GELU, Linear, ...])`` -> the port's
    layer list; Sequential indices skip the activations (0, 2, 4, ...)."""
    layers = []
    idx = 0
    while f"{prefix}.{idx}.weight" in sd:
        layers.append({"w": take(sd, f"{prefix}.{idx}.weight", device, dtype),
                       "b": take(sd, f"{prefix}.{idx}.bias", device, dtype)})
        idx += 2
    return layers


def import_unigen(path_or_sd, cfg, device="cpu") -> Dict[str, Any]:
    """A whole UniGen ``unwrapped_model`` checkpoint -> the port's parameters.

    Reference layout: ``llm.model.*`` / ``llm.lm_head.*``, plus ``gen_embed``,
    ``gen_projector`` and ``img_head`` when ``gen_embed.weight`` is present,
    and ``mm_projector`` (reference: models/unigen.py:56-128)."""
    sd = _state_dict(path_or_sd)
    dt = cfg.llm.dtype
    params: Dict[str, Any] = {"llm": import_qwen2(sd, cfg.llm, prefix="llm.model.",
                                                  device=device)}
    if "llm.lm_head.weight" in sd and not cfg.llm.tie_word_embeddings:
        params["llm"]["lm_head"] = resize_embedding(
            sd["llm.lm_head.weight"], cfg.llm.vocab_size).to(device, dt).contiguous()
    if "gen_embed.weight" in sd:
        params["gen_embed"] = take(sd, "gen_embed.weight", device, dt)
        params["gen_projector"] = _mlp_from_sd(sd, "gen_projector", device, dt)
        params["img_head"] = take(sd, "img_head.weight", device, dt)
    if any(k.startswith("mm_projector.") for k in sd):
        params["mm_projector"] = _mlp_from_sd(sd, "mm_projector", device, dt)
    return params


def import_magvit(path_or_sd, cfg: magvit.MagvitConfig, device="cpu") -> Dict[str, Any]:
    return magvit.convert_torch_state_dict(_state_dict(path_or_sd), cfg, device=device)


def import_siglip(path_or_sd, cfg: siglip.SiglipConfig, prefix: str = "vision_model.",
                  device="cpu") -> Dict[str, Any]:
    """A SigLIP tower checkpoint; one that nests under
    ``vision_tower.vision_model.*`` or has no prefix is found by its first
    encoder layer."""
    sd = _state_dict(path_or_sd)
    if not any(k.startswith(prefix) for k in sd):
        for cand in ("vision_tower.vision_model.", "vision_model.", ""):
            if any(k.startswith(cand + "encoder.layers.0.") for k in sd):
                prefix = cand
                break
    return siglip.convert_hf_state_dict(sd, cfg, prefix=prefix, device=device)
