"""UniGen: Qwen2.5 backbone plus the unified image vocabulary (inference subset).

Port of the parts of ``unigen_tpu/models/unigen.py`` the t2i path uses:

* the unified vocabulary ``vocab_size = text_vocab_len + codebook_size + 1``,
  image token i at ``i + text_vocab_len``, the mask token at ``vocab_size - 1``;
* the optional gen projector: a (codebook+1)-entry embedding + MLP for image
  tokens and a separate ``img_head``;
* the understanding projector (``w_und_encoder``): vision-tower features
  -> LLM hidden space through ``mm_projector``, an MLP with the exact GELU
  (the SigLIP tower itself uses the tanh GELU).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import torch
import torch.nn.functional as F

from . import qwen2
from .qwen2 import Qwen2Config


@dataclasses.dataclass(frozen=True)
class UniGenConfig:
    llm: Qwen2Config
    vocab_size: int                    # unified: text_vocab_len + codebook + 1
    llm_vocab_size: int                # original text tokenizer base vocab
    text_vocab_len: int                # len(tokenizer) incl. added specials
    codebook_size: int = 8192
    num_vq_tokens: int = 256
    w_und_encoder: bool = False
    mm_input_dim: int = 1152
    gen_input_dim: int = 16
    und_proj_depth: int = 2
    gen_proj_depth: int = 0
    use_gen_dim: bool = False

    @property
    def mask_token_id(self) -> int:
        """codebook_size with a gen projector, else the last unified-vocab id."""
        return self.codebook_size if self.gen_proj_depth > 0 else self.vocab_size - 1

    @property
    def use_gen_projector(self) -> bool:
        return self.gen_proj_depth > 0

    @classmethod
    def for_qwen25_15b(cls, text_vocab_len: int = 151674, **kw) -> "UniGenConfig":
        """Flagship shape: Qwen2.5-1.5B + 8192-codebook MAGViTv2."""
        codebook = kw.pop("codebook_size", 8192)
        vocab = text_vocab_len + codebook + 1
        llm = kw.pop("llm", None) or Qwen2Config(vocab_size=vocab)
        return cls(llm=llm, vocab_size=vocab, llm_vocab_size=151643,
                   text_vocab_len=text_vocab_len, codebook_size=codebook, **kw)

    @classmethod
    def tiny(cls, **kw) -> "UniGenConfig":
        codebook = kw.pop("codebook_size", 32)
        text_len = kw.pop("text_vocab_len", 128)
        vocab = text_len + codebook + 1
        llm = kw.pop("llm", None) or Qwen2Config.tiny(vocab_size=vocab)
        defaults = dict(num_vq_tokens=16, mm_input_dim=24, gen_input_dim=8)
        defaults.update(kw)
        return cls(llm=llm, vocab_size=vocab, llm_vocab_size=text_len - 16,
                   text_vocab_len=text_len, codebook_size=codebook, **defaults)


def mlp_apply(layers: List[Dict], x: torch.Tensor) -> torch.Tensor:
    """Linear -> (GELU -> Linear)*; layers hold {"w": [out, in], "b": [out]}."""
    for i, p in enumerate(layers):
        if i > 0:
            x = F.gelu(x, approximate="none")
        x = F.linear(x, p["w"].to(x.dtype), p["b"].to(x.dtype))
    return x


def get_gen_embed(params: Dict, img_tokens: torch.Tensor) -> torch.Tensor:
    """(codebook+1)-space image tokens -> LLM hidden embeddings."""
    return mlp_apply(params["gen_projector"], F.embedding(img_tokens, params["gen_embed"]))


def mm_project(params: Dict, image_feats: torch.Tensor) -> torch.Tensor:
    """Vision-tower features [B, P, mm_input_dim] -> [B, P, hidden]."""
    return mlp_apply(params["mm_projector"], image_feats)


def embed_tokens(params: Dict, input_ids: torch.Tensor) -> torch.Tensor:
    return qwen2.embed(params["llm"], input_ids)
