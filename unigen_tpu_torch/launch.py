"""Construction of tokenizers, models and pipelines from configs built in code.

Counterpart of ``unigen_tpu/launch.py`` for the t2i and the SigLIP
understanding slices. Configurations are
built in code (no YAML), weights are a random init from a seed until real
checkpoints are in the repo, and the tokenizer is the byte-level
``FallbackTokenizer`` (the port's own copy of the JAX package's).
"""
from __future__ import annotations

from typing import Optional

import torch

from .device import DeviceLike, resolve_device
from .models.magvit import MagvitConfig
from .models.qwen2 import Qwen2Config
from .models.siglip import SiglipConfig
from .models.unigen import UniGenConfig
from .ops.int4 import quantize_unigen_params_int4
from .ops.quantization import quantize_siglip_params, quantize_unigen_params
from .pipeline import UniGenPipeline
from .prompting import UniPrompting
from .weights import init_magvit, init_siglip, init_unigen

TRAIN_SPECIAL_TOKENS = ("<|soi|>", "<|eoi|>", "<|sov|>", "<|eov|>", "<|t2i|>",
                        "<|mmu|>", "<|t2v|>", "<|v2v|>", "<|lvg|>")

# configs/unigen_1_5b/unigen_sft.yaml: max_seq_length 1344 + 256 image tokens + 3
FLAGSHIP_MAX_SEQ_LEN = 1344 + 256 + 3


class FallbackTokenizer:
    """Deterministic byte-level tokenizer used when no Qwen tokenizer is on disk.

    Mirrors the HF fast-tokenizer surface UniPrompting needs. Base ids 0..255
    are bytes; Qwen special markers and added tokens get ids from
    ``special_base`` up (151643 by default, the real Qwen2.5 id neighbourhood,
    so the vocab layout stays realistic).
    """

    BASE = {"<|endoftext|>": 0, "<|im_start|>": 1, "<|im_end|>": 2,
            "<|vision_start|>": 9, "<|vision_end|>": 10}

    def __init__(self, special_base: int = 151643):
        self.specials = {k: special_base + off for k, off in self.BASE.items()}
        self.next_id = special_base + 22
        self.pad_token_id = special_base
        self.eos_token_id = special_base + 2
        self.vocab_size = special_base

    def add_tokens(self, tokens):
        for t in tokens:
            if t not in self.specials:
                self.specials[t] = self.next_id
                self.next_id += 1

    def convert_tokens_to_ids(self, tokens):
        return [self.specials.get(t, 0) for t in tokens]

    def __len__(self):
        return self.next_id

    def _encode(self, text: str):
        ids, i = [], 0
        specials = sorted(self.specials, key=len, reverse=True)
        while i < len(text):
            for s in specials:
                if text.startswith(s, i):
                    ids.append(self.specials[s])
                    i += len(s)
                    break
            else:
                ids.extend(text[i].encode("utf-8"))
                i += 1
        return ids

    def __call__(self, texts, **kw):
        if isinstance(texts, str):
            return {"input_ids": self._encode(texts)}
        return {"input_ids": [self._encode(t) for t in texts]}

    def decode(self, ids, **kw):
        rev = {v: k for k, v in self.specials.items()}
        out, buf = [], []
        for i in ids:
            if i < 256:
                buf.append(i)
            else:
                if buf:
                    out.append(bytes(buf).decode("utf-8", "replace"))
                    buf = []
                out.append(rev.get(int(i), ""))
        if buf:
            out.append(bytes(buf).decode("utf-8", "replace"))
        return "".join(out)


def build_prompting(tokenizer, max_seq_len: int = FLAGSHIP_MAX_SEQ_LEN) -> UniPrompting:
    """Prompting as the UniGen-1.5B stage configs set it up (task token after
    ``<|im_start|>``, separate soi/eoi tokens)."""
    return UniPrompting(tokenizer, special_tokens=TRAIN_SPECIAL_TOKENS,
                        max_seq_len=max_seq_len)


def build_pipeline(model: str = "flagship", *, dtype: Optional[torch.dtype] = None,
                   device: DeviceLike = None, seed: int = 0, vision: bool = False,
                   quantization: Optional[str] = None,
                   quantized_cache: bool = False) -> UniGenPipeline:
    """A pipeline with random weights from ``seed``.

    ``model="flagship"``: Qwen2.5-1.5B + MAGViTv2 (256 px, 8192 codes), bf16
    by default; with ``vision`` also the SigLIP-SO400M tower (384 px, patch
    14, 26 of 27 layers) and the 2-layer MM projector 1152 -> 1536, as
    ``configs/unigen_1_5b/unigen_sft.yaml`` sets them. ``model="tiny"``: two
    narrow layers, an 8 px tokenizer with 16 tokens and a 32-entry codebook,
    with ``vision`` a 3-layer 32-wide tower over 28 px images (4 patches),
    fp32 by default, with the byte tokenizer's special ids moved down to 256
    so they fit the tiny vocabulary.

    ``quantization="int8"`` (JAX's ``model.quantization=int8``) puts the
    backbone, the image and text heads and, with ``vision``, the SigLIP
    tower on W8A8 (``ops.quantization``); ``"int4"`` puts the backbone and
    the text head on W4A8 (``ops.int4``, group 256; 32 at the tiny width). ``quantized_cache``
    gives ``understand`` and ``generate_text`` an int8 KV cache.
    """
    if quantization not in (None, "int8", "int4"):
        raise ValueError(f"quantization must be None, 'int8' or 'int4', got {quantization!r}")
    device = resolve_device(device)
    if model == "flagship":
        dtype = dtype or torch.bfloat16
        tokenizer = FallbackTokenizer()
        prompting = build_prompting(tokenizer)
        text_vocab_len = len(tokenizer)
        vocab = text_vocab_len + 8192 + 1
        vision_cfg = SiglipConfig.so400m(dtype=dtype) if vision else None
        cfg = UniGenConfig.for_qwen25_15b(text_vocab_len=text_vocab_len,
                                          llm=Qwen2Config(vocab_size=vocab, dtype=dtype),
                                          w_und_encoder=vision, mm_input_dim=1152,
                                          und_proj_depth=2)
        vq_cfg = MagvitConfig(dtype=dtype)
    elif model == "tiny":
        dtype = dtype or torch.float32
        tokenizer = FallbackTokenizer(special_base=256)
        prompting = build_prompting(tokenizer, max_seq_len=64 + 16 + 3)
        text_vocab_len = len(tokenizer)
        vision_cfg = SiglipConfig.tiny(dtype=dtype) if vision else None
        cfg = UniGenConfig.tiny(text_vocab_len=text_vocab_len,
                                llm=Qwen2Config.tiny(vocab_size=text_vocab_len + 32 + 1,
                                                     dtype=dtype),
                                w_und_encoder=vision, mm_input_dim=32)
        vq_cfg = MagvitConfig.tiny(resolution=8, z_channels=5, dtype=dtype)
    else:
        raise ValueError(f"unknown model {model!r}: 'flagship' or 'tiny'")
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    params = init_unigen(cfg, gen, device, dtype)
    vq_params = init_magvit(vq_cfg, gen, device, dtype)
    vision_params = init_siglip(vision_cfg, gen, device, dtype) if vision else None
    if quantization == "int8":
        params = quantize_unigen_params(params, cfg, lm_head=True)
        if vision:
            vision_params = quantize_siglip_params(vision_params)
    elif quantization == "int4":
        params = quantize_unigen_params_int4(params, cfg, group=256 if model == "flagship" else 32)
    return UniGenPipeline(params, cfg, vq_params, vq_cfg, prompting, device,
                          vision_params=vision_params, vision_cfg=vision_cfg,
                          quantized_cache=quantized_cache)
