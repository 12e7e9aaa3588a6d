"""Construction of tokenizers, models and pipelines, from a run's config or in code.

Counterpart of ``unigen_tpu/launch.py``. ``build_pipeline(config)`` takes a
config of ``utils.configuration.initialize_config`` (a YAML file of
``configs/`` plus overrides), as every JAX entry point does: it sizes the
unified vocabulary from the tokenizer, applies the configs' size overrides,
loads each model when its path exists and draws it at random from a fixed
seed when not (logged), and quantizes with ``model.quantization=int8``. A
checkpoint is read in either format, told apart by its tensor names: the
native one (``utils/persistence.py``'s, as JAX's ``save_pretrained`` and
``utils/import_weights.py`` write it) or the reference / HF torch layout
(single or sharded safetensors, or ``pytorch_model*.bin``), converted on
load by ``utils/hf_import.py``. ``build_pipeline("flagship" | "tiny")``
builds the two code-built configurations with random weights from a seed.
A Qwen2 tokenizer directory is read by ``utils/qwen_tokenizer.py``, without
``transformers``; without one on disk the tokenizer is the byte-level
``FallbackTokenizer`` (the port's own copy of the JAX package's).
"""
from __future__ import annotations

import dataclasses
import glob
import logging
import os
from typing import Any, Mapping, Optional, Tuple, Union

import torch

from . import weights as W
from .device import DeviceLike, resolve_device
from .models import siglip, siglip2
from .models.builder import get_vision_tower_config
from .models.magvit import MagvitConfig
from .models.qwen2 import Qwen2Config
from .models.siglip import SiglipConfig
from .models.siglip2 import Siglip2Config
from .models.unigen import UniGenConfig
from .ops.int4 import quantize_unigen_params_int4
from .ops.quantization import quantize_siglip_params, quantize_unigen_params
from .pipeline import UniGenPipeline
from .prompting import UniPrompting
from .utils.checkpoint_registry import real_checkpoint
from .utils.hf_import import import_magvit, import_unigen
from .utils.persistence import from_pretrained, load_state_dict, tensor_names
from .utils.qwen_tokenizer import QwenTokenizer
from .weights import init_magvit, init_siglip, init_siglip2, init_unigen

logger = logging.getLogger(__name__)

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
    ``<|im_start|>``, separate soi/eoi tokens): the code-built configurations'."""
    return UniPrompting(tokenizer, special_tokens=TRAIN_SPECIAL_TOKENS,
                        max_seq_len=max_seq_len)


def build_prompting_from_config(config, tokenizer) -> UniPrompting:
    """JAX's ``build_prompting(config, tokenizer)``: the sequence budget
    from ``dataset.preprocessing.max_seq_length`` + the image tokens + 3
    (``model.max_len_mode: text``, the default) or ``model_max_length``,
    ``model.task_token_first`` (default True, as JAX's; every repo
    config sets false) and ``training.cond_dropout_prob`` (default 0.1)."""
    model = config["model"]
    if model.get("max_len_mode", "text") == "text":
        max_seq_len = (config["dataset"]["preprocessing"]["max_seq_length"]
                       + model["unigen"]["num_vq_tokens"] + 3)
    else:
        max_seq_len = model["unigen"].get("model_max_length", 32768)
    return UniPrompting(tokenizer, special_tokens=TRAIN_SPECIAL_TOKENS, max_seq_len=max_seq_len,
                        task_token_first=model.get("task_token_first", True),
                        enable_reuse_tk=model.get("enable_reuse_tk", False),
                        cond_dropout_prob=config.get("training", {}).get("cond_dropout_prob",
                                                                         0.1))


# ---------------------------------------------------------------------------
# from a run's config
# ---------------------------------------------------------------------------

def load_tokenizer(config):
    """The Qwen tokenizer under ``model.unigen.llm_model_path`` (through the
    checkpoint registry and ``model.ckpt_base_path``) when that directory
    exists, read by ``utils.qwen_tokenizer`` (the port depends on no
    ``transformers``); else the byte-level fallback."""
    path = real_checkpoint(config["model"]["unigen"]["llm_model_path"],
                           config["model"].get("ckpt_base_path", ""))
    if os.path.isdir(path):
        return QwenTokenizer.from_pretrained(
            path, model_max_length=config["model"]["unigen"].get("model_max_length", 32768))
    logger.warning(f"tokenizer not found at {path}; using byte-level fallback")
    return FallbackTokenizer()


def _is_native_checkpoint(path: str) -> bool:
    """True when ``path`` holds a checkpoint in the persistence format
    (tensors under ``/``-joined tree paths) rather than an HF or torch
    layout (``.``-separated module names)."""
    files = sorted(glob.glob(os.path.join(path, "*.safetensors")))
    names = tensor_names(files[0]) if files else []
    return bool(names) and "/" in names[0]


def _load_native(path: str, template_jax, from_jax):
    """A native checkpoint read against the JAX-layout template of the
    port's own init on the ``meta`` device (no memory spent on it), then
    through ``weights.py``'s bridge."""
    return from_jax(from_pretrained(path, template_jax)[0])


def _generator(seed: int, device: torch.device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def build_unigen_config(config, prompting: UniPrompting, dtype=None) -> UniGenConfig:
    """The UniGenConfig a run's config and tokenizer imply (no weights touched):
    the Qwen2.5-1.5B backbone unless ``model.unigen`` overrides its sizes."""
    mcfg = config["model"]["unigen"]
    text_vocab_len = len(prompting.text_tokenizer)
    vocab = text_vocab_len + mcfg["codebook_size"] + 1
    llm_kw = dict(vocab_size=vocab, dtype=dtype or torch.bfloat16,
                  rope_theta=mcfg.get("rope_theta", 1e6) or 1e6)
    for k in ("hidden_size", "intermediate_size", "num_hidden_layers",
              "num_attention_heads", "num_key_value_heads", "head_dim"):
        if mcfg.get(k) is not None:
            llm_kw[k] = int(mcfg[k])
    return UniGenConfig(
        llm=Qwen2Config(**llm_kw), vocab_size=vocab,
        llm_vocab_size=prompting.text_tokenizer.vocab_size, text_vocab_len=text_vocab_len,
        codebook_size=mcfg["codebook_size"], num_vq_tokens=mcfg["num_vq_tokens"],
        w_und_encoder=mcfg.get("w_und_encoder", False),
        mm_input_dim=mcfg.get("mm_input_dim", 1152),
        und_proj_depth=mcfg.get("und_proj_depth", 2),
        gen_proj_depth=mcfg.get("gen_proj_depth", 0),
        use_gen_dim=mcfg.get("use_gen_dim", False),
        gen_input_dim=mcfg.get("gen_input_dim", 16))


def build_unigen(config, prompting: UniPrompting, dtype=None, device: DeviceLike = None
                 ) -> Tuple[Any, UniGenConfig]:
    """UniGen from ``model.unigen.pretrained_model_path`` (its
    ``unwrapped_model`` directory when there is one), else random (seed 0)."""
    device = resolve_device(device)
    cfg = build_unigen_config(config, prompting, dtype)
    path = config["model"]["unigen"].get("pretrained_model_path", "")
    if path:
        resolved = os.path.join(path, "unwrapped_model") \
            if os.path.isdir(os.path.join(path, "unwrapped_model")) else path
        if os.path.isdir(resolved):
            logger.info(f"loading UniGen weights from {resolved}")
            if not _is_native_checkpoint(resolved):
                return import_unigen(resolved, cfg, device), cfg
            template = W.unigen_to_jax(init_unigen(cfg, None, "meta", cfg.llm.dtype), cfg)
            return _load_native(resolved, template, lambda t: W.unigen_from_jax(
                t, cfg, device, cfg.llm.dtype)), cfg
        logger.warning(f"UniGen checkpoint missing at {path}; random init")
    return init_unigen(cfg, _generator(0, device), device, cfg.llm.dtype), cfg


def vq_config(config, dtype) -> MagvitConfig:
    """MAGViTv2's config with ``model.vq_model``'s size overrides."""
    vcfg = config["model"].get("vq_model", {})
    kw = {}
    for k in ("ch", "enc_ch_mult", "enc_num_res_blocks", "dec_ch_mult", "dec_num_res_blocks",
              "attn_resolutions", "resolution", "z_channels"):
        v = vcfg.get(k)
        if v is not None:
            kw[k] = tuple(v) if isinstance(v, (list, tuple)) else int(v)
    return MagvitConfig(dtype=dtype, **kw)


def build_vq(config, dtype=None, device: DeviceLike = None) -> Tuple[Any, MagvitConfig]:
    """MAGViTv2 with ``model.vq_model``'s size overrides, from its checkpoint
    when the path exists, else random (seed 1)."""
    device = resolve_device(device)
    cfg = vq_config(config, dtype or torch.bfloat16)
    path = real_checkpoint(config["model"].get("vq_model", {}).get("vq_model_name", "magvitv2"),
                           config["model"].get("ckpt_base_path", ""))
    if os.path.isdir(path):
        logger.info(f"loading MAGViTv2 weights from {path}")
        if not _is_native_checkpoint(path):
            return import_magvit(path, cfg, device), cfg
        template = W.magvit_to_jax(init_magvit(cfg, None, "meta", cfg.dtype))
        return _load_native(path, template, lambda t: W.magvit_from_jax(
            t, cfg, device, cfg.dtype)), cfg
    logger.warning(f"MAGViTv2 checkpoint missing at {path}; random init")
    return init_magvit(cfg, _generator(1, device), device, cfg.dtype), cfg


def vision_tower_config(config, dtype=None):
    """The config of the tower named by ``model.vision_tower.name`` with its
    size overrides (None without one); its own dtype (fp32) unless ``dtype``."""
    vt = config["model"].get("vision_tower", {})
    if not vt.get("name"):
        return None
    _, cfg = get_vision_tower_config(vt["name"])
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    # a size a tower's config lacks (image_size of the NaFlex tower) is skipped, as in JAX
    overrides = {k: int(vt[k]) for k in ("hidden_size", "intermediate_size", "num_hidden_layers",
                                         "num_attention_heads", "image_size", "patch_size")
                 if vt.get(k) is not None and hasattr(cfg, k)}
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def tower_codec(cfg):
    """(init, to_jax, from_jax, convert_hf_state_dict) of the tower that
    ``cfg`` configures: ``models.siglip2``'s for a SigLIP2-NaFlex config,
    else ``models.siglip``'s."""
    if isinstance(cfg, Siglip2Config):
        return init_siglip2, W.siglip2_to_jax, W.siglip2_from_jax, siglip2.convert_hf_state_dict
    return init_siglip, W.siglip_to_jax, W.siglip_from_jax, siglip.convert_hf_state_dict


def build_vision_tower(config, dtype=None, device: DeviceLike = None):
    """The tower named by ``model.vision_tower.name`` with its size
    overrides, from its checkpoint when the path exists, else random (seed
    2); (None, None) without one. The tower keeps its own dtype (fp32)
    unless ``dtype`` is given, as in JAX. A SigLIP2-NaFlex name builds
    ``models.siglip2``'s tower."""
    cfg = vision_tower_config(config, dtype)
    if cfg is None:
        return None, None
    device = resolve_device(device)
    init, to_jax, from_jax, convert = tower_codec(cfg)
    name = config["model"]["vision_tower"]["name"]
    path = real_checkpoint(name, config["model"].get("ckpt_base_path", ""))
    if os.path.isdir(path):
        logger.info(f"loading vision tower weights from {path}")
        if not _is_native_checkpoint(path):
            return convert(load_state_dict(path), cfg, device=device), cfg
        template = to_jax(init(cfg, None, "meta", cfg.dtype), cfg)
        return _load_native(path, template, lambda t: from_jax(t, cfg, device, cfg.dtype)), cfg
    logger.warning(f"vision tower checkpoint missing at {path}; random init")
    return init(cfg, _generator(2, device), device, cfg.dtype), cfg


def _pipeline_from_config(config, dtype=None, device: DeviceLike = None) -> UniGenPipeline:
    device = resolve_device(device)
    prompting = build_prompting_from_config(config, load_tokenizer(config))
    params, cfg = build_unigen(config, prompting, dtype, device)
    vq_params, vq_cfg = build_vq(config, dtype, device)
    vs_params, vs_cfg = build_vision_tower(config, dtype, device)
    if str(config["model"].get("quantization", "")).lower() == "int8":
        params = quantize_unigen_params(params, cfg, lm_head=True)
        if vs_params is not None and isinstance(vs_cfg, SiglipConfig):
            vs_params = quantize_siglip_params(vs_params)
            logger.info("backbone + heads + SigLIP tower quantized to int8 W8A8")
        else:
            logger.info("backbone + heads quantized to int8 W8A8")
    return UniGenPipeline(params, cfg, vq_params, vq_cfg, prompting, device,
                          vision_params=vs_params, vision_cfg=vs_cfg)


# ---------------------------------------------------------------------------
# from code
# ---------------------------------------------------------------------------

def build_pipeline(model: Union[str, Mapping] = "flagship", *,
                   dtype: Optional[torch.dtype] = None,
                   device: DeviceLike = None, seed: Optional[int] = None,
                   vision: Union[bool, str, None] = None, quantization: Optional[str] = None,
                   quantized_cache: Optional[bool] = None) -> UniGenPipeline:
    """A pipeline from a run's config (``model`` a mapping of
    ``initialize_config``; module docstring), or one of the code-built
    configurations with random weights from ``seed`` (0 by default).
    ``seed``, ``vision``, ``quantization`` and ``quantized_cache`` belong to
    the code-built configurations: a config sets them itself, so passing
    them with one raises.

    ``model="flagship"``: Qwen2.5-1.5B + MAGViTv2 (256 px, 8192 codes), bf16
    by default; with ``vision`` also the SigLIP-SO400M tower (384 px, patch
    14, 26 of 27 layers) and the 2-layer MM projector 1152 -> 1536, as
    ``configs/unigen_1_5b/unigen_sft.yaml`` sets them. ``model="tiny"``: two
    narrow layers, an 8 px tokenizer with 16 tokens and a 32-entry codebook,
    with ``vision`` a 3-layer 32-wide tower over 28 px images (4 patches),
    fp32 by default, with the byte tokenizer's special ids moved down to 256
    so they fit the tiny vocabulary. ``vision="naflex"`` takes the
    SigLIP2-NaFlex tower instead (``models.siglip2``: at the flagship
    ``google/siglip2-so400m-patch16-naflex``'s shape, patch 16, a budget of
    256 patches, 26 of 27 layers; tiny: 3 layers 32 wide, patch 4, 16 patches).

    ``quantization="int8"`` (JAX's ``model.quantization=int8``) puts the
    backbone, the image and text heads and, with ``vision``, the SigLIP
    tower on W8A8 (``ops.quantization``; the NaFlex tower stays float, as in
    JAX); ``"int4"`` puts the backbone and
    the text head on W4A8 (``ops.int4``, group 256; 32 at the tiny width). ``quantized_cache``
    gives ``understand`` and ``generate_text`` an int8 KV cache.
    """
    if isinstance(model, Mapping):
        given = {k: v for k, v in (("seed", seed), ("vision", vision), ("quantization",
                                   quantization), ("quantized_cache", quantized_cache))
                 if v is not None}
        if given:
            raise ValueError(f"build_pipeline(config) takes its settings from the config, not "
                             f"{sorted(given)} (model.quantization=int8 quantizes)")
        return _pipeline_from_config(model, dtype, device)
    if vision not in (None, False, True, "siglip", "naflex"):
        raise ValueError(f"vision must be a bool, 'siglip' or 'naflex', got {vision!r}")
    naflex = vision == "naflex"
    seed, vision, quantized_cache = seed or 0, bool(vision), bool(quantized_cache)
    if quantization not in (None, "int8", "int4"):
        raise ValueError(f"quantization must be None, 'int8' or 'int4', got {quantization!r}")
    device = resolve_device(device)
    if model == "flagship":
        dtype = dtype or torch.bfloat16
        tokenizer = FallbackTokenizer()
        prompting = build_prompting(tokenizer)
        text_vocab_len = len(tokenizer)
        vocab = text_vocab_len + 8192 + 1
        vision_cfg = None if not vision else Siglip2Config.naflex(dtype=dtype) if naflex else \
            SiglipConfig.so400m(dtype=dtype)
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
        vision_cfg = None if not vision else Siglip2Config.tiny(dtype=dtype) if naflex else \
            SiglipConfig.tiny(dtype=dtype)
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
    vision_params = None if not vision else (init_siglip2 if naflex else init_siglip)(
        vision_cfg, gen, device, dtype)
    if quantization == "int8":
        params = quantize_unigen_params(params, cfg, lm_head=True)
        if vision and not naflex:
            vision_params = quantize_siglip_params(vision_params)
    elif quantization == "int4":
        params = quantize_unigen_params_int4(params, cfg, group=256 if model == "flagship" else 32)
    return UniGenPipeline(params, cfg, vq_params, vq_cfg, prompting, device,
                          vision_params=vision_params, vision_cfg=vision_cfg,
                          quantized_cache=quantized_cache)
