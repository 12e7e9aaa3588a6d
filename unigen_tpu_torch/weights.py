"""Parameters for the port: the bridge from JAX trees and a random init.

The JAX package holds parameters as nested dicts and lists of arrays; after
``jax.tree.map(np.asarray, params)`` they are numpy arrays. This module turns
them into the port's layout:

* stacked ``[num_layers, ...]`` layer leaves become one dict per layer;
* dense kernels stored ``[K, N]`` (``x @ kernel``) become PyTorch's
  ``[N, K]`` (``F.linear``);
* HWIO conv kernels stay HWIO (the MAGViT functions keep the JAX layout);
* the tied embedding stays ``[V, D]`` and serves as the image head by row
  slice;
* bfloat16 leaves (``ml_dtypes`` arrays, which ``torch.from_numpy`` cannot
  take) are detected by dtype name and reinterpreted through int16;
* W4A8 leaves (``ops.int4``: ``kernel_int4`` int8 ``[K/2, Npad]``,
  ``scale4`` fp32 and ``bias``) are carried over unchanged, split per layer:
  the packed layout is the same in both frameworks;
* W8A8 leaves (``kernel_int8`` int8 ``[K, N]``, ``scale`` fp32, ``bias``?)
  become the port's ``[Npad, K]`` (``ops.quantization``): transposed, rows
  padded with zeros to a multiple of 8; scale and bias unchanged. So do an
  int8 ``lm_head_q`` and the int8 image head ``img_head_q``;
* the SigLIP tower keeps its HWIO patch kernel (``models.siglip``); the
  SigLIP2-NaFlex tower's patch embedding is a dense ``w`` [D, 3 p p] and
  ``b`` (``models.siglip2``); both keep one dict per encoder layer;
* LoRA adapters (``training/lora.py``: JAX's stacked ``lora_a [L, in, r]``,
  ``lora_b [L, r, out]`` and ``lora_scale [L]`` inside a dense node, float
  or quantized) become the layer's ``<name>_lora_a``, ``<name>_lora_b`` and
  ``<name>_lora_scale`` leaves, in their own dtype, and go back the same way.

The ``*_from_jax`` functions also take trees whose leaves are tensors
(``utils.persistence.from_pretrained``); ``unigen_to_jax``, ``siglip_to_jax``,
``siglip2_to_jax`` and ``magvit_to_jax`` are the way back, from the same key tables, for
``utils.persistence.save_pretrained`` (float trees).

``init_unigen`` / ``init_magvit`` / ``init_siglip`` / ``init_siglip2`` build the same layout
from a ``torch.Generator`` on the target device, with the JAX inits' scales
(dense: normal * fan_in^-1/2, embeddings: normal * 0.02, conv: normal *
(kh*kw*cin)^-1/2, biases zero, norm scales one).
"""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from .models.magvit import MagvitConfig
from .models.qwen2 import LORA_SUFFIXES
from .models.siglip import SiglipConfig
from .models.siglip2 import Siglip2Config
from .models.unigen import UniGenConfig
from .ops.quantization import int8_leaf


def _arr(a):
    """A leaf as it is when it is a tensor, else as a numpy array."""
    return a if isinstance(a, torch.Tensor) else np.asarray(a)


def to_tensor(a, device="cpu", dtype=None) -> torch.Tensor:
    """numpy array (bfloat16 included) or tensor -> tensor on ``device``,
    cast to ``dtype``."""
    if isinstance(a, torch.Tensor):
        return a.contiguous().to(device=device, dtype=dtype or a.dtype)
    a = np.asarray(a)
    a = np.ascontiguousarray(a).reshape(a.shape)     # a 0-d array stays 0-d
    if not a.flags.writeable:           # torch.from_numpy wants writable memory
        a = a.copy()
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16).view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device=device, dtype=dtype or t.dtype)


def _linear_w(a, device, dtype) -> torch.Tensor:
    """[K, N] JAX dense kernel -> [N, K]."""
    return to_tensor(_arr(a).T, device, dtype)


_LAYER_LEAVES = {
    "input_ln": ("input_ln", "scale"), "post_ln": ("post_ln", "scale"),
    "q_w": ("attn", "q", "kernel"), "q_b": ("attn", "q", "bias"),
    "k_w": ("attn", "k", "kernel"), "k_b": ("attn", "k", "bias"),
    "v_w": ("attn", "v", "kernel"), "v_b": ("attn", "v", "bias"),
    "o_w": ("attn", "o", "kernel"),
    "gate_w": ("mlp", "gate", "kernel"), "up_w": ("mlp", "up", "kernel"),
    "down_w": ("mlp", "down", "kernel"),
}


# the layer's projections and their JAX nodes; LoRA adapters ride beside them
_PROJECTIONS = {name[:-2]: path[:-1] for name, path in _LAYER_LEAVES.items() if name.endswith("_w")}


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _mlp_from_jax(layers, device, dtype) -> List[Dict[str, torch.Tensor]]:
    return [{"w": _linear_w(p["kernel"], device, dtype), "b": to_tensor(p["bias"], device, dtype)}
            for p in layers]


_INT4_LEAVES = ("kernel_int4", "scale4", "bias")


def _int4_from_jax(p, device, i=None) -> Dict[str, torch.Tensor]:
    """A W4A8 leaf, unchanged (layer ``i`` of a stacked one)."""
    return {k: to_tensor(_arr(p[k]) if i is None else _arr(p[k])[i], device)
            for k in _INT4_LEAVES}


def _int8_from_jax(p, device, i=None) -> Dict[str, torch.Tensor]:
    """A W8A8 leaf (layer ``i`` of a stacked one) in the port's layout."""
    def get(k):
        return _arr(p[k]) if i is None else _arr(p[k])[i]
    return int8_leaf(to_tensor(get("kernel_int8"), device).t(), to_tensor(get("scale"), device),
                     to_tensor(get("bias"), device) if "bias" in p else None)


def _quantized_from_jax(p, device, i=None) -> Dict[str, torch.Tensor]:
    return _int8_from_jax(p, device, i) if "kernel_int8" in p else _int4_from_jax(p, device, i)


def unigen_from_jax(tree: Dict[str, Any], cfg: UniGenConfig, device="cpu",
                    dtype=None) -> Dict[str, Any]:
    """JAX ``unigen.init`` tree (numpy leaves) -> the port's parameters. A
    tree quantized by JAX's ``quantize_unigen_params`` (W8A8) or
    ``quantize_unigen_params_int4`` (W4A8) keeps its quantized leaves: each
    layer holds ``q``, ..., ``down`` as {kernel_int8, scale, bias?} or
    {kernel_int4, scale4, bias}, and the heads ``lm_head_q`` and
    ``img_head_q`` come along."""
    dtype = dtype or cfg.llm.dtype
    llm = tree["llm"]
    stacked = llm["layers"]
    layers = []
    for i in range(cfg.llm.num_hidden_layers):
        lp = {}
        for name, path in _LAYER_LEAVES.items():
            dense = _get(stacked, path[:-1])
            if "kernel_int4" in dense or "kernel_int8" in dense:
                if name.endswith("_w"):
                    lp[name[:-2]] = _quantized_from_jax(dense, device, i)
                continue
            leaf = _arr(_get(stacked, path))[i]
            lp[name] = (_linear_w(leaf, device, dtype) if name.endswith("_w")
                        else to_tensor(leaf, device, dtype))
        for name, path in _PROJECTIONS.items():
            dense = _get(stacked, path)
            if "lora_a" in dense:
                lp.update({f"{name}_{k}": to_tensor(_arr(dense[k])[i], device)
                           for k in LORA_SUFFIXES})
        layers.append(lp)
    out: Dict[str, Any] = {"llm": {"embed": to_tensor(llm["embed"]["weight"], device, dtype),
                                   "layers": layers,
                                   "final_ln": to_tensor(llm["final_ln"]["scale"], device, dtype)}}
    if "lm_head" in llm:
        out["llm"]["lm_head"] = _linear_w(llm["lm_head"]["kernel"], device, dtype)
    if "lm_head_q" in llm:
        out["llm"]["lm_head_q"] = _quantized_from_jax(llm["lm_head_q"], device)
    if "img_head_q" in tree:
        out["img_head_q"] = _int8_from_jax(tree["img_head_q"], device)
    if "gen_embed" in tree:
        out["gen_embed"] = to_tensor(tree["gen_embed"]["weight"], device, dtype)
        out["gen_projector"] = _mlp_from_jax(tree["gen_projector"], device, dtype)
        out["img_head"] = _linear_w(tree["img_head"]["kernel"], device, dtype)
    if "mm_projector" in tree:
        out["mm_projector"] = _mlp_from_jax(tree["mm_projector"], device, dtype)
    return out


_SIGLIP_DENSE = {"q": ("attn", "q"), "k": ("attn", "k"), "v": ("attn", "v"),
                 "o": ("attn", "o"), "fc1": ("mlp", "fc1"), "fc2": ("mlp", "fc2")}


def _siglip_layers_from_jax(stacked: Dict[str, Any], n: int, device, dtype) -> List[Dict]:
    """JAX's stacked encoder layers -> ``n`` per-layer dicts ([N, K] linear
    weights; W8A8 leaves kept)."""
    layers = []
    for i in range(n):
        lp: Dict[str, Any] = {
            ln: {k: to_tensor(_arr(stacked[ln][k])[i], device, dtype)
                 for k in ("scale", "bias")} for ln in ("ln1", "ln2")}
        for name, path in _SIGLIP_DENSE.items():
            p = _get(stacked, path)
            if "kernel_int8" in p:
                lp[name] = _int8_from_jax(p, device, i)
                continue
            lp[f"{name}_w"] = _linear_w(_arr(p["kernel"])[i], device, dtype)
            lp[f"{name}_b"] = to_tensor(_arr(p["bias"])[i], device, dtype)
        layers.append(lp)
    return layers


def siglip_from_jax(tree: Dict[str, Any], cfg: SiglipConfig, device="cpu",
                    dtype=None) -> Dict[str, Any]:
    """JAX ``siglip.init`` tree -> the port's tower (HWIO patch kernel kept,
    one dict per layer, [N, K] linear weights; a tower quantized by JAX's
    ``quantize_siglip_params`` keeps its W8A8 leaves)."""
    dtype = dtype or cfg.dtype
    return {"patch_embed": {k: to_tensor(tree["patch_embed"][k], device, dtype)
                            for k in ("kernel", "bias")},
            "pos_embed": to_tensor(tree["pos_embed"]["weight"], device, dtype),
            "layers": _siglip_layers_from_jax(tree["layers"], cfg.num_layers_used, device,
                                              dtype)}


def siglip2_from_jax(tree: Dict[str, Any], cfg: Siglip2Config, device="cpu",
                     dtype=None) -> Dict[str, Any]:
    """JAX ``siglip2.init`` tree -> the port's NaFlex tower: the patch
    embedding as [D, 3 p p] ``w`` and ``b``, the position grid [N, D], one
    dict per layer as ``siglip_from_jax``'s."""
    dtype = dtype or cfg.dtype
    return {"patch_embed": {"w": _linear_w(_arr(tree["patch_embed"]["kernel"]), device, dtype),
                            "b": to_tensor(tree["patch_embed"]["bias"], device, dtype)},
            "pos_embed": to_tensor(tree["pos_embed"]["weight"], device, dtype),
            "layers": _siglip_layers_from_jax(tree["layers"], cfg.num_layers_used, device,
                                              dtype)}


def map_tree(tree, fn):
    """``fn`` of every leaf of a tree of dicts and lists (None leaves kept)."""
    if isinstance(tree, dict):
        return {k: map_tree(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [map_tree(v, fn) for v in tree]
    if tree is None:
        return None
    return fn(tree)


def magvit_from_jax(tree: Dict[str, Any], cfg: MagvitConfig, device="cpu",
                    dtype=None) -> Dict[str, Any]:
    """JAX ``magvit.init`` tree -> the port's encoder and decoder parameters (HWIO kept)."""
    dtype = dtype or cfg.dtype
    return {part: map_tree(tree[part], lambda a: to_tensor(a, device, dtype))
            for part in ("encoder", "decoder")}


# ---------------------------------------------------------------------------
# The way back: the port's float trees in the JAX layout
# ---------------------------------------------------------------------------

def _set(tree, path, leaf) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = leaf


def _float_leaf(name: str, leaf) -> torch.Tensor:
    if not isinstance(leaf, torch.Tensor):
        raise ValueError(f"{name}: only float trees go back to the JAX layout, got a "
                         "quantized leaf; save the tree before quantizing it")
    return leaf


def _mlp_to_jax(layers) -> List[Dict[str, torch.Tensor]]:
    return [{"kernel": p["w"].t(), "bias": p["b"]} for p in layers]


def unigen_to_jax(params: Dict[str, Any], cfg: UniGenConfig) -> Dict[str, Any]:
    """The port's float UniGen parameters -> JAX ``unigen.init``'s tree
    (stacked layers, [K, N] kernels), the inverse of ``unigen_from_jax``."""
    llm = params["llm"]
    stacked: Dict[str, Any] = {}
    for name, path in _LAYER_LEAVES.items():
        leaves = [_float_leaf(name, lp.get(name, lp.get(name[:-2]))) for lp in llm["layers"]]
        _set(stacked, path, torch.stack([t.t() if name.endswith("_w") else t for t in leaves]))
    for name, path in _PROJECTIONS.items():
        if f"{name}_lora_a" in llm["layers"][0]:
            for k in LORA_SUFFIXES:
                _set(stacked, path + (k,), torch.stack([lp[f"{name}_{k}"] for lp in llm["layers"]]))
    out: Dict[str, Any] = {"llm": {"embed": {"weight": llm["embed"]}, "layers": stacked,
                                   "final_ln": {"scale": llm["final_ln"]}}}
    if "lm_head" in llm:
        out["llm"]["lm_head"] = {"kernel": llm["lm_head"].t()}
    if "gen_embed" in params:
        out["gen_embed"] = {"weight": params["gen_embed"]}
        out["gen_projector"] = _mlp_to_jax(params["gen_projector"])
        out["img_head"] = {"kernel": params["img_head"].t()}
    if "mm_projector" in params:
        out["mm_projector"] = _mlp_to_jax(params["mm_projector"])
    return out


def _siglip_layers_to_jax(layers) -> Dict[str, Any]:
    stacked: Dict[str, Any] = {ln: {k: torch.stack([lp[ln][k] for lp in layers])
                                    for k in ("scale", "bias")} for ln in ("ln1", "ln2")}
    for name, path in _SIGLIP_DENSE.items():
        ws = [_float_leaf(name, lp.get(f"{name}_w", lp.get(name))) for lp in layers]
        _set(stacked, path + ("kernel",), torch.stack([w.t() for w in ws]))
        _set(stacked, path + ("bias",), torch.stack([lp[f"{name}_b"] for lp in layers]))
    return stacked


def siglip_to_jax(params: Dict[str, Any], cfg: SiglipConfig) -> Dict[str, Any]:
    """The port's float SigLIP tower -> JAX ``siglip.init``'s tree, the
    inverse of ``siglip_from_jax``."""
    return {"patch_embed": dict(params["patch_embed"]),
            "pos_embed": {"weight": params["pos_embed"]},
            "layers": _siglip_layers_to_jax(params["layers"])}


def siglip2_to_jax(params: Dict[str, Any], cfg: Siglip2Config) -> Dict[str, Any]:
    """The port's float NaFlex tower -> JAX ``siglip2.init``'s tree, the
    inverse of ``siglip2_from_jax``."""
    return {"patch_embed": {"kernel": params["patch_embed"]["w"].t(),
                            "bias": params["patch_embed"]["b"]},
            "pos_embed": {"weight": params["pos_embed"]},
            "layers": _siglip_layers_to_jax(params["layers"])}


def magvit_to_jax(params: Dict[str, Any]) -> Dict[str, Any]:
    """The port's MAGViTv2 parameters -> JAX ``magvit.init``'s tree (the
    layout is the same)."""
    return {part: params[part] for part in ("encoder", "decoder")}


# ---------------------------------------------------------------------------
# Random init
# ---------------------------------------------------------------------------

def _normal(gen, shape, std, device, dtype) -> torch.Tensor:
    return (torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
            * std).to(dtype)


def init_unigen(cfg: UniGenConfig, generator: torch.Generator, device,
                dtype=None) -> Dict[str, Any]:
    """Random UniGen parameters in the port's layout."""
    dtype = dtype or cfg.llm.dtype
    c = cfg.llm
    d, h, kvh, dh, inter = (c.hidden_size, c.num_attention_heads, c.num_key_value_heads,
                            c.head_dim, c.intermediate_size)

    def lin(n_in, n_out):
        return _normal(generator, (n_out, n_in), n_in ** -0.5, device, dtype)

    def zeros(n):
        return torch.zeros(n, device=device, dtype=dtype)

    def ones(n):
        return torch.ones(n, device=device, dtype=dtype)

    layers = [{"input_ln": ones(d), "post_ln": ones(d),
               "q_w": lin(d, h * dh), "q_b": zeros(h * dh),
               "k_w": lin(d, kvh * dh), "k_b": zeros(kvh * dh),
               "v_w": lin(d, kvh * dh), "v_b": zeros(kvh * dh),
               "o_w": lin(h * dh, d),
               "gate_w": lin(d, inter), "up_w": lin(d, inter), "down_w": lin(inter, d)}
              for _ in range(c.num_hidden_layers)]
    llm = {"embed": _normal(generator, (c.vocab_size, d), 0.02, device, dtype),
           "layers": layers, "final_ln": ones(d)}
    if not c.tie_word_embeddings:
        llm["lm_head"] = _normal(generator, (c.vocab_size, d), 0.02, device, dtype)
    out: Dict[str, Any] = {"llm": llm}
    if cfg.use_gen_projector:
        gin = cfg.gen_input_dim if cfg.use_gen_dim else d
        dims = ([gin] + [d] * cfg.gen_proj_depth if cfg.use_gen_dim
                else [d, 2 * d] + [d] * (cfg.gen_proj_depth - 1))
        out["gen_embed"] = _normal(generator, (cfg.codebook_size + 1, gin), 0.02, device, dtype)
        out["gen_projector"] = [{"w": lin(a, b), "b": zeros(b)}
                                for a, b in zip(dims[:-1], dims[1:])]
        out["img_head"] = _normal(generator, (cfg.codebook_size, d), 0.02, device, dtype)
    if cfg.w_und_encoder:
        dims = [cfg.mm_input_dim] + [d] * max(2, cfg.und_proj_depth)
        out["mm_projector"] = [{"w": lin(a, b), "b": zeros(b)}
                               for a, b in zip(dims[:-1], dims[1:])]
    return out


def _siglip_layers_init(cfg, generator, device, dtype) -> List[Dict]:
    d, inter = cfg.hidden_size, cfg.intermediate_size

    def ln():
        return {"scale": torch.ones(d, device=device, dtype=dtype),
                "bias": torch.zeros(d, device=device, dtype=dtype)}

    def dense(name, n_in, n_out):
        return {f"{name}_w": _normal(generator, (n_out, n_in), n_in ** -0.5, device, dtype),
                f"{name}_b": torch.zeros(n_out, device=device, dtype=dtype)}

    layers = []
    for _ in range(cfg.num_layers_used):
        lp: Dict[str, Any] = {"ln1": ln(), "ln2": ln()}
        for name in ("q", "k", "v", "o"):
            lp.update(dense(name, d, d))
        lp.update(dense("fc1", d, inter))
        lp.update(dense("fc2", inter, d))
        layers.append(lp)
    return layers


def init_siglip(cfg: SiglipConfig, generator: torch.Generator, device,
                dtype=None) -> Dict[str, Any]:
    """Random SigLIP tower parameters in the port's layout."""
    dtype = dtype or cfg.dtype
    d, p, c = cfg.hidden_size, cfg.patch_size, cfg.num_channels
    layers = _siglip_layers_init(cfg, generator, device, dtype)
    return {"patch_embed": {"kernel": _normal(generator, (p, p, c, d), (p * p * c) ** -0.5,
                                              device, dtype),
                            "bias": torch.zeros(d, device=device, dtype=dtype)},
            "pos_embed": _normal(generator, (cfg.num_patches, d), 0.02, device, dtype),
            "layers": layers}


def init_siglip2(cfg: Siglip2Config, generator: torch.Generator, device,
                 dtype=None) -> Dict[str, Any]:
    """Random SigLIP2-NaFlex tower parameters in the port's layout (JAX's
    scales: the patch embedding normal * (3 p p)^-1/2, the grid normal * 0.02)."""
    dtype = dtype or cfg.dtype
    d = cfg.hidden_size
    layers = _siglip_layers_init(cfg, generator, device, dtype)
    return {"patch_embed": {"w": _normal(generator, (d, cfg.patch_dim), cfg.patch_dim ** -0.5,
                                         device, dtype),
                            "b": torch.zeros(d, device=device, dtype=dtype)},
            "pos_embed": _normal(generator, (cfg.num_patches, d), 0.02, device, dtype),
            "layers": layers}


def init_magvit(cfg: MagvitConfig, generator: torch.Generator, device,
                dtype=None) -> Dict[str, Any]:
    """Random MAGViTv2 parameters (HWIO convs), the JAX tree's structure. The
    decoder is drawn first, so a seed gives the same decoder with or without
    the encoder."""
    dtype = dtype or cfg.dtype

    def conv(k, cin, cout):
        return {"kernel": _normal(generator, (k, k, cin, cout), (k * k * cin) ** -0.5,
                                  device, dtype),
                "bias": torch.zeros(cout, device=device, dtype=dtype)}

    def gn(ch):
        return {"scale": torch.ones(ch, device=device, dtype=dtype),
                "bias": torch.zeros(ch, device=device, dtype=dtype)}

    def res(cin, cout):
        p = {"norm1": gn(cin), "conv1": conv(3, cin, cout),
             "norm2": gn(cout), "conv2": conv(3, cout, cout)}
        if cin != cout:
            p["nin_shortcut"] = conv(1, cin, cout)
        return p

    def attn(ch):
        return {"norm": gn(ch), "q": conv(1, ch, ch), "k": conv(1, ch, ch),
                "v": conv(1, ch, ch), "proj_out": conv(1, ch, ch)}

    num_levels = len(cfg.dec_ch_mult)
    block_in = cfg.ch * cfg.dec_ch_mult[-1]
    curr_res = cfg.resolution // 2 ** (num_levels - 1)
    p: Dict[str, Any] = {"post_quant_conv": conv(1, cfg.z_channels, cfg.z_channels),
                         "conv_in": conv(3, cfg.z_channels, block_in),
                         "mid": {"block_1": res(block_in, block_in), "attn_1": attn(block_in),
                                 "block_2": res(block_in, block_in)}}
    up: List[Any] = [None] * num_levels
    for i_level in reversed(range(num_levels)):
        level: Dict[str, Any] = {"block": [], "attn": []}
        block_out = cfg.ch * cfg.dec_ch_mult[i_level]
        for _ in range(cfg.dec_num_res_blocks[i_level]):
            level["block"].append(res(block_in, block_out))
            block_in = block_out
            if curr_res in cfg.attn_resolutions:
                level["attn"].append(attn(block_in))
        if i_level != 0:
            level["upsample"] = {"conv": conv(3, block_in, block_in)}
            curr_res *= 2
        up[i_level] = level
    p["up"] = up
    p["norm_out"] = gn(block_in)
    p["conv_out"] = conv(3, block_in, cfg.out_ch)

    in_ch_mult = (1,) + tuple(cfg.enc_ch_mult)
    num_levels = len(cfg.enc_ch_mult)
    curr_res = cfg.resolution
    enc: Dict[str, Any] = {"conv_in": conv(3, cfg.in_ch, cfg.ch)}
    down: List[Any] = []
    for i_level in range(num_levels):
        level = {"block": [], "attn": []}
        block_in = cfg.ch * in_ch_mult[i_level]
        block_out = cfg.ch * cfg.enc_ch_mult[i_level]
        for _ in range(cfg.enc_num_res_blocks[i_level]):
            level["block"].append(res(block_in, block_out))
            block_in = block_out
            if curr_res in cfg.attn_resolutions:
                level["attn"].append(attn(block_in))
        if i_level != num_levels - 1:
            level["downsample"] = {"conv": conv(3, block_in, block_in)}
            curr_res //= 2
        down.append(level)
    enc["down"] = down
    enc["mid"] = {"block_1": res(block_in, block_in), "attn_1": attn(block_in),
                  "block_2": res(block_in, block_in)}
    enc["norm_out"] = gn(block_in)
    enc["conv_out"] = conv(3, block_in, cfg.z_channels)
    enc["quant_conv"] = conv(1, cfg.z_channels, cfg.z_channels)
    return {"encoder": enc, "decoder": p}


_TOP_LEAVES = {"llm/embed": "llm/embed/weight", "llm/final_ln": "llm/final_ln/scale",
               "llm/lm_head": "llm/lm_head/kernel", "gen_embed": "gen_embed/weight",
               "img_head": "img_head/kernel"}


def jax_leaf_path(path: str) -> str:
    """A float UniGen leaf's ``/``-joined path in the port's tree (list
    indices as numbers) -> the path of the JAX tree leaf it comes from, e.g.
    ``llm/layers/3/q_b`` -> ``llm/layers/attn/q/bias``,
    ``llm/layers/3/q_lora_a`` -> ``llm/layers/attn/q/lora_a``. The optimizer's
    decay, freezing and lr-multiplier patterns match these paths, as JAX's
    do."""
    if path in _TOP_LEAVES:
        return _TOP_LEAVES[path]
    parts = path.split("/")
    if len(parts) == 4 and parts[:2] == ["llm", "layers"] and parts[3] in _LAYER_LEAVES:
        return "llm/layers/" + "/".join(_LAYER_LEAVES[parts[3]])
    if len(parts) == 4 and parts[:2] == ["llm", "layers"] and "_lora_" in parts[3]:
        name, kind = parts[3].split("_lora_")
        if name in _PROJECTIONS and f"lora_{kind}" in LORA_SUFFIXES:
            return "llm/layers/" + "/".join(_PROJECTIONS[name]) + f"/lora_{kind}"
    if len(parts) == 3 and parts[0] in ("gen_projector", "mm_projector") and parts[2] in ("w", "b"):
        return f"{parts[0]}/{parts[1]}/{'kernel' if parts[2] == 'w' else 'bias'}"
    raise KeyError(f"{path} is not a leaf of a float UniGen tree")


def tree_to(tree, device) -> Any:
    """Move every tensor of a parameter tree to ``device``."""
    return map_tree(tree, lambda t: t.to(device))
