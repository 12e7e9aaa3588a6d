"""SigLIP vision tower (SigLIP-SO400M-patch14-384), inference only.

Port of ``unigen_tpu/models/siglip.py``: a 14x14 stride-14 patch conv plus
learned position embeddings, pre-LN encoder layers (fp32 layer norm, tanh
GELU MLP), bidirectional attention over the patch grid. The tower drops its
last encoder layer and has no post-layernorm and no pooling head: its output
is the hidden state after ``num_layers_used`` layers, 729 features of width
1152 for 384 px images.

Parameters are a dict: ``patch_embed`` keeps the JAX HWIO kernel, and each
layer is a dict with layer norms ``ln1``/``ln2`` ({scale, bias}) and linear
weights in PyTorch's [out, in] layout (``q_w``, ``q_b``, ..., ``fc2_b``).
Attention runs through ``ops.flash_attention`` with every token marked
bidirectional, as the JAX package does on the TPU; the head dim is
zero-padded to one the kernel is built for (72 -> 80, 8 -> 16) with the real
``dh ** -0.5`` scale, which leaves the result unchanged.

An int8 tower (``ops.quantization.quantize_siglip_params``) holds ``<name>:
{'kernel_int8', 'scale', 'bias'}`` for q, k, v, o, fc1 and fc2 and runs them
W8A8 (q/k/v on one activation quantization), as the JAX package does; the
patch embedding and the layer norms stay float.

On a tree sharded by ``parallel.partition.partition_siglip`` (column-parallel
q/k/v and fc1, row-parallel o and fc2) a rank runs its own heads (16 of 72
become 8 a rank at ``model=2``, padded to 80 for kernel 2 as before): the
input enters through ``copy_to_model``, o and fc2 leave through
``reduce_from_model`` with their biases added after the reduce, and fsdp
shards are gathered at the top of each layer. The tree's spec tree comes
beside it (``specs=``, ``parallel.Sharding.tree``); without one the tree
must be whole, and the forward checks each local shape it reads against
the config (the patch embedding, the position table, layer 0's
projections and norms), raising a ``ValueError`` that names the leaf.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from ..ops.flash_attention import flash_attention, kernel_head_dim
from ..parallel import collectives as C
from ..ops.masks import BIDIRQ_BIT
from ..ops.quantization import (dense_int8, dense_int8_prequant, is_quantized,
                                quantize_activations)
from ..utils.persistence import take


@dataclasses.dataclass(frozen=True)
class SiglipConfig:
    hidden_size: int = 1152
    intermediate_size: int = 4304
    num_hidden_layers: int = 27
    num_attention_heads: int = 16
    num_channels: int = 3
    image_size: int = 384
    patch_size: int = 14
    layer_norm_eps: float = 1e-6
    drop_last_layer: bool = True
    dtype: Any = torch.float32

    @property
    def num_layers_used(self) -> int:
        return self.num_hidden_layers - (1 if self.drop_last_layer else 0)

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @classmethod
    def so400m(cls, **kw) -> "SiglipConfig":
        return cls(**kw)

    @classmethod
    def tiny(cls, **kw) -> "SiglipConfig":
        defaults = dict(hidden_size=32, intermediate_size=64, num_hidden_layers=3,
                        num_attention_heads=4, image_size=28, patch_size=14)
        defaults.update(kw)
        return cls(**defaults)


def layer_norm(p: Dict[str, torch.Tensor], x: torch.Tensor, eps: float) -> torch.Tensor:
    """Layer norm in fp32 (population variance), cast back to x.dtype."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    xf = (xf - mean) * torch.rsqrt(var + eps)
    return (xf * p["scale"].float() + p["bias"].float()).to(x.dtype)


def _bidir_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     scale: float) -> torch.Tensor:
    """Unmasked self-attention over the patch grid; q, k, v [B, L, H, dh]."""
    b, l, _, dh = q.shape
    pad = kernel_head_dim(dh) - dh
    if pad:
        q, k, v = (F.pad(t, (0, pad)) for t in (q, k, v))
    meta = torch.full((b, l), BIDIRQ_BIT, dtype=torch.int32, device=q.device)
    out = flash_attention(q, k, v, meta, scale=scale)
    return out[..., :dh] if pad else out


def _dense(p: Dict, name: str, x: torch.Tensor) -> torch.Tensor:
    if is_quantized(p.get(name)):
        return dense_int8(p[name], x)
    return F.linear(x, p[f"{name}_w"], p[f"{name}_b"])


def _dense_row(p: Dict, name: str, x: torch.Tensor, tp: bool) -> torch.Tensor:
    """A row-parallel product under tensor parallelism: the partial sums
    reduced over ``model``, then the bias."""
    if not tp:
        return _dense(p, name, x)
    return C.reduce_from_model(F.linear(x, p[f"{name}_w"])) + p[f"{name}_b"]


def check_layers(layers, cfg) -> None:
    """Layer 0 of a tower without specs is whole: its projections' output
    and input features and its norms against the config (SigLIP's and
    SigLIP2's)."""
    d, inter = cfg.hidden_size, cfg.intermediate_size
    p = layers[0]
    for name, (n_out, n_in) in (("q", (d, d)), ("k", (d, d)), ("v", (d, d)), ("o", (d, d)),
                                ("fc1", (inter, d)), ("fc2", (d, inter))):
        if is_quantized(p.get(name)):
            shape = (p[name]["scale"].shape[0], p[name]["kernel_int8"].shape[1])
            C.expect_whole("layers/0/{}'s output and input features", shape, (n_out, n_in), name)
        else:
            C.expect_whole("layers/0/{}_w's shape", tuple(p[f"{name}_w"].shape), (n_out, n_in),
                           name)
    for name in ("ln1", "ln2"):
        C.expect_whole("layers/0/{}/scale's size", p[name]["scale"].numel(), d, name)


def _encoder_layer(p: Dict, cfg: SiglipConfig, x: torch.Tensor,
                   attend=_bidir_attention, sp: Optional[Dict] = None) -> torch.Tensor:
    """One pre-LN layer under its specs ``sp``; ``attend(q, k, v, scale)``
    on [B, L, H, dh] is its attention (SigLIP2-NaFlex passes its key-masked
    one)."""
    p, sp = C.gather_tree(p, sp)
    b, l, d = x.shape
    h = cfg.num_attention_heads
    dh = d // h
    tp = C.model_dim(C.sub(sp, "q_w")) is not None
    if tp:
        h = p["q_w"].shape[0] // dh
    res = x
    x = layer_norm(p["ln1"], x, cfg.layer_norm_eps)
    if tp:
        x = C.copy_to_model(x)
    if is_quantized(p.get("q")):
        # q/k/v share the input: one activation quantization for all three
        x8, xs = quantize_activations(x)
        q, k, v = (dense_int8_prequant(p[n], x8, xs, x.dtype).view(b, l, h, dh)
                   for n in ("q", "k", "v"))
    else:
        q, k, v = (_dense(p, n, x).view(b, l, h, dh) for n in ("q", "k", "v"))
    attn = attend(q, k, v, dh ** -0.5).reshape(b, l, h * dh)
    x = res + _dense_row(p, "o", attn, tp)
    res = x
    x = layer_norm(p["ln2"], x, cfg.layer_norm_eps)
    tp_mlp = C.model_dim(C.sub(sp, "fc1_w")) is not None
    if tp_mlp:
        x = C.copy_to_model(x)
    x = F.gelu(_dense(p, "fc1", x), approximate="tanh")
    return res + _dense_row(p, "fc2", x, tp_mlp)


@torch.no_grad()
def forward(params: Dict, cfg: SiglipConfig, pixel_values: torch.Tensor,
            specs: Optional[Dict] = None) -> torch.Tensor:
    """pixels [B, H, W, 3] (normalized to [-1, 1]) -> patch features [B, P, D].
    ``specs`` None: the tower is whole, and checked so."""
    if specs is None:
        p, d = cfg.patch_size, cfg.hidden_size
        C.expect_whole("patch_embed/kernel's shape", tuple(params["patch_embed"]["kernel"].shape),
                (p, p, cfg.num_channels, d))
        C.expect_whole("pos_embed's shape", tuple(params["pos_embed"].shape), (cfg.num_patches, d))
        check_layers(params["layers"], cfg)
    pe, _ = C.gather_tree(params["patch_embed"], C.sub(specs, "patch_embed"))
    w = pe["kernel"].to(cfg.dtype).permute(3, 2, 0, 1)   # HWIO -> OIHW
    x = F.conv2d(pixel_values.to(cfg.dtype).permute(0, 3, 1, 2), w, stride=cfg.patch_size)
    x = x.permute(0, 2, 3, 1) + pe["bias"].to(cfg.dtype)
    b, gh, gw, d = x.shape
    pos = C.gather_fsdp(params["pos_embed"], C.sub(specs, "pos_embed"))[0]
    x = x.reshape(b, gh * gw, d) + pos.to(cfg.dtype)[None]
    for i, lp in enumerate(params["layers"]):
        x = _encoder_layer(lp, cfg, x, sp=C.sub(specs, "layers", i))
    return x


# ---------------------------------------------------------------------------
# HF weight import
# ---------------------------------------------------------------------------

# the port's dense leaves and their modules in HF's SigLIP encoder layer
HF_DENSE = {"q": "self_attn.q_proj", "k": "self_attn.k_proj", "v": "self_attn.v_proj",
            "o": "self_attn.out_proj", "fc1": "mlp.fc1", "fc2": "mlp.fc2"}


def hf_encoder_layers(sd: Dict[str, torch.Tensor], cfg, prefix: str, device) -> list:
    """The first ``cfg.num_layers_used`` HF encoder layers (SigLIP's or
    SigLIP2's) -> one dict a layer in ``cfg.dtype`` on ``device``; the
    dropped last layer is not read."""

    def get(name):
        return take(sd, prefix + name, device, cfg.dtype)

    layers = []
    for i in range(cfg.num_layers_used):
        at = f"encoder.layers.{i}."
        lp: Dict[str, Any] = {ln: {"scale": get(f"{at}layer_norm{n}.weight"),
                                   "bias": get(f"{at}layer_norm{n}.bias")}
                              for ln, n in (("ln1", 1), ("ln2", 2))}
        for name, module in HF_DENSE.items():
            lp[f"{name}_w"] = get(f"{at}{module}.weight")
            lp[f"{name}_b"] = get(f"{at}{module}.bias")
        layers.append(lp)
    return layers


def convert_hf_state_dict(sd: Dict[str, torch.Tensor], cfg: SiglipConfig,
                          prefix: str = "vision_model.", device="cpu") -> Dict[str, Any]:
    """A HF ``SiglipVisionModel`` state dict -> the port's tower, each leaf on
    ``device`` in ``cfg.dtype``: the patch convolution OIHW -> HWIO, stored
    contiguous; the first ``num_layers_used`` layers (the last layer,
    ``post_layernorm`` and ``head.*`` are not read, as in JAX). A missing
    key raises ``KeyError`` naming it."""
    patch = prefix + "embeddings.patch_embedding."
    return {"patch_embed": {"kernel": take(sd, patch + "weight", device, cfg.dtype)
                            .permute(2, 3, 1, 0).contiguous(),
                            "bias": take(sd, patch + "bias", device, cfg.dtype)},
            "pos_embed": take(sd, prefix + "embeddings.position_embedding.weight", device,
                              cfg.dtype),
            "layers": hf_encoder_layers(sd, cfg, prefix, device)}
