"""MAGViTv2 tokenizer (encoder, LFQ, decoder), NHWC activations and HWIO kernels.

Port of ``unigen_tpu/models/magvit.py`` for inference. The layout stays
NHWC / HWIO at the public functions so that the port and the JAX package are
compared like with like. Resblock and upsample 3x3 convolutions go through
``ops.fused_conv.conv3x3_gn_swish`` at every shape (its CUDA kernel on a GPU
tensor, its plain version on a CPU tensor); ``conv_in``, ``conv_out``, the
stride-2 downsample, the 1x1 convolutions and the attention block are plain
PyTorch, as JAX leaves them to XLA.

Encoder (ch 128, ch_mult [1,2,2,4,4], res-blocks [4,3,4,3,4]): 256x256x3
pixels -> 16x16 latents with 13 channels -> LFQ signs -> 256 codes of 13 bits.
Decoder (ch_mult [1,1,2,2,4], res-blocks [4,4,3,4,3]): the mirror image.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..ops.fused_conv import conv2d, conv3x3_gn_swish, group_norm, swish
from ..utils.persistence import take


@dataclasses.dataclass(frozen=True)
class MagvitConfig:
    ch: int = 128
    enc_ch_mult: Sequence[int] = (1, 2, 2, 4, 4)
    enc_num_res_blocks: Sequence[int] = (4, 3, 4, 3, 4)
    dec_ch_mult: Sequence[int] = (1, 1, 2, 2, 4)
    dec_num_res_blocks: Sequence[int] = (4, 4, 3, 4, 3)
    attn_resolutions: Sequence[int] = (5,)
    in_ch: int = 3
    out_ch: int = 3
    resolution: int = 256
    z_channels: int = 13
    beta: float = 0.25
    entropy_multiplier: float = 0.1
    commit_loss_multiplier: float = 0.1
    dtype: Any = torch.float32

    @property
    def codebook_size(self) -> int:
        return 2 ** self.z_channels

    @classmethod
    def tiny(cls, **kw) -> "MagvitConfig":
        defaults = dict(ch=16, enc_ch_mult=(1, 2), enc_num_res_blocks=(1, 1),
                        dec_ch_mult=(1, 2), dec_num_res_blocks=(1, 1),
                        resolution=16, z_channels=4)
        defaults.update(kw)
        return cls(**defaults)


def resblock(p: Dict, x: torch.Tensor) -> torch.Tensor:
    """Norm-swish-conv twice, with a 1x1 shortcut when the width changes."""
    h = conv3x3_gn_swish(p["conv1"], p["norm1"], x)
    h = conv3x3_gn_swish(p["conv2"], p["norm2"], h)
    if "nin_shortcut" in p:
        x = conv2d(p["nin_shortcut"], x)
    return x + h


def attn_block(p: Dict, x: torch.Tensor) -> torch.Tensor:
    """Single-head full attention over the HxW grid (fp32 logits and softmax)."""
    b, h, w, c = x.shape
    hn = group_norm(p["norm"], x)
    q = conv2d(p["q"], hn).reshape(b, h * w, c)
    k = conv2d(p["k"], hn).reshape(b, h * w, c)
    v = conv2d(p["v"], hn).reshape(b, h * w, c)
    logits = torch.einsum("bqc,bkc->bqk", q.float(), k.float())
    weights = torch.softmax(logits * (c ** -0.5), dim=-1).to(x.dtype)
    out = torch.einsum("bqk,bkc->bqc", weights, v).reshape(b, h, w, c)
    return x + conv2d(p["proj_out"], out)


def upsample(p: Dict, x: torch.Tensor) -> torch.Tensor:
    """Nearest x2 then conv3x3."""
    b, h, w, c = x.shape
    x = x[:, :, None, :, None, :].expand(b, h, 2, w, 2, c).reshape(b, 2 * h, 2 * w, c)
    return conv3x3_gn_swish(p["conv"], None, x)


def downsample(p: Dict, x: torch.Tensor) -> torch.Tensor:
    """Asymmetric (0, 1, 0, 1) pad, then a stride-2 VALID conv3x3."""
    x = F.pad(x, (0, 0, 0, 1, 0, 1))
    return conv2d(p["conv"], x, stride=2, padding="VALID")


def encoder_forward(p: Dict, cfg: MagvitConfig, x: torch.Tensor) -> torch.Tensor:
    """pixels [B, H, W, 3] in [-1, 1] -> continuous latents [B, h, w, z]."""
    h = conv2d(p["conv_in"], x)
    num_levels = len(cfg.enc_ch_mult)
    for i_level in range(num_levels):
        level = p["down"][i_level]
        for i_block, bp in enumerate(level["block"]):
            h = resblock(bp, h)
            if level["attn"]:
                h = attn_block(level["attn"][i_block], h)
        if i_level != num_levels - 1:
            h = downsample(level["downsample"], h)
    h = resblock(p["mid"]["block_1"], h)
    h = attn_block(p["mid"]["attn_1"], h)
    h = resblock(p["mid"]["block_2"], h)
    h = conv2d(p["conv_out"], swish(group_norm(p["norm_out"], h)))
    return conv2d(p["quant_conv"], h)


def decoder_forward(p: Dict, cfg: MagvitConfig, z: torch.Tensor) -> torch.Tensor:
    """latents [B, h, w, z] (quantized) -> pixels [B, H, W, 3]."""
    z = conv2d(p["post_quant_conv"], z)
    h = conv2d(p["conv_in"], z)
    h = resblock(p["mid"]["block_1"], h)
    h = attn_block(p["mid"]["attn_1"], h)
    h = resblock(p["mid"]["block_2"], h)
    for i_level in reversed(range(len(cfg.dec_ch_mult))):
        level = p["up"][i_level]
        for i_block, bp in enumerate(level["block"]):
            h = resblock(bp, h)
            if level["attn"]:
                h = attn_block(level["attn"][i_block], h)
        if i_level != 0:
            h = upsample(level["upsample"], h)
    return conv2d(p["conv_out"], swish(group_norm(p["norm_out"], h)))


def lfq_quantize(z: torch.Tensor) -> torch.Tensor:
    """Sign quantization z -> +-1 (z > 0 -> 1), straight-through for gradients."""
    z_q = torch.where(z > 0, 1.0, -1.0).to(z.dtype)
    return z + (z_q - z).detach()


def lfq_indices(z_q: torch.Tensor, z_channels: int) -> torch.Tensor:
    """+-1 latents [B, h, w, z] -> int32 tokens [B, h, w], big-endian bits."""
    power_vals = 2 ** torch.arange(z_channels - 1, -1, -1, device=z_q.device,
                                   dtype=torch.int32)
    bits = (z_q > 0).to(torch.int32)
    return torch.sum(bits * power_vals, dim=-1, dtype=torch.int32)


def lfq_losses(z: torch.Tensor, beta: float = 0.25) -> Dict[str, torch.Tensor]:
    """Entropy and commitment losses of the LFQ quantizer (forward values,
    fp32): per dimension a two-way categorical over the distances to +-1."""
    zf = z.float().reshape(-1, z.shape[-1])
    z_q = torch.where(zf > 0, 1.0, -1.0)
    z_q_ste = zf + (z_q - zf).detach()
    logit = torch.stack([-(zf - 1.0) ** 2, -(zf + 1.0) ** 2], dim=-1)
    logp = torch.log_softmax(logit, dim=-1)
    probs = torch.exp(logp)
    entropy = (-(probs * logp).sum(-1)).mean()
    mean_prob = probs.mean(0)
    mean_entropy = (-(mean_prob * torch.log(mean_prob + 1e-12)).sum(-1)).mean()
    commit = (torch.mean((z_q.detach() - zf) ** 2)
              + beta * torch.mean((z_q_ste - zf.detach()) ** 2))
    return {"entropy_loss": entropy - mean_entropy, "commit_loss": commit}


def lfq_codebook_entry(indices: torch.Tensor, z_channels: int,
                       dtype=torch.float32) -> torch.Tensor:
    """int tokens [B, N] -> +-1 latents [B, sqrt(N), sqrt(N), z] (big-endian bits)."""
    b, n = indices.shape
    side = int(n ** 0.5)
    shifts = torch.arange(z_channels - 1, -1, -1, device=indices.device,
                          dtype=indices.dtype)
    bits = (indices[..., None] >> shifts) & 1
    return (bits.to(dtype) * 2.0 - 1.0).reshape(b, side, side, z_channels)


@torch.no_grad()
def decode_code(params: Dict, cfg: MagvitConfig, codebook_indices: torch.Tensor) -> torch.Tensor:
    """tokens [B, N] -> pixels [B, H, W, 3]."""
    z_q = lfq_codebook_entry(codebook_indices, cfg.z_channels, cfg.dtype)
    return decoder_forward(params["decoder"], cfg, z_q)


@torch.no_grad()
def encode(params: Dict, cfg: MagvitConfig, pixel_values: torch.Tensor
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """pixels [B, H, W, 3] -> (+-1 latents [B, h, w, z], tokens [B, h * w] int32)."""
    z_q = lfq_quantize(encoder_forward(params["encoder"], cfg, pixel_values))
    return z_q, lfq_indices(z_q, cfg.z_channels).reshape(pixel_values.shape[0], -1)


def get_code(params: Dict, cfg: MagvitConfig, pixel_values: torch.Tensor) -> torch.Tensor:
    """pixels [B, H, W, 3] -> tokens [B, h * w] int32."""
    return encode(params, cfg, pixel_values)[1]


# ---------------------------------------------------------------------------
# Torch weight import (reference checkpoints are NCHW torch state dicts)
# ---------------------------------------------------------------------------

def convert_torch_state_dict(sd: Dict[str, torch.Tensor], cfg: MagvitConfig,
                             device="cpu") -> Dict[str, Any]:
    """The reference MAGViTv2 state dict -> the port's encoder and decoder,
    each leaf on ``device`` in ``cfg.dtype``: convolutions OIHW -> HWIO,
    stored contiguous (kernel 3 would copy a strided weight at every
    launch). The levels follow ``enc_ch_mult`` / ``dec_ch_mult``, their
    res-block counts and ``attn_resolutions``; a res-block has
    ``nin_shortcut`` only where its channels change (JAX magvit.py:374-449).
    A missing key raises ``KeyError`` naming it."""
    def conv(name):
        return {"kernel": take(sd, name + ".weight", device, cfg.dtype)
                .permute(2, 3, 1, 0).contiguous(),
                "bias": take(sd, name + ".bias", device, cfg.dtype)}

    def gn(name):
        return {"scale": take(sd, name + ".weight", device, cfg.dtype),
                "bias": take(sd, name + ".bias", device, cfg.dtype)}

    def res(name, cin, cout):
        p = {"norm1": gn(name + ".norm1"), "conv1": conv(name + ".conv1"),
             "norm2": gn(name + ".norm2"), "conv2": conv(name + ".conv2")}
        if cin != cout:
            p["nin_shortcut"] = conv(name + ".nin_shortcut")
        return p

    def attn(name):
        return {"norm": gn(name + ".norm"), "q": conv(name + ".q"), "k": conv(name + ".k"),
                "v": conv(name + ".v"), "proj_out": conv(name + ".proj_out")}

    def mid(part, ch):
        return {"block_1": res(f"{part}.mid.block_1", ch, ch), "attn_1": attn(f"{part}.mid.attn_1"),
                "block_2": res(f"{part}.mid.block_2", ch, ch)}

    enc: Dict[str, Any] = {"conv_in": conv("encoder.conv_in"),
                           "quant_conv": conv("encoder.quant_conv"),
                           "conv_out": conv("encoder.conv_out"),
                           "norm_out": gn("encoder.norm_out")}
    in_ch_mult = (1,) + tuple(cfg.enc_ch_mult)
    num_levels = len(cfg.enc_ch_mult)
    curr_res = cfg.resolution
    down = []
    block_in = cfg.ch
    for i in range(num_levels):
        level: Dict[str, Any] = {"block": [], "attn": []}
        block_in = cfg.ch * in_ch_mult[i]
        block_out = cfg.ch * cfg.enc_ch_mult[i]
        for j in range(cfg.enc_num_res_blocks[i]):
            level["block"].append(res(f"encoder.down.{i}.block.{j}", block_in, block_out))
            block_in = block_out
            if curr_res in cfg.attn_resolutions:
                level["attn"].append(attn(f"encoder.down.{i}.attn.{j}"))
        if i != num_levels - 1:
            level["downsample"] = {"conv": conv(f"encoder.down.{i}.downsample.conv")}
            curr_res //= 2
        down.append(level)
    enc["down"] = down
    enc["mid"] = mid("encoder", block_in)

    num_levels = len(cfg.dec_ch_mult)
    block_in = cfg.ch * cfg.dec_ch_mult[num_levels - 1]
    curr_res = cfg.resolution // 2 ** (num_levels - 1)
    dec: Dict[str, Any] = {"post_quant_conv": conv("decoder.post_quant_conv"),
                           "conv_in": conv("decoder.conv_in"),
                           "conv_out": conv("decoder.conv_out"),
                           "norm_out": gn("decoder.norm_out"),
                           "mid": mid("decoder", block_in)}
    up: list = [None] * num_levels
    for i in reversed(range(num_levels)):
        level = {"block": [], "attn": []}
        block_out = cfg.ch * cfg.dec_ch_mult[i]
        for j in range(cfg.dec_num_res_blocks[i]):
            level["block"].append(res(f"decoder.up.{i}.block.{j}", block_in, block_out))
            block_in = block_out
            if curr_res in cfg.attn_resolutions:
                level["attn"].append(attn(f"decoder.up.{i}.attn.{j}"))
        if i != 0:
            level["upsample"] = {"conv": conv(f"decoder.up.{i}.upsample.conv")}
            curr_res *= 2
        up[i] = level
    dec["up"] = up
    return {"encoder": enc, "decoder": dec}
