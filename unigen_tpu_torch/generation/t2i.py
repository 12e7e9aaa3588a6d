"""Text-to-image samplers with classifier-free guidance: MaskGIT and autoregressive.

Port of ``unigen_tpu/generation/t2i.py::t2i_generate`` (both paths) and
``t2i_generate_ar``, with MaskGIT semantics unchanged: Gumbel-max sampling on the logits, confidence
re-masking with annealed Gumbel noise, the mask_len schedule with its
keep-one / mask-one clamps, and the compounding temperature decay.

* The prefix-cached path prefills the causal text prefix of the cond and
  uncond rows once (through ``ops.flash_attention`` with pad bits: the same
  function as the JAX dense prefill for every non-pad row, and pad rows are
  never visible to a later query), then runs each step's [soi][img x n][eoi]
  chunk against that cache (through ``ops.chunk_attention`` with the per-row
  key mask).
* The full path re-forwards the whole sequence under the dense omni mask.

``noise=(u_sample [T, B, N, CB], u_mask [T, B, N])`` takes pre-drawn
uniform[0, 1) arrays instead of the generator: fed the same numbers and the
same logits, the port and the JAX package emit the same tokens.

``t2i_generate_ar`` prefills the cond and uncond prompts (through
``ops.flash_attention`` with pad bits) and then emits one image token a step
against the KV cache (through ``ops.chunk_attention`` with the per-row key
mask ``valid``); its shared-noise hook is ``noise [N, B, CB]``.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from ..models import qwen2
from ..models.unigen import UniGenConfig, embed_tokens, get_gen_embed
from ..ops import masks as M
from ..ops import sampling as S
from ..ops.quantization import dense_int8

FLOAT_MAX = torch.finfo(torch.float32).max


def _image_head(params, cfg: UniGenConfig, hidden: torch.Tensor) -> torch.Tensor:
    """Codebook logits in fp32. An int8 head (``img_head_q``, from
    ``ops.quantization.quantize_unigen_params(..., cfg)``) runs W8A8; the
    float tied head slices the 8192 image rows of the [V, D] embedding before
    the matmul, and the table is never transposed."""
    if "img_head_q" in params:
        return dense_int8(params["img_head_q"], hidden).float()
    if cfg.use_gen_projector:
        w = params["img_head"]
    else:
        w = qwen2.lm_head_weight(params["llm"], cfg.llm)
        w = w[cfg.text_vocab_len:cfg.text_vocab_len + cfg.codebook_size]
    return torch.nn.functional.linear(hidden, w.to(hidden.dtype)).float()


def _cfg_head_logits(params, cfg: UniGenConfig, hidden_img: torch.Tensor, bsz: int,
                     use_cfg: bool, guidance_scale: float, cfg_combine: str) -> torch.Tensor:
    """Image-head logits with CFG. ``"hidden"`` blends the cond/uncond hidden
    states in fp32 and runs one head matmul (an int8 head quantizes the
    blended activations, as JAX does); ``"logits"`` blends the fp32 logits
    (the reference's operation order)."""
    if use_cfg and cfg_combine == "hidden":
        hc = hidden_img[:bsz].float()
        hu = hidden_img[bsz:].float()
        blended = (guidance_scale * (hc - hu) + hu).to(hidden_img.dtype)
        return _image_head(params, cfg, blended)
    logits = _image_head(params, cfg, hidden_img)
    if use_cfg:
        cond, uncond = logits[:bsz], logits[bsz:]
        logits = guidance_scale * (cond - uncond) + uncond
    return logits


def _embed_image_tokens(params, cfg: UniGenConfig, ids_cb: torch.Tensor) -> torch.Tensor:
    """Codebook-space ids (mask marker = cfg.mask_token_id) -> embeddings."""
    if cfg.use_gen_projector:
        return get_gen_embed(params, ids_cb)
    unified = torch.where(ids_cb == cfg.mask_token_id, ids_cb, ids_cb + cfg.text_vocab_len)
    return embed_tokens(params, unified)


def _init_ids(cfg: UniGenConfig, input_ids: torch.Tensor, n: int) -> torch.Tensor:
    raw = input_ids[:, -(n + 1):-1]
    if cfg.use_gen_projector:
        return raw
    return torch.where(raw == cfg.mask_token_id, raw, raw - cfg.text_vocab_len)


def _maskgit_update(generator, logits, ids_cb, s, temp, timesteps, n, mask_id,
                    noise_schedule, inj=None):
    """One MaskGIT confidence re-masking step (shared by both paths).

    ``inj``: optional (u_sample [B, N, CB], u_mask [B, N]) pre-drawn uniforms.
    """
    if inj is not None:
        noise = -S.safe_log(-S.safe_log(inj[0].to(logits.dtype)))
    else:
        noise = S.gumbel_noise(generator, logits.shape, logits.device, logits.dtype)
    sampled = torch.argmax(logits + noise, dim=-1)
    unknown = ids_cb == mask_id
    sampled = torch.where(unknown, sampled, ids_cb)

    ratio = torch.tensor(float(s + 1), dtype=torch.float32, device=logits.device) / timesteps
    mask_ratio = noise_schedule(ratio)
    lse = torch.logsumexp(logits, dim=-1)
    selected = torch.exp(torch.gather(logits, -1, sampled[..., None])[..., 0] - lse)
    selected = torch.where(unknown, selected, torch.full_like(selected, FLOAT_MAX))
    mask_len = torch.floor(n * mask_ratio)
    mask_len = torch.clamp(
        torch.minimum(unknown.sum(dim=-1, keepdim=True).float() - 1.0, mask_len), min=1.0)
    temp = temp * (1.0 - ratio)  # compounding decay, as in the reference
    masking = S.mask_by_random_topk(generator, mask_len, selected, temp,
                                    noise=None if inj is None else inj[1])
    new_ids = torch.where(masking, torch.full_like(sampled, mask_id), sampled)
    return new_ids, sampled, temp


@torch.no_grad()
def t2i_generate(
    params,
    cfg: UniGenConfig,
    generator: Optional[torch.Generator],
    input_ids: torch.Tensor,                      # [B, L] cond prompt (image block = mask ids)
    attention_mask: Optional[torch.Tensor],       # [RB, 1, L, L] bool, full path only
    uncond_input_ids: Optional[torch.Tensor] = None,
    temperature: float = 1.0,
    timesteps: int = 18,
    guidance_scale: float = 0.0,
    noise_schedule: Callable[[torch.Tensor], torch.Tensor] = S.cosine_schedule,
    image_token_num_per_image: Optional[int] = None,
    reuse_prefix_cache: bool = True,
    pad_id: Optional[int] = None,
    noise: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    cfg_combine: str = "hidden",
) -> torch.Tensor:
    """MaskGIT masked-token parallel decoding. Returns [B, N] codebook ids."""
    if cfg_combine not in ("hidden", "logits"):
        raise ValueError(f"cfg_combine must be 'hidden' or 'logits', got {cfg_combine!r}")
    n = image_token_num_per_image or cfg.num_vq_tokens
    mask_id = cfg.mask_token_id
    bsz = input_ids.shape[0]
    use_cfg = guidance_scale > 1
    repeat_n = 2 if use_cfg else 1
    dev = input_ids.device

    if reuse_prefix_cache:
        # the cacheable prefix is only the causal text: <|soi|> belongs to the
        # bidirectional image segment, so it rides in the step chunk
        prompt = input_ids[:, :-(n + 2)]
        if use_cfg:
            prompt = torch.cat([prompt, uncond_input_ids[:, :-(n + 2)]], dim=0)
        rb, lp = prompt.shape
        chunk_len = n + 2
        meta = M.pack_meta(M.lm_attn_meta(prompt, pad_id))
        keep = (meta & M.PAD_BIT) == 0
        cache = qwen2.init_kv_cache(cfg.llm, rb, lp + chunk_len, dev)
        _, cache = qwen2.forward(params["llm"], cfg.llm,
                                 inputs_embeds=embed_tokens(params, prompt),
                                 meta_bits=meta, cache=cache)
        soi_emb = embed_tokens(params, input_ids[:, -(n + 2):-(n + 1)]).repeat(repeat_n, 1, 1)
        eoi_emb = embed_tokens(params, input_ids[:, -1:]).repeat(repeat_n, 1, 1)
        # every chunk query sees the non-pad prefix and the whole chunk
        slot_visible = torch.cat([keep, torch.ones((rb, chunk_len), dtype=torch.bool,
                                                   device=dev)], dim=1)
        step_positions = (lp + torch.arange(chunk_len, device=dev))[None].expand(rb, chunk_len)

        def hidden_of(ids_cb):
            img = _embed_image_tokens(params, cfg, ids_cb).repeat(repeat_n, 1, 1)
            chunk = torch.cat([soi_emb, img, eoi_emb], dim=1)
            # rewind the write pointer: every step overwrites the same chunk slots
            hidden, _ = qwen2.forward(params["llm"], cfg.llm, inputs_embeds=chunk,
                                      positions=step_positions,
                                      cache=cache._replace(index=lp),
                                      kv_rowmask=slot_visible)
            return hidden[:, 1:n + 1]
    else:
        input_embeddings = embed_tokens(params, input_ids)
        prefix = input_embeddings[:, :-(n + 1)]
        suffix = input_embeddings[:, -1:]
        if use_cfg:
            uncond_embeddings = embed_tokens(params, uncond_input_ids)
            prefix = torch.cat([prefix, uncond_embeddings[:, :-(n + 1)]], dim=0)
            suffix = torch.cat([suffix, suffix], dim=0)

        def hidden_of(ids_cb):
            img = _embed_image_tokens(params, cfg, ids_cb).repeat(repeat_n, 1, 1)
            embeds = torch.cat([prefix, img, suffix], dim=1)
            hidden, _ = qwen2.forward(params["llm"], cfg.llm, inputs_embeds=embeds,
                                      mask=attention_mask)
            return hidden[:, -(n + 1):-1]

    ids_cb = _init_ids(cfg, input_ids, n)
    temp = torch.tensor(temperature, dtype=torch.float32, device=dev)
    sampled = ids_cb
    for s in range(timesteps):
        logits = _cfg_head_logits(params, cfg, hidden_of(ids_cb), bsz, use_cfg,
                                  guidance_scale, cfg_combine)
        inj = None if noise is None else (noise[0][s], noise[1][s])
        ids_cb, sampled, temp = _maskgit_update(generator, logits, ids_cb, s, temp,
                                                timesteps, n, mask_id, noise_schedule, inj)
    return sampled


@torch.no_grad()
def t2i_generate_ar(
    params,
    cfg: UniGenConfig,
    generator: Optional[torch.Generator],
    input_ids: torch.Tensor,                      # [B, L] cond prompt incl. image block
    uncond_input_ids: torch.Tensor,               # [B, L]
    attention_1d: torch.Tensor,                   # [2B, L] 0/1 padding mask (cond; uncond)
    guidance_scale: float = 0.0,
    temperature: float = 1.0,
    image_token_num_per_image: Optional[int] = None,
    noise: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Autoregressive image generation with CFG on the logits and a KV cache.
    Returns [B, N] codebook ids.

    The cond and uncond rows always run (2B rows, whatever the guidance
    scale), and the logits are ``uncond + guidance_scale * (cond - uncond)``.
    The rotary positions are the cache slots, left pads included:
    ``arange(Lp)`` at the prefill and the slot written at each step.
    ``noise``: optional pre-drawn uniform[0, 1) [N, B, CB], one slice a
    token, used instead of the generator."""
    n = image_token_num_per_image or cfg.num_vq_tokens
    bsz = input_ids.shape[0]
    dev = input_ids.device
    prompt = torch.cat([input_ids[:, :-(n + 1)], uncond_input_ids[:, :-(n + 1)]], dim=0)
    rb, lp = prompt.shape
    total = lp + n
    keep = attention_1d[:, :lp].to(device=dev, dtype=torch.bool)
    z = torch.zeros_like(keep)
    meta = M.pack_meta(M.AttnMeta(pad=~keep, bidir_q=z, bidir_k=z))
    cache = qwen2.init_kv_cache(cfg.llm, rb, total, dev)
    hidden, cache = qwen2.forward(params["llm"], cfg.llm,
                                  inputs_embeds=embed_tokens(params, prompt),
                                  meta_bits=meta, cache=cache)

    def sample_from(hidden_last, inj):
        logits = _image_head(params, cfg, hidden_last)
        cond, uncond = logits[:bsz], logits[bsz:]
        logits = uncond + guidance_scale * (cond - uncond)
        probs = torch.softmax(logits / temperature, dim=-1)
        return S.sample_categorical(generator, probs, noise=inj)

    tok = sample_from(hidden[:, -1], None if noise is None else noise[0])
    toks = [tok]
    valid = torch.cat([keep, torch.zeros((rb, n), dtype=torch.bool, device=dev)], dim=1)
    slots = torch.arange(total, device=dev)
    for t in range(n - 1):
        slot = cache.index                                # the slot this step writes
        valid = valid | (slots == slot)[None]
        emb = _embed_image_tokens(params, cfg, torch.cat([tok, tok])[:, None])
        hidden, cache = qwen2.forward(params["llm"], cfg.llm, inputs_embeds=emb,
                                      positions=torch.full((rb, 1), slot, device=dev),
                                      cache=cache, kv_rowmask=valid)
        tok = sample_from(hidden[:, -1], None if noise is None else noise[t + 1])
        toks.append(tok)
    return torch.stack(toks, dim=1)
