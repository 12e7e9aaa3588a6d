"""Understanding / text decode with a prefix-LM KV cache.

Port of ``unigen_tpu/generation/decode.py``: one prefill over the prompt,
then a cached decode of ``max_new_tokens - 1`` steps. Batch rows may be
right-padded to a common length; each row keeps its own prompt length for
the rotary positions, and pad slots are never visible.

Routing (the same function as the JAX package; only pad query rows differ,
and those are never read):

* the prefill goes cache-free through ``ops.flash_attention`` with a packed
  per-token bitfield (``meta_bits``): the caller's mask as metadata, e.g.
  ``ops.masks.mmu_vit_attn_meta`` with the prompt lengths. JAX runs it dense
  against the cache, whose empty slots are masked;
* each decode step goes through ``ops.chunk_attention`` with the per-row key
  mask ``valid`` (the prompt's slots and the decoded ones), which is exactly
  JAX's ``valid[:, None, None, :]`` step mask at one query.

``quantized_cache`` stores K/V in int8 (``qwen2.init_kv_cache(quantize=
True)``): the prefill still runs the flash kernel, on the K/V it wrote to
the cache, and each decode step runs the plain
``ops.attention.dot_product_attention_q8`` with ``valid`` as the key mask
(``models/qwen2.py``).

The loop always runs its full length: a row that emitted ``eot_token``
repeats it, as the JAX ``scan`` does, so the output and the kernel launches
do not depend on the weights. ``noise=[max_new_tokens, B, V]`` takes
pre-drawn uniform[0, 1) numbers instead of the generator (the shared-noise
hook). ``specs`` is the spec tree of a sharded ``params`` (None: whole),
passed to every forward.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..models import qwen2
from ..models.unigen import UniGenConfig, embed_tokens
from ..ops import masks as M
from ..ops import sampling as S
from ..parallel import collectives as C


def _sample_step(generator: Optional[torch.Generator], logits: torch.Tensor,
                 temperature: float, top_k: Optional[int],
                 inj: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Greedy (temperature 0: the first maximum) or temperature / top-k
    sampling: logits below the k-th largest become -inf before the softmax."""
    if temperature > 0:
        logits = logits / temperature
        if top_k is not None:
            kth = torch.topk(logits, min(top_k, logits.shape[-1]), dim=-1).values[..., -1:]
            logits = torch.where(logits < kth, float("-inf"), logits)
        probs = torch.softmax(logits, dim=-1)
        return S.sample_categorical(generator, probs, noise=inj)
    return torch.argmax(logits, dim=-1)


def _decode_loop(params, cfg: UniGenConfig, generator, cache: qwen2.KVCache,
                 valid: torch.Tensor, first_tok: torch.Tensor, prompt_len: torch.Tensor,
                 max_new_tokens: int, temperature: float, top_k: Optional[int],
                 eot_token: Optional[int], noise: Optional[torch.Tensor] = None,
                 specs=None) -> torch.Tensor:
    """Cached decode from the token sampled at the prefill: [B, max_new_tokens]."""
    b, total = valid.shape
    eot = -1 if eot_token is None else eot_token
    done = first_tok == eot
    slots = torch.arange(total, device=valid.device)
    tok, toks = first_tok, [first_tok]
    llm_specs = C.sub(specs, "llm")
    for t in range(max_new_tokens - 1):
        valid = valid | (slots == cache.index)[None]         # the slot this step writes
        hidden, cache = qwen2.forward(params["llm"], cfg.llm,
                                      inputs_embeds=embed_tokens(params, tok[:, None], specs),
                                      positions=(prompt_len + t)[:, None], cache=cache,
                                      kv_rowmask=valid, specs=llm_specs)
        logits = qwen2.logits(params["llm"], cfg.llm, hidden[:, -1], specs=llm_specs).float()
        nxt = _sample_step(generator, logits, temperature, top_k,
                           None if noise is None else noise[t + 1])
        nxt = torch.where(done, eot, nxt)
        if eot_token is not None:
            done = done | (nxt == eot)
        tok = nxt
        toks.append(nxt)
    return torch.stack(toks, dim=1)


@torch.no_grad()
def mmu_generate(
    params,
    cfg: UniGenConfig,
    generator: Optional[torch.Generator],
    *,
    input_ids: Optional[torch.Tensor] = None,          # [B, L] (discrete path)
    input_embeddings: Optional[torch.Tensor] = None,   # [B, L, D] (continuous path)
    meta_bits: torch.Tensor,                           # [B, L] int32 prefill mask
    prompt_len: torch.Tensor,                          # [B] valid prompt length per row
    max_new_tokens: int = 100,
    temperature: float = 1.0,
    top_k: Optional[int] = None,
    eot_token: Optional[int] = None,
    quantized_cache: bool = False,
    noise: Optional[torch.Tensor] = None,
    specs=None,
) -> torch.Tensor:
    """VQA / captioning decode. Returns [B, max_new_tokens] token ids; rows
    stop at ``eot_token`` and then repeat it. ``meta_bits`` must mark every
    slot at or beyond a row's ``prompt_len`` as pad. ``quantized_cache``
    keeps K/V in int8."""
    if input_embeddings is None:
        input_embeddings = embed_tokens(params, input_ids, specs)
    b, l, _ = input_embeddings.shape
    dev = input_embeddings.device
    prompt_len = prompt_len.to(device=dev, dtype=torch.long)
    llm_specs = C.sub(specs, "llm")
    cache = qwen2.init_kv_cache(cfg.llm, b, l + max_new_tokens, dev, quantize=quantized_cache,
                                num_kv_heads=qwen2.local_kv_heads(params["llm"], cfg.llm,
                                                                  llm_specs))
    pos = torch.arange(l, device=dev)[None]
    positions = torch.minimum(pos, prompt_len[:, None] - 1)   # pads collapse, masked anyway
    hidden, cache = qwen2.forward(params["llm"], cfg.llm, inputs_embeds=input_embeddings,
                                  meta_bits=meta_bits, positions=positions, cache=cache,
                                  specs=llm_specs)
    last_hidden = hidden[torch.arange(b, device=dev), prompt_len - 1]
    first = _sample_step(generator, qwen2.logits(params["llm"], cfg.llm, last_hidden,
                                                 specs=llm_specs).float(),
                         temperature, top_k, None if noise is None else noise[0])
    valid = torch.cat([pos < prompt_len[:, None],
                       torch.zeros((b, max_new_tokens), dtype=torch.bool, device=dev)], dim=1)
    return _decode_loop(params, cfg, generator, cache, valid, first, prompt_len,
                        max_new_tokens, temperature, top_k, eot_token, noise, specs)


def generate_text(
    params,
    cfg: UniGenConfig,
    generator: Optional[torch.Generator],
    input_ids: torch.Tensor,                           # [B, L] right-padded
    prompt_len: torch.Tensor,                          # [B]
    max_new_tokens: int = 100,
    temperature: float = 0.0,
    top_k: Optional[int] = None,
    eot_token: Optional[int] = None,
    quantized_cache: bool = False,
    specs=None,
) -> torch.Tensor:
    """Plain causal text generation with the same cached decode loop."""
    prompt_len = prompt_len.to(device=input_ids.device, dtype=torch.long)
    pos = torch.arange(input_ids.shape[1], device=input_ids.device)[None]
    pad = pos >= prompt_len[:, None]
    z = torch.zeros_like(pad)
    meta = M.pack_meta(M.AttnMeta(pad=pad, bidir_q=z, bidir_k=z))
    return mmu_generate(params, cfg, generator, input_ids=input_ids, meta_bits=meta,
                        prompt_len=prompt_len, max_new_tokens=max_new_tokens,
                        temperature=temperature, top_k=top_k, eot_token=eot_token,
                        quantized_cache=quantized_cache, specs=specs)
