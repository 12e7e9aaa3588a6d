"""UniGen: Qwen2.5 backbone plus the unified image vocabulary.

Port of ``unigen_tpu/models/unigen.py`` but its init (``weights.py`` draws
the port's parameters):

* the unified vocabulary ``vocab_size = text_vocab_len + codebook_size + 1``,
  image token i at ``i + text_vocab_len``, the mask token at ``vocab_size - 1``;
* the optional gen projector: a (codebook+1)-entry embedding + MLP for image
  tokens and a separate ``img_head``;
* the understanding projector (``w_und_encoder``): vision-tower features
  -> LLM hidden space through ``mm_projector``, an MLP with the exact GELU
  (the SigLIP tower itself uses the tanh GELU);
* the three-task training forward: (logits, loss_t2i, loss_lm, loss_mmu)
  over one fused batch, its CE dense (``_cross_entropy``) or chunked along
  the sequence (``_chunked_ce``: 64 positions a chunk, each under
  ``torch.utils.checkpoint``, fp32 log-softmax and sums, so the [B, L, V]
  fp32 logits never exist at once; JAX's ``jax.checkpoint`` scan body).

Under ``parallel/``: ``img_head`` is column-parallel over the codes and its
logits are gathered before the CE and the samplers (``qwen2.project``), as
are the vocab-parallel text head's; the projectors and ``gen_embed``
replicate (gathered at use when fsdp shards them). Every function here
takes the tree's spec tree as ``specs`` (``parallel.Sharding.tree``; None
for a whole tree) and hands each model its subtree. Inside a sharded step
(``collectives.batch_sharded``) each CE's valid count is summed over the
batch group before the division, so a rank's loss is its share of the
global mean.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..parallel import collectives as C
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


def mlp_apply(layers: List[Dict], x: torch.Tensor, specs: Optional[List] = None
              ) -> torch.Tensor:
    """Linear -> (GELU -> Linear)*; layers hold {"w": [out, in], "b": [out]}."""
    for i, p in enumerate(layers):
        if i > 0:
            x = F.gelu(x, approximate="none")
        sp = C.sub(specs, i)
        w, b = (C.gather_fsdp(p[k], C.sub(sp, k))[0] for k in ("w", "b"))
        x = F.linear(x, w.to(x.dtype), b.to(x.dtype))
    return x


def get_gen_embed(params: Dict, img_tokens: torch.Tensor, specs: Optional[Dict] = None
                  ) -> torch.Tensor:
    """(codebook+1)-space image tokens -> LLM hidden embeddings."""
    table = C.gather_fsdp(params["gen_embed"], C.sub(specs, "gen_embed"))[0]
    return mlp_apply(params["gen_projector"], F.embedding(img_tokens, table),
                     C.sub(specs, "gen_projector"))


def mm_project(params: Dict, image_feats: torch.Tensor, specs: Optional[Dict] = None
               ) -> torch.Tensor:
    """Vision-tower features [B, P, mm_input_dim] -> [B, P, hidden]."""
    return mlp_apply(params["mm_projector"], image_feats, C.sub(specs, "mm_projector"))


def embed_tokens(params: Dict, input_ids: torch.Tensor, specs: Optional[Dict] = None
                 ) -> torch.Tensor:
    return qwen2.embed(params["llm"], input_ids, C.sub(specs, "llm"))


def _splice_t2i_block(embeds: torch.Tensor, img: torch.Tensor, n: int) -> torch.Tensor:
    """``embeds`` with the trailing image block [-(n + 1):-1] of its first
    img.shape[0] rows replaced by ``img`` (no in-place write)."""
    bt, l = img.shape[0], embeds.shape[1]
    rows = torch.cat([embeds[:bt, :l - n - 1], img.to(embeds.dtype), embeds[:bt, l - 1:]], dim=1)
    return torch.cat([rows, embeds[bt:]], dim=0)


def prepare_inputs_for_t2i(params: Dict, cfg: UniGenConfig, input_ids: torch.Tensor,
                           specs: Optional[Dict] = None) -> torch.Tensor:
    """Token embeddings with the trailing image block routed through the gen
    projector when there is one."""
    embeds = embed_tokens(params, input_ids, specs)
    if cfg.use_gen_projector:
        n = cfg.num_vq_tokens
        embeds = _splice_t2i_block(
            embeds, get_gen_embed(params, input_ids[:, -(n + 1):-1], specs), n)
    return embeds


def _cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                   ignore_id: int = -100) -> torch.Tensor:
    """Mean CE over non-ignored positions, fp32 (== F.cross_entropy); in a
    sharded step this rank's share (the count is the batch group's)."""
    valid = labels != ignore_id
    safe = torch.where(valid, labels, torch.zeros_like(labels))
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    total = torch.where(valid, nll, torch.zeros_like(nll)).sum()
    return total / torch.clamp(C.batch_sum(valid.sum()), min=1)


def _chunk_label_logps(h_c: torch.Tensor, w: torch.Tensor, lab_c: torch.Tensor,
                       ignore_id: int, per_row: bool, spec) -> Tuple[torch.Tensor, torch.Tensor]:
    logits = qwen2.project(h_c, w, spec).float()
    valid = lab_c != ignore_id
    safe = torch.where(valid, lab_c, torch.zeros_like(lab_c))
    tok = torch.gather(torch.log_softmax(logits, dim=-1), -1, safe[..., None])[..., 0]
    tok = torch.where(valid, tok, torch.zeros_like(tok))
    if per_row:
        return tok.sum(-1), valid.sum(-1, dtype=torch.int32)
    return tok.sum(), valid.sum(dtype=torch.int32)


def _chunked_label_logps(hidden: torch.Tensor, w: torch.Tensor, labels: torch.Tensor, *,
                         ignore_id: int = -100, chunk: int = 64, per_row: bool = False,
                         spec=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum of label log-probs, valid count) projecting hidden [B, L, D]
    through ``w`` [V, D] (of spec ``spec``: ``qwen2.project``) chunk by
    chunk along the sequence, each chunk recomputed in the backward; scalar
    totals, or [B] with ``per_row``."""
    b, l, _ = hidden.shape
    shape = (b,) if per_row else ()
    total = torch.zeros(shape, dtype=torch.float32, device=hidden.device)
    count = torch.zeros(shape, dtype=torch.int32, device=hidden.device)
    for s in range(0, l, chunk):
        t, c = checkpoint(_chunk_label_logps, hidden[:, s:s + chunk], w,
                          labels[:, s:s + chunk], ignore_id, per_row, spec, use_reentrant=False)
        total = total + t
        count = count + c
    return total, count


def _chunked_ce(hidden: torch.Tensor, w: torch.Tensor, labels: torch.Tensor,
                ignore_id: int = -100, chunk: int = 64, spec=None) -> torch.Tensor:
    """Mean CE over non-ignored positions, chunked (== ``_cross_entropy``)."""
    total, count = _chunked_label_logps(hidden, w, labels, ignore_id=ignore_id, chunk=chunk,
                                        spec=spec)
    return -total / torch.clamp(C.batch_sum(count), min=1)


def forward(
    params: Dict,
    cfg: UniGenConfig,
    *,
    input_ids: Optional[torch.Tensor] = None,
    input_embeddings: Optional[torch.Tensor] = None,
    attention_mask: Optional[torch.Tensor] = None,   # [B, 1, L, L] bool
    meta_bits: Optional[torch.Tensor] = None,        # [B, L] int32 (flash kernel)
    labels: Optional[torch.Tensor] = None,
    batch_size_t2i: int = 0,
    batch_size_lm: int = 0,
    batch_size_mmu: int = 0,
    t2i_mode: str = "mask",
    remat: bool = False,
    memory_efficient_loss: bool = False,
    return_hidden: bool = False,
    positions: Optional[torch.Tensor] = None,        # [B, L] RoPE positions
    specs: Optional[Dict] = None,                    # the tree's specs (None: whole)
):
    """Unified forward. Without labels: the logits (the image logits when the
    gen projector is active and the batch is t2i). With labels: (logits,
    loss_t2i, loss_lm, loss_mmu), each loss over its slice of the batch
    (t2i rows first, then lm, then mmu); the logits are None with
    ``memory_efficient_loss``. ``return_hidden`` returns the final hidden
    states."""
    n = cfg.num_vq_tokens
    use_gen = cfg.use_gen_projector and batch_size_t2i > 0
    llm_specs = C.sub(specs, "llm")
    if input_embeddings is None:
        input_embeddings = qwen2.embed(params["llm"], input_ids, llm_specs)
        if use_gen:
            # only the t2i rows' image block goes through the gen projector
            img = get_gen_embed(params, input_ids[:batch_size_t2i, -(n + 1):-1], specs)
            input_embeddings = _splice_t2i_block(input_embeddings, img, n)

    hidden, _ = qwen2.forward(params["llm"], cfg.llm, inputs_embeds=input_embeddings,
                              mask=attention_mask, meta_bits=meta_bits, remat=remat,
                              positions=positions, specs=llm_specs)
    if return_hidden:
        return hidden
    bt, bl, bm = batch_size_t2i, batch_size_lm, batch_size_mmu
    zero = torch.zeros((), dtype=torch.float32, device=hidden.device)

    if memory_efficient_loss and labels is not None and not use_gen:
        w, spec = qwen2.lm_head(params["llm"], cfg.llm, llm_specs)
        loss_t2i = loss_lm = loss_mmu = zero
        if bt > 0:
            if t2i_mode == "mask":
                loss_t2i = _chunked_ce(hidden[:bt, -(n + 1):-1], w, labels[:bt, -(n + 1):-1],
                                       spec=spec)
            else:
                loss_t2i = _chunked_ce(hidden[:bt, -(n + 2):-1], w, labels[:bt, -(n + 1):],
                                       spec=spec)
        if bl > 0:
            loss_lm = _chunked_ce(hidden[bt:bt + bl, :-1], w, labels[bt:bt + bl, 1:], spec=spec)
        if bm > 0:
            loss_mmu = _chunked_ce(hidden[-bm:, :-1], w, labels[-bm:, 1:], spec=spec)
        return None, loss_t2i, loss_lm, loss_mmu

    if use_gen:
        img_logits = qwen2.project(hidden[:bt], *C.gather_fsdp(params["img_head"],
                                                               C.sub(specs, "img_head")))
        if labels is None:
            return img_logits
        logits = qwen2.logits(params["llm"], cfg.llm, hidden[bt:], specs=llm_specs)
        lm_start = 0
    else:
        img_logits = None
        logits = qwen2.logits(params["llm"], cfg.llm, hidden, specs=llm_specs)
        if labels is None:
            return logits
        lm_start = bt

    loss_t2i = loss_lm = loss_mmu = zero
    if bt > 0:
        src = img_logits if img_logits is not None else logits[:bt]
        if t2i_mode == "mask":
            loss_t2i = _cross_entropy(src[:, -(n + 1):-1], labels[:bt, -(n + 1):-1])
        elif t2i_mode == "ar":
            loss_t2i = _cross_entropy(src[:, -(n + 2):-1], labels[:bt, -(n + 1):])
        else:
            raise ValueError(t2i_mode)
    if bl > 0:
        loss_lm = _cross_entropy(logits[lm_start:lm_start + bl, :-1], labels[bt:bt + bl, 1:])
    if bm > 0:
        loss_mmu = _cross_entropy(logits[-bm:, :-1], labels[-bm:, 1:])
    return (img_logits if img_logits is not None else logits), loss_t2i, loss_lm, loss_mmu
