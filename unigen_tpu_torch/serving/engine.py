"""Continuous-batching text and VQA serving engine.

Port of ``unigen_tpu/serving/engine.py``. The engine decodes a fixed set of
``slots`` rows every step and admits a queued request into a row as soon as
one frees:

- each slot row of one shared KV cache holds one request from position 0;
  the cache's index is per row (``qwen2.init_kv_cache(per_row_index=True)``),
  so every row ages on its own, and a decode step writes each row's token at
  its own slot;
- admission prefills K requests of one bucketed length in one cache-free
  forward through the flash kernel (pad bits from the prompt lengths, or the
  mmu_vit bits of ``pipeline.vqa_serving_inputs``), then copies the
  [layers, K, L, KVH, Dh] block into the K slot rows with one ``index_copy_``
  a leaf and sets each row's index to its prompt length; decode overwrites
  the pad slots, which no query ever sees;
- the per-slot decode state (``SlotState``) lives on the device, and a
  decode chunk of ``steps`` steps stops each row itself at its eot or its
  budget-th token, so a chunk reads nothing back to the host: the host takes
  the chunk's tokens once, by a pinned copy and an event, while the next
  chunk already runs (the one-deep pipeline).

With ``speculate_k = k > 0`` every step is a prompt-lookup speculative
verify step (``_spec_decode_chunk``): ``_draft_lookup`` proposes, on the
device, the k tokens that followed the latest earlier occurrence of each
row's current bigram in its token history (``ctx``), one cached forward of
k + 1 queries checks them (kernel 1 with its per-row causal offset, through
``qwen2.forward``'s default mask), and a greedy row advances by the length
of the draft's prefix that matches its own argmax, plus one. Sampled rows
accept one token a step, so every stream is token for token the plain
engine's.

Sampling is keyed by (request seed, token position): a row with temperature
> 0 draws its uniforms from ``ops.sampling.derived_generator(seed,
position)``, the stand-in for JAX's ``fold_in`` keys, so its stream does not
depend on batching, slots or chunk boundaries. Greedy rows draw nothing. The
host knows every position it needs (an occupied row advances one slot a
step), so the generators are made on the host and nothing is read back.

One scheduler thread owns the device and queues every kernel on the
default stream; submitters on any thread only enqueue requests. Eager
PyTorch compiles nothing, so the engine admits exactly K rows (no padding to
a power of two), and ``precompile`` is a warm-up on the scheduler thread.

Under tensor parallelism (params from ``parallel.shard_params``, passed
with their ``Sharding`` as ``sharding=``, every process of the mesh
building the engine with the same arguments) the device
programs call collectives, so every rank must run them in one order. JAX's
GSPMD hides this behind one controller; here process 0 alone takes
``submit`` / ``submit_embeds`` and decides, and at each loop iteration it
broadcasts its plan before it runs it: the cancels its last harvest saw,
the groups it admits (each request's ids or embeddings and meta bits,
lengths, budget, eot, temperature and seed, and the slots they take), and
the chunk's step count with the rows active at its dispatch. The other
ranks run a follower loop that applies the plan with the same admission,
chunk and harvest code, draw from the same ``derived_generator(seed,
position)`` streams, and so emit the same tokens; they check their own
bookkeeping against the plan (free slots, active rows) and raise on any
difference. A follower's futures in flight are ``followed[rid]`` (an entry
leaves when its request ends, unless ``keep_followed``); ``submit`` on a
follower raises. The plan is a fixed-layout int64 header and payload (and
the raw bytes of an embeddings group), not a pickle. A separate decode
tree (W4A8) is sharded on the same mesh as ``params`` and comes with its
own ``decode_sharding``; every cache, int8 or not, holds the rank's KV
heads (``qwen2.local_kv_heads``). The device functions below take each
tree's spec tree (``specs``, ``Sharding.tree``; None for a whole tree).
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import itertools
import queue
import threading
import time
from concurrent.futures import CancelledError
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..device import DeviceLike, fetch_async, resolve_device, to_device
from ..models import qwen2
from ..models.unigen import UniGenConfig, embed_tokens
from ..ops import masks as M
from ..ops import sampling as S
from ..parallel import collectives as C
from ..parallel.mesh import current_mesh
from ..utils import multihost as MH

# process-level memo of the warm-up signatures already dispatched
# (ServingEngine._precompile), under its lock; a key is added only after its
# dispatches succeeded
_PRECOMPILED_KEYS: set = set()
_PRECOMPILED_LOCK = threading.Lock()


class SlotState(NamedTuple):
    """Per-slot decode state on the device, [slots] tensors. A decode chunk
    carries (last_tok, active, emitted) and clears ``active`` the step a
    row's stop condition fires; admission scatters a group's values in. The
    request seeds stay on the host, which makes the generators."""
    last_tok: torch.Tensor   # int64: next input token (sampled last step / at admission)
    active: torch.Tensor     # bool: row is decoding; cleared on the device at eot / budget
    emitted: torch.Tensor    # int32: tokens emitted for the current occupant
    budget: torch.Tensor     # int32: the occupant's max_new_tokens
    eot: torch.Tensor        # int64: stop token id, -1 when none
    temp: torch.Tensor       # float32: sampling temperature


def init_slot_state(slots: int, device: torch.device) -> SlotState:
    def z(dtype):
        return torch.zeros((slots,), dtype=dtype, device=device)
    return SlotState(last_tok=z(torch.int64), active=z(torch.bool), emitted=z(torch.int32),
                     budget=z(torch.int32),
                     eot=torch.full((slots,), -1, dtype=torch.int64, device=device),
                     temp=z(torch.float32))


# A row that samples: (row, request seed, position of its first draw); step s
# of a call draws at position + s.
Draw = Tuple[int, int, int]


def _noise(draws: Sequence[Draw], step: int, rows: int, vocab: int,
           device: torch.device) -> Optional[torch.Tensor]:
    """[rows, vocab] uniforms for one sampling step: row r's from
    ``derived_generator(seed, position + step)``; rows that do not sample get
    0.5, which ``_sample_rows`` discards. None when no row samples."""
    if not draws:
        return None
    u = torch.full((rows, vocab), 0.5, dtype=torch.float32, device=device)
    for row, seed, pos in draws:
        gen = S.derived_generator(seed, pos + step, device=device)
        u[row] = torch.rand((vocab,), generator=gen, device=device)
    return u


def _sample_rows(logits: torch.Tensor, temp: torch.Tensor, top_k: Optional[int],
                 noise: Optional[torch.Tensor]) -> torch.Tensor:
    """Per-row greedy (temp == 0) or temperature / top-k sampling over fp32
    logits [B, V], as JAX's ``_sample_rows``: the temperature rides as a [B]
    tensor, and a sampling row takes its Gumbel noise from its own row of
    ``noise`` (``_noise``)."""
    greedy = torch.argmax(logits, dim=-1)
    if noise is None:
        return greedy
    lg = logits / torch.clamp(temp, min=1e-6)[:, None]
    if top_k is not None:
        kth = torch.topk(lg, min(top_k, lg.shape[-1]), dim=-1).values[..., -1:]
        lg = torch.where(lg < kth, float("-inf"), lg)
    sampled = S.sample_categorical(None, torch.softmax(lg, dim=-1), noise=noise)
    return torch.where(temp > 0, sampled, greedy)


@torch.no_grad()
def _decode_chunk(params, cfg: UniGenConfig, cache: qwen2.KVCache, state: SlotState,
                  steps: int, top_k: Optional[int], draws: Sequence[Draw] = (), specs=None
                  ) -> Tuple[qwen2.KVCache, SlotState, torch.Tensor]:
    """``steps`` decode steps over all slots: (cache, state, toks [B, steps]).

    Each step emits its input token (sampled the step before, or at
    admission), so the first token of a request arrives with the next
    chunk's tokens. A row stops itself the step it emits its eot or its
    budget-th token, the host harvest's break condition; a stopped row's
    index does not advance and its sampled token is 0 until an admission
    resets it. Nothing here reads a tensor back to the host."""
    tok, act, emitted = state.last_tok, state.active, state.emitted
    llm_specs = C.sub(specs, "llm")
    toks = []
    for s in range(steps):
        hidden, cache_n = qwen2.forward(params["llm"], cfg.llm,
                                        inputs_embeds=embed_tokens(params, tok[:, None], specs),
                                        cache=cache, specs=llm_specs)
        lg = qwen2.logits(params["llm"], cfg.llm, hidden[:, 0], specs=llm_specs).float()
        emitted_n = emitted + act.to(torch.int32)
        stop = act & ((tok == state.eot) | (emitted_n >= state.budget))
        act_n = act & ~stop
        noise = _noise(draws, s, lg.shape[0], lg.shape[1], lg.device)
        nxt = _sample_rows(lg, state.temp, top_k, noise)
        nxt = torch.where(act_n, nxt, 0)
        cache = cache_n._replace(index=torch.where(act, cache_n.index, cache.index))
        toks.append(tok)
        tok, act, emitted = nxt, act_n, emitted_n
    state = state._replace(last_tok=tok, active=act, emitted=emitted)
    return cache, state, torch.stack(toks, dim=1)


def _draft_lookup(ctx: torch.Tensor, ctx_start: torch.Tensor, idx: torch.Tensor,
                  tok: torch.Tensor, k: int) -> torch.Tensor:
    """Prompt-lookup draft [B, k], on the device: the k tokens that followed
    the most recent earlier occurrence of the bigram (ctx[b, idx-1], tok[b])
    in row b's history. ``ctx`` [B, C] holds each slot's tokens (prompt and
    accepted decode tokens), valid at ``ctx_start[b] <= j < idx[b]``; ``tok``
    [B] is the next input token, not yet written. A row without a match
    proposes zeros, and its verify step accepts only the model's own token."""
    b, c = ctx.shape
    pos = torch.arange(c, device=ctx.device)
    idx = idx.long()
    tprev = torch.gather(ctx, 1, torch.clamp(idx - 1, min=0)[:, None])
    nxt = torch.cat([ctx[:, 1:], torch.zeros((b, 1), dtype=ctx.dtype, device=ctx.device)], 1)
    match = ((ctx == tprev) & (nxt == tok[:, None]) & (pos >= ctx_start[:, None])
             & (pos + 1 < idx[:, None] - 1))          # the bigram itself is excluded
    j_best = torch.where(match, pos, -1).amax(dim=1)
    first = torch.clamp(j_best + 2, 0, c - k)
    prop = torch.gather(ctx, 1, first[:, None] + torch.arange(k, device=ctx.device))
    return torch.where(j_best[:, None] >= 0, prop, 0)


@torch.no_grad()
def _spec_decode_chunk(params, cfg: UniGenConfig, cache: qwen2.KVCache, state: SlotState,
                       ctx: torch.Tensor, ctx_start: torch.Tensor, steps: int, k: int,
                       top_k: Optional[int], draws: Sequence[Draw] = (), specs=None
                       ) -> Tuple[qwen2.KVCache, SlotState, torch.Tensor, torch.Tensor]:
    """``steps`` speculative steps: (cache, state, toks [B, steps, k+1],
    counts [B, steps]); the host takes ``toks[b, s, :counts[b, s]]``.

    Each step drafts k tokens (``_draft_lookup``), runs one cached forward of
    [tok, draft] (k + 1 queries; under the default mask each sees the cache
    up to its own slot) and accepts, for a greedy row, 1 + the length of the
    draft's prefix equal to the argmax after it; a sampled row accepts 1 and
    draws its token from its (seed, position) noise as ``_decode_chunk``
    does. The row stops inside the accepted block at its eot or its
    budget-th token, the host harvest's break. ``ctx`` is updated in place:
    the emitted block at idx .. idx + k, the start clamped so it fits, as
    JAX's ``dynamic_update_slice``. Rejected positions leave stale K/V and
    ctx entries above the new index, which the next step overwrites before
    any query can see them. Nothing here reads a tensor back to the host."""
    tok, act, emitted = state.last_tok, state.active, state.emitted
    greedy_row = state.temp == 0.0
    jpos = torch.arange(k + 1, device=tok.device)
    llm_specs = C.sub(specs, "llm")
    toks, counts = [], []
    for s in range(steps):
        idx = cache.index
        prop = _draft_lookup(ctx, ctx_start, idx, tok, k)
        inputs = torch.cat([tok[:, None], prop], dim=1)                    # [B, k+1]
        hidden, cache_n = qwen2.forward(params["llm"], cfg.llm,
                                        inputs_embeds=embed_tokens(params, inputs, specs),
                                        cache=cache, specs=llm_specs)
        lg = qwen2.logits(params["llm"], cfg.llm, hidden, specs=llm_specs).float()  # [B, k+1, V]
        noise = _noise(draws, s, lg.shape[0], lg.shape[-1], lg.device)
        g = torch.cat([_sample_rows(lg[:, 0], state.temp, top_k, noise)[:, None],
                       torch.argmax(lg[:, 1:], dim=-1)], dim=1)
        ok = torch.cumprod((prop == g[:, :k]).to(torch.int32), dim=1)
        acc = torch.where(act & greedy_row, 1 + ok.sum(dim=1, dtype=torch.int32), 1)
        emit = torch.cat([tok[:, None], g[:, :k]], dim=1)                  # [B, k+1]
        within = jpos < acc[:, None]
        stop_j = within & ((emit == state.eot[:, None])
                           | (emitted[:, None] + jpos + 1 >= state.budget[:, None]))
        anystop = act & stop_j.any(dim=1)
        valid = torch.where(anystop, torch.argmax(stop_j.to(torch.int32), dim=1) + 1,
                            torch.where(act, acc, 0)).to(torch.int32)
        act_n = act & ~anystop
        nxt = torch.where(act_n, torch.gather(g, 1, (acc.long() - 1)[:, None])[:, 0], 0)
        first = torch.clamp(idx.long(), 0, ctx.shape[1] - (k + 1))
        ctx.scatter_(1, first[:, None] + jpos, emit)
        cache = cache_n._replace(index=torch.where(act, idx + acc, idx))
        toks.append(emit)
        counts.append(acc)
        tok, act, emitted = nxt, act_n, emitted + valid
    state = state._replace(last_tok=tok, active=act, emitted=emitted)
    return cache, state, torch.stack(toks, dim=1), torch.stack(counts, dim=1)


def _ctx_install(ctx: torch.Tensor, ctx_start: torch.Tensor, slots: torch.Tensor,
                 rows: torch.Tensor, starts: torch.Tensor) -> None:
    """Write a group's known token ids [K, L] into the first L entries of its
    slots' context rows, and where each row's draftable history starts, in
    place. The port admits exactly K rows (no padding rows whose slot lies
    past the cache, which JAX's scatter drops), so every row is written."""
    ctx[:, :rows.shape[1]].index_copy_(0, slots, rows)
    ctx_start.index_copy_(0, slots, starts)


def _state_install(state: SlotState, slots: torch.Tensor, first: torch.Tensor,
                   ints: torch.Tensor, temp: torch.Tensor) -> None:
    """Scatter a group's decode state into its slots, in place. ``ints``
    [4, K]: slot, prompt length, budget, eot."""
    state.last_tok.index_copy_(0, slots, first)
    state.active.index_fill_(0, slots, True)
    state.emitted.index_fill_(0, slots, 0)
    state.budget.index_copy_(0, slots, ints[2].to(torch.int32))
    state.eot.index_copy_(0, slots, ints[3])
    state.temp.index_copy_(0, slots, temp)


def _state_deactivate(state: SlotState, slot: int) -> None:
    """Clear a row's active flag on the device (a cancelled request: the
    host frees the slot, and the row would otherwise decode, and advance its
    index, until the next admission reuses it)."""
    state.active[slot] = False


def _leaves(cache: qwen2.KVCache) -> Tuple[str, ...]:
    return ("k", "v", "k_scale", "v_scale") if cache.quantized else ("k", "v")


def _install(cache: qwen2.KVCache, state: SlotState, tmp: qwen2.KVCache, index: torch.Tensor,
             first: torch.Tensor, ints: torch.Tensor, temp: torch.Tensor) -> None:
    """Copy the group's [layers, K, l, ...] block of every leaf into the
    first l slots of its slot rows (one ``index_copy_`` a leaf), set the
    rows' indices and their decode state, in place."""
    slots = ints[0]
    for name in _leaves(cache):
        block = getattr(tmp, name)
        getattr(cache, name)[:, :, :block.shape[2]].index_copy_(1, slots, block)
    cache.index.index_copy_(0, slots, index.to(cache.index.dtype))
    _state_install(state, slots, first, ints, temp)


def _first_tokens(params, cfg: UniGenConfig, hidden: torch.Tensor, prompt_len: torch.Tensor,
                  temp: torch.Tensor, top_k: Optional[int], draws: Sequence[Draw], specs=None
                  ) -> torch.Tensor:
    """Each row's first token, sampled from its hidden state at prompt_len - 1."""
    last = hidden[torch.arange(hidden.shape[0], device=hidden.device), prompt_len - 1]
    lg = qwen2.logits(params["llm"], cfg.llm, last, specs=C.sub(specs, "llm")).float()
    return _sample_rows(lg, temp, top_k, _noise(draws, 0, lg.shape[0], lg.shape[-1], lg.device))


def _prefill(params, cfg: UniGenConfig, inputs_embeds: torch.Tensor, meta_bits: torch.Tensor,
             prompt_len: torch.Tensor, quantize: bool, specs=None
             ) -> Tuple[qwen2.KVCache, torch.Tensor]:
    """K prompts in one cache-free forward through the flash kernel, into a
    K-row temp cache: (temp cache, hidden states). ``meta_bits`` marks every
    slot at or beyond a row's prompt length as pad; pad positions repeat the
    last real one."""
    k, l = inputs_embeds.shape[:2]
    llm_specs = C.sub(specs, "llm")
    tmp = qwen2.init_kv_cache(cfg.llm, k, l, inputs_embeds.device, quantize=quantize,
                              num_kv_heads=qwen2.local_kv_heads(params["llm"], cfg.llm,
                                                                llm_specs))
    positions = torch.minimum(torch.arange(l, device=prompt_len.device)[None],
                              prompt_len[:, None] - 1)
    hidden, tmp = qwen2.forward(params["llm"], cfg.llm, inputs_embeds=inputs_embeds,
                                meta_bits=meta_bits, positions=positions, cache=tmp,
                                specs=llm_specs)
    return tmp, hidden


def _prefill_suffixes(params, cfg: UniGenConfig, prefix: qwen2.KVCache,
                      input_ids: torch.Tensor, quantize: bool, specs=None
                      ) -> Tuple[qwen2.KVCache, torch.Tensor]:
    """The prefix block copied to the K rows of a temp cache, and only the
    suffixes prefilled against it: a cached chunk at positions P .. P + l - 1
    under the default mask, causal within itself (kernel 1 with its per-row
    causal offset; the int8 cache's plain attention). Pad keys of a suffix
    tail are never visible to a real query, and decode overwrites them."""
    p = prefix.k.shape[2]
    k, l = input_ids.shape
    llm_specs = C.sub(specs, "llm")
    tmp = qwen2.init_kv_cache(cfg.llm, k, p + l, input_ids.device, quantize=quantize,
                              num_kv_heads=qwen2.local_kv_heads(params["llm"], cfg.llm,
                                                                llm_specs))
    for name in _leaves(tmp):
        getattr(tmp, name)[:, :, :p] = getattr(prefix, name)
    hidden, tmp = qwen2.forward(params["llm"], cfg.llm,
                                inputs_embeds=embed_tokens(params, input_ids, specs),
                                cache=tmp._replace(index=p), specs=llm_specs)
    return tmp, hidden


def _pad_bits(prompt_len: torch.Tensor, l: int) -> torch.Tensor:
    """[K, l] meta bits of causal prompts padded at and beyond prompt_len."""
    pad = torch.arange(l, device=prompt_len.device)[None] >= prompt_len[:, None]
    z = torch.zeros_like(pad)
    return M.pack_meta(M.AttnMeta(pad=pad, bidir_q=z, bidir_k=z))


@torch.no_grad()
def _admit_core(params, cfg: UniGenConfig, cache: qwen2.KVCache, state: SlotState,
                inputs_embeds: torch.Tensor, meta_bits: torch.Tensor, ints: torch.Tensor,
                temp: torch.Tensor, top_k: Optional[int], draws: Sequence[Draw],
                specs=None) -> None:
    """Prefill K requests in one batched forward and install each into its
    slot row. ``ints`` [4, K]: slot, prompt length, budget, eot."""
    tmp, hidden = _prefill(params, cfg, inputs_embeds, meta_bits, ints[1], cache.quantized,
                           specs)
    first = _first_tokens(params, cfg, hidden, ints[1], temp, top_k, draws, specs)
    _install(cache, state, tmp, ints[1], first, ints, temp)


def _admit_ids(params, cfg, cache, state, input_ids, ints, temp, top_k, draws,
               specs=None) -> None:
    """Batched text admission: the K rows' embeddings and pad bits, one prefill."""
    _admit_core(params, cfg, cache, state, embed_tokens(params, input_ids, specs),
                _pad_bits(ints[1], input_ids.shape[1]), ints, temp, top_k, draws, specs)


@torch.no_grad()
def _prefill_prefix(params, cfg: UniGenConfig, ids: torch.Tensor,
                    quantize: bool, specs=None) -> qwen2.KVCache:
    """The shared prefix's K/V, once: a causal prefill (all-zero bits, the
    flash kernel) into a one-row cache."""
    llm_specs = C.sub(specs, "llm")
    tmp = qwen2.init_kv_cache(cfg.llm, 1, ids.shape[1], ids.device, quantize=quantize,
                              num_kv_heads=qwen2.local_kv_heads(params["llm"], cfg.llm,
                                                                llm_specs))
    _, tmp = qwen2.forward(params["llm"], cfg.llm, inputs_embeds=embed_tokens(params, ids, specs),
                           meta_bits=torch.zeros(ids.shape, dtype=torch.int32,
                                                 device=ids.device), cache=tmp, specs=llm_specs)
    return tmp


@torch.no_grad()
def _admit_ids_prefix(params, cfg: UniGenConfig, cache: qwen2.KVCache, state: SlotState,
                      prefix: qwen2.KVCache, input_ids: torch.Tensor, ints: torch.Tensor,
                      temp: torch.Tensor, top_k: Optional[int], draws: Sequence[Draw],
                      specs=None) -> None:
    """Batched admission after a shared prefix (``_prefill_suffixes``); the
    combined blocks go into the slot rows, each row's index after its prompt."""
    tmp, hidden = _prefill_suffixes(params, cfg, prefix, input_ids, cache.quantized, specs)
    first = _first_tokens(params, cfg, hidden, ints[1], temp, top_k, draws, specs)
    _install(cache, state, tmp, prefix.k.shape[2] + ints[1], first, ints, temp)


# ---------------------------------------------------------------------------
# Tensor parallelism: rank 0's plan
# ---------------------------------------------------------------------------

# header words: flags, steps (0: no chunk), cancels, groups, payload words,
# active-row words (slots when a chunk is dispatched, else 0)
_PLAN_HEADER = 6
_PLAN_STOP, _PLAN_ABORT = 1, 2
# a group's words: embeddings?, K, L, D, dtype code; then K requests of
# rid, slot, prompt_len, max_new_tokens, eot (-1 none), seed, start,
# temperature (float32 bits), lookup ids?; then K x L ids (text) or meta bits
# and K x L lookup ids (embeddings)
_GROUP_WORDS, _REQ_WORDS = 5, 9
_EMB_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
# an idle leader broadcasts an empty plan this often, inside any collective timeout
_KEEPALIVE_S = 30.0


class _Plan(NamedTuple):
    flags: int
    steps: Optional[int]
    cancels: List[int]                               # request ids
    groups: List[Tuple[List["_Request"], List[int]]]
    active: Optional[np.ndarray]                     # [slots] bool at the chunk's dispatch


def _encode_plan(plan: _Plan) -> Tuple[List[int], List[int], List[torch.Tensor]]:
    """(header, payload words, embeddings a group) of a plan."""
    words = list(plan.cancels)
    active = [] if plan.active is None else plan.active.astype(np.int64).tolist()
    words += active
    embs = []
    for group, slots in plan.groups:
        emb = group[0].input_ids is None
        first = group[0].inputs_embeds if emb else group[0].input_ids
        l = first.shape[1]
        words += [int(emb), len(group), l, first.shape[2] if emb else 0,
                  _EMB_DTYPES.index(first.dtype) if emb else 0]
        for r, s in zip(group, slots):
            words += [r.rid, s, r.prompt_len, r.max_new_tokens,
                      -1 if r.eot_token is None else int(r.eot_token), r.seed, r.start,
                      int(np.float32(r.temperature).view(np.int32)),
                      int(r.lookup_ids is not None)]
        if emb:
            words += torch.cat([r.meta_bits for r in group]).reshape(-1).tolist()
            words += np.concatenate([np.zeros((1, l), np.int64) if r.lookup_ids is None
                                     else r.lookup_ids for r in group]).reshape(-1).tolist()
            embs.append(torch.cat([r.inputs_embeds for r in group]).contiguous())
        else:
            words += np.concatenate([r.input_ids for r in group]).reshape(-1).tolist()
    header = [plan.flags, plan.steps or 0, len(plan.cancels), len(plan.groups), len(words),
              len(active)]
    return header, words, embs


def _send_plan(plan: _Plan) -> None:
    header, words, embs = _encode_plan(plan)
    MH.broadcast_tensor(torch.tensor(header, dtype=torch.int64), (_PLAN_HEADER,), torch.int64)
    if words:
        MH.broadcast_tensor(torch.tensor(words, dtype=torch.int64), (len(words),), torch.int64)
    for e in embs:
        b = e.view(torch.uint8)
        MH.broadcast_tensor(b, b.shape, torch.uint8)


def _recv_plan(device: torch.device) -> _Plan:
    """Rank 0's plan on a follower: its requests rebuilt, each with a fresh
    future; embeddings and meta bits on ``device``."""
    flags, steps, n_cancel, n_groups, n_words, n_active = MH.broadcast_tensor(
        None, (_PLAN_HEADER,), torch.int64).tolist()
    words = (MH.broadcast_tensor(None, (n_words,), torch.int64).tolist() if n_words else [])
    at = 0

    def take(n: int) -> List[int]:
        nonlocal at
        at += n
        return words[at - n:at]
    cancels = take(n_cancel)
    active = np.asarray(take(n_active), bool) if n_active else None
    groups = []
    for _ in range(n_groups):
        emb, k, l, d, code = take(_GROUP_WORDS)
        rows = [take(_REQ_WORDS) for _ in range(k)]
        reqs, slots = [], []
        for rid, slot, plen, max_new, eot, seed, start, temp, _ in rows:
            reqs.append(_Request(
                rid=rid, future=GenerationResult(rid), prompt_len=plen, max_new_tokens=max_new,
                temperature=float(np.int32(temp).view(np.float32)),
                eot_token=None if eot < 0 else eot, seed=seed, start=start))
            slots.append(slot)
        if emb:
            bits = torch.tensor(take(k * l), dtype=torch.int32).reshape(k, l).to(device)
            lookup = np.asarray(take(k * l), np.int64).reshape(k, l)
            dtype = _EMB_DTYPES[code]
            nbytes = d * torch.empty((), dtype=dtype).element_size()
            e = MH.broadcast_tensor(None, (k, l, nbytes), torch.uint8).view(dtype).to(device)
            for i, (r, row) in enumerate(zip(reqs, rows)):
                r.inputs_embeds, r.meta_bits = e[i:i + 1], bits[i:i + 1]
                r.lookup_ids = lookup[i:i + 1] if row[-1] else None
        else:
            ids = np.asarray(take(k * l), np.int64).reshape(k, l)
            for i, r in enumerate(reqs):
                r.input_ids = ids[i:i + 1]
        groups.append((reqs, slots))
    return _Plan(flags, steps or None, cancels, groups, active)


# ---------------------------------------------------------------------------
# Host scheduler
# ---------------------------------------------------------------------------

class GenerationResult:
    """Future for one request; ``result()`` blocks until the tokens are ready.

    ``stream()`` yields tokens as decode chunks are harvested (one burst a
    chunk), the HTTP front end's SSE path.
    """

    def __init__(self, rid: int):
        self.request_id = rid
        self._event = threading.Event()
        self._tokens: Optional[List[int]] = None
        self._error: Optional[BaseException] = None
        self._cancelled = False
        self._stream_q: "queue.Queue[Optional[int]]" = queue.Queue()
        # client-observed latency marks (perf_counter seconds): at submit, at
        # the harvest that delivers the first token, and at resolution
        self.submit_t: float = time.perf_counter()
        self.first_token_t: Optional[float] = None
        self.done_t: Optional[float] = None

    @property
    def ttft(self) -> Optional[float]:
        """Client-observed time to first token (seconds), once available."""
        if self.first_token_t is None:
            return None
        return self.first_token_t - self.submit_t

    @property
    def itl(self) -> Optional[float]:
        """Mean inter-token latency over the request (seconds a token)."""
        if self.done_t is None or self._tokens is None or len(self._tokens) < 2:
            return None
        return (self.done_t - self.first_token_t) / (len(self._tokens) - 1)

    def cancel(self) -> None:
        """Request cancellation (client disconnect): the scheduler frees the
        slot at the next harvest and the future fails with CancelledError. A
        finished request is unaffected."""
        self._cancelled = True

    def _push(self, token: int) -> None:
        if self.first_token_t is None:
            self.first_token_t = time.perf_counter()
        self._stream_q.put(token)

    def _resolve(self, tokens: List[int]) -> None:
        self._tokens = tokens
        self.done_t = time.perf_counter()
        self._event.set()
        self._stream_q.put(None)

    def _fail(self, err: BaseException) -> None:
        self._error = err
        self._event.set()
        self._stream_q.put(None)

    def stream(self, timeout: Optional[float] = None):
        """Yield token ids as they are generated, up to completion: the
        tokens of ``result()``, incrementally. ``timeout`` bounds the wait
        for each burst and raises TimeoutError, as ``result()`` does."""
        while True:
            try:
                tok = self._stream_q.get(timeout=timeout)
            except queue.Empty:
                raise TimeoutError(
                    f"request {self.request_id} produced no token for {timeout}s") from None
            if tok is None:
                if self._error is not None:
                    raise self._error
                return
            yield tok

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None) -> List[int]:
        if not self._event.wait(timeout):
            raise TimeoutError(f"request {self.request_id} not done after {timeout}s")
        if self._error is not None:
            raise self._error
        return list(self._tokens)


@dataclasses.dataclass
class _Request:
    rid: int
    future: Optional[GenerationResult]
    prompt_len: int
    max_new_tokens: int
    temperature: float
    eot_token: Optional[int]
    seed: int = 0
    input_ids: Optional[np.ndarray] = None            # [1, L_bucket] (text path)
    inputs_embeds: Optional[torch.Tensor] = None      # [1, L, D] (embeddings path)
    meta_bits: Optional[torch.Tensor] = None          # [1, L] int32
    lookup_ids: Optional[np.ndarray] = None           # [1, L] known ids (speculation)
    tokens: List[int] = dataclasses.field(default_factory=list)
    start: int = 0        # cache slots before the first decoded token (prefix + prompt)
    dispatched: int = 0   # decode steps dispatched since admission


@dataclasses.dataclass
class EngineStats:
    """Occupancy accounting: slot_steps counts every (slot, decode step)
    cell, busy_steps the occupied ones; busy / total is continuous
    batching's gain over static batching on the same trace. The t_* fields
    split the scheduler loop's wall (seconds): dispatch queues device work,
    harvest waits for a chunk's tokens, admit builds and queues prefills,
    plan broadcasts (rank 0) or receives (a follower) the plan under tensor
    parallelism."""
    requests_completed: int = 0
    tokens_generated: int = 0
    decode_chunks: int = 0
    slot_steps: int = 0
    busy_steps: int = 0
    t_dispatch: float = 0.0
    t_harvest: float = 0.0
    t_admit: float = 0.0
    t_drain: float = 0.0
    t_plan: float = 0.0

    @property
    def occupancy(self) -> float:
        return self.busy_steps / max(self.slot_steps, 1)


class ServingEngine:
    """Continuous-batching text / VQA decode server over a UniGen tree.

    Usage::

        eng = ServingEngine(params, cfg, slots=8, max_len=1024)
        fut = eng.submit(prompt_ids, max_new_tokens=128, eot_token=im_end)
        tokens = fut.result()
        eng.close()

    ``submit_embeds`` takes a spliced prompt and its meta bits
    (``pipeline.vqa_serving_inputs``). ``params`` must lie on ``device``
    (``cuda`` unless the caller passes ``"cpu"``). ``decode_params`` (e.g.
    the W4A8 tree) runs the decode chunks while ``params`` (e.g. W8A8) runs
    admission. ``speculate_k > 0`` turns on prompt-lookup speculative
    decoding (module docstring); the mean tokens a busy step accepts is
    ``stats.tokens_generated / stats.busy_steps``. One scheduler thread owns
    the device; submissions come from any thread. Sharded ``params`` come
    with their ``sharding`` (``parallel.shard_params``' record), and a
    sharded ``decode_params`` with its ``decode_sharding``; every process
    of the mesh builds the engine with the same arguments, process 0 serves
    and the others follow its plan (module docstring). A
    follower's ``followed`` holds the requests in flight; with
    ``keep_followed`` it keeps the finished ones too (a comparison of the
    ranks' tokens reads them after ``close``).
    """

    def __init__(self, params, cfg: UniGenConfig, *, slots: int = 8,
                 max_len: int = 1024, buckets: Sequence[int] = (64, 128, 256, 512),
                 chunk: Union[int, Sequence[int]] = 8,
                 top_k: Optional[int] = None,
                 quantized_cache: bool = False, pad_id: int = 0, seed: int = 0,
                 speculate_k: int = 0,
                 prefix_ids: Optional[Sequence[int]] = None,
                 decode_params=None, admit_cap: Optional[int] = None,
                 precompile: Sequence[Tuple] = (), device: DeviceLike = None,
                 keep_followed: bool = False, sharding=None, decode_sharding=None):
        if speculate_k < 0:
            raise ValueError(f"speculate_k must be >= 0, got {speculate_k}")
        if max(buckets) > max_len:
            raise ValueError(f"bucket {max(buckets)} exceeds max_len {max_len}")
        self.device = resolve_device(device)
        # tensor parallelism: rank 0 decides, the other ranks follow its plan
        self._distributed = sharding is not None
        if self._distributed:
            if current_mesh() is None:
                raise ValueError("sharded params need their mesh current (parallel.make_mesh)")
            if decode_params is not None and decode_sharding is None:
                raise ValueError("decode_params must be sharded on the mesh of the sharded "
                                 "params (parallel.shard_params), with its decode_sharding")
        elif decode_sharding is not None:
            raise ValueError("decode_sharding without a sharding: shard params on the same mesh")
        self._follower = self._distributed and MH.process_index() != 0
        self.followed: Dict[int, GenerationResult] = {}   # a follower's, by rank 0's request id
        self._keep_followed = keep_followed
        self._cancelled_rids: List[int] = []
        for name, tree in (("params", params), ("decode_params", decode_params)):
            if tree is not None and tree["llm"]["embed"].device.type != self.device.type:
                raise ValueError(f"{name} lie on {tree['llm']['embed'].device}, the engine "
                                 f"runs on {self.device}")
        self.params = params
        self.decode_params = params if decode_params is None else decode_params
        # the spec trees the device functions take beside each tree
        self._specs = None if sharding is None else sharding.tree(params)
        self._decode_specs = (self._specs if decode_params is None else
                              None if decode_sharding is None else
                              decode_sharding.tree(decode_params))
        self.cfg = cfg
        self.slots = slots
        self.max_len = max_len
        self.buckets = tuple(sorted(buckets))
        # decode-chunk lengths: one int pins every chunk; a sequence lets the
        # scheduler pick the longest that no active row provably outlives
        # (rows stop themselves on the device, so a long chunk never overshoots)
        self.chunks = tuple(sorted({int(c) for c in (
            (chunk,) if isinstance(chunk, int) else tuple(chunk))}))
        if self.chunks[0] < 1:
            raise ValueError(f"chunk lengths must be >= 1, got {self.chunks}")
        self.chunk = self.chunks[0]
        self.top_k = top_k
        self.pad_id = pad_id
        self.speculate_k = speculate_k
        self.stats = EngineStats()

        # shared prefix (system prompt, few-shot header): its K/V once, then
        # each admission copies the block and prefills only its suffix
        self._prefix = None
        self._prefix_ids: Optional[np.ndarray] = None
        self.prefix_len = 0
        if prefix_ids is not None:
            pids = np.asarray(prefix_ids, np.int64).reshape(1, -1)
            if pids.shape[1] == 0:
                raise ValueError("prefix_ids must contain at least one token")
            self._prefix = _prefill_prefix(params, cfg, to_device(pids, self.device),
                                           quantized_cache, self._specs)
            self._prefix_ids = pids
            self.prefix_len = pids.shape[1]

        self._cache = qwen2.init_kv_cache(
            cfg.llm, slots, max_len, self.device, quantize=quantized_cache, per_row_index=True,
            num_kv_heads=qwen2.local_kv_heads(params["llm"], cfg.llm, C.sub(self._specs, "llm")))
        if speculate_k > 0:
            # each slot's token history for the draft, and where it starts
            self._ctx = torch.zeros((slots, max_len), dtype=torch.int64, device=self.device)
            self._ctx_start = torch.zeros((slots,), dtype=torch.int64, device=self.device)
        self._state = init_slot_state(slots, self.device)
        self._seed = seed
        # the host's conservative view of the rows: set at admission, cleared
        # when a harvest resolves or cancels the occupant
        self._active = np.zeros((slots,), bool)
        self._slot_req: List[Optional[_Request]] = [None] * slots
        # steps and slot set of the dispatched, unharvested chunk (at most
        # one): makes the remaining-budget estimate of _pick_steps an upper bound
        self._unharvested: Optional[Tuple[int, frozenset]] = None
        self._admit_cap = max(1, min(slots, 16 if admit_cap is None else admit_cap))
        self._rid = itertools.count()
        self._queue: "queue.Queue[Optional[_Request]]" = queue.Queue()
        self._pending: List[_Request] = []
        self._closing = False
        # the warm-up runs on the scheduler thread, before it serves; its
        # error surfaces here
        self._ready = threading.Event()
        self._warmup_error: Optional[BaseException] = None
        self._thread = threading.Thread(
            target=self._follow if self._follower else self._loop, args=(tuple(precompile),),
            daemon=True, name="unigen-serving-follower" if self._follower else "unigen-serving")
        self._thread.start()
        self._ready.wait()
        if self._warmup_error is not None:
            self._thread.join()
            raise self._warmup_error

    def _precompile(self, sigs: Sequence[Tuple]) -> None:
        """Warm-up before serving: every admission signature at group sizes
        1, 2, 4, .. up to the cap, and every chunk length, dispatched as
        no-ops. Eager PyTorch compiles nothing; these build the CUDA kernels
        and cuBLAS's handles and plans before the first request. The
        admissions prefill and sample but install into no slot; the chunks
        (speculative ones with ``speculate_k``) run over the fresh,
        all-inactive rows, which advance no index and write only cache slots
        and context entries that a later admission rewrites or that lie at or
        above a row's index. So no result changes.

        ``sigs``: ``("ids", bucket_len)`` and ``("emb", bucket_len,
        embed_dim)``. Memoized per process: a second engine with the same
        signatures skips them. The key is added only after the dispatches
        succeeded, under the memo's lock."""
        if not sigs:
            return
        leaves = []
        for tree in (self.params, self.decode_params):
            stack = [tree]
            while stack:
                node = stack.pop()
                if isinstance(node, dict):
                    stack.extend(node[k] for k in sorted(node))
                elif isinstance(node, (list, tuple)):
                    stack.extend(node)
                elif isinstance(node, torch.Tensor):
                    leaves.append((tuple(node.shape), str(node.dtype)))
        key = (self.cfg, str(self.device), self.slots, self.max_len, self.chunks, self.top_k,
               self.speculate_k, self._cache.quantized, self.prefix_len,
               tuple(tuple(s) for s in sigs), self._admit_cap, tuple(leaves))
        with _PRECOMPILED_LOCK:
            if key in _PRECOMPILED_KEYS:
                return
        sizes, k = [], 1
        while True:
            sizes.append(k)
            if k >= self._admit_cap:
                break
            k *= 2
        dev = self.device
        emb_dt = embed_tokens(self.params, torch.zeros((1, 1), dtype=torch.int64, device=dev),
                              self._specs).dtype
        specs = self._specs
        q = self._cache.quantized
        with torch.no_grad():
            for sig in sigs:
                ln = int(sig[1])
                for kp in sizes:
                    plen = torch.full((kp,), ln, dtype=torch.int64, device=dev)
                    if sig[0] == "ids":
                        ids = torch.zeros((kp, ln), dtype=torch.int64, device=dev)
                        if self._prefix is not None:
                            _, hidden = _prefill_suffixes(self.params, self.cfg, self._prefix,
                                                          ids, q, specs)
                        else:
                            _, hidden = _prefill(self.params, self.cfg,
                                                 embed_tokens(self.params, ids, specs),
                                                 _pad_bits(plen, ln), plen, q, specs)
                    elif sig[0] == "emb":
                        emb = torch.zeros((kp, ln, int(sig[2])), dtype=emb_dt, device=dev)
                        _, hidden = _prefill(self.params, self.cfg, emb, _pad_bits(plen, ln),
                                             plen, q, specs)
                    else:
                        raise ValueError(f"unknown precompile signature {sig!r}")
                    _first_tokens(self.params, self.cfg, hidden, plen,
                                  torch.zeros((kp,), device=dev), self.top_k, (), specs)
            for steps in self.chunks:
                self._cache, self._state = self._run_chunk(steps, ())[:2]
        with _PRECOMPILED_LOCK:
            _PRECOMPILED_KEYS.add(key)

    # -- submission ----------------------------------------------------------

    def _bucket(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        raise ValueError(f"prompt length {n} exceeds largest bucket {self.buckets[-1]}")

    @property
    def healthy(self) -> bool:
        """True while the scheduler thread is serving (liveness probes)."""
        return self._thread.is_alive() and not self._closing

    def _request_seed(self, rid: int, seed: Optional[int]) -> int:
        """Per-request sampling seed: the caller's, or derived from the
        engine seed and the request id. A sampled stream depends only on
        this seed and the prompt, never on batching or scheduling."""
        if seed is not None:
            return int(seed) & 0x7FFFFFFF
        return (self._seed * 1000003 + rid * 2654435761 + 1) & 0x7FFFFFFF

    def submit(self, input_ids: Sequence[int], *, max_new_tokens: int = 128,
               temperature: float = 0.0, eot_token: Optional[int] = None,
               seed: Optional[int] = None) -> GenerationResult:
        """Queue a text prompt; returns a future resolving to generated token ids."""
        self._check_leader()
        ids = np.asarray(input_ids, np.int64).reshape(-1)
        if len(ids) == 0:  # prompt_len 0 would mask every key
            raise ValueError("prompt must contain at least one token")
        l = self._bucket(len(ids))
        self._check_fit(self.prefix_len + l, max_new_tokens)
        padded = np.full((1, l), self.pad_id, np.int64)
        padded[0, :len(ids)] = ids
        rid = next(self._rid)
        return self._enqueue(_Request(
            rid=rid, future=None, prompt_len=len(ids),
            max_new_tokens=max_new_tokens, temperature=temperature,
            eot_token=eot_token, seed=self._request_seed(rid, seed),
            input_ids=padded, start=self.prefix_len + len(ids)))

    def submit_embeds(self, inputs_embeds: torch.Tensor, meta_bits: torch.Tensor,
                      prompt_len: int, *, max_new_tokens: int = 128,
                      temperature: float = 0.0, eot_token: Optional[int] = None,
                      lookup_ids: Optional[Sequence[int]] = None,
                      seed: Optional[int] = None) -> GenerationResult:
        """Queue a continuous-embedding prompt (the understanding path).

        ``inputs_embeds`` [1, L, D], L one of the buckets, and ``meta_bits``
        [1, L] int32 (``ops.masks.pack_meta``; every slot at or beyond
        ``prompt_len`` pad), as ``pipeline.vqa_serving_inputs`` returns them.
        Tensors on the engine's device pass through untouched, so the
        submitter never waits for the vision tower. ``lookup_ids`` (read only
        with speculation): the request's known ids at their splice positions,
        zeros over the image (``pipeline.vqa_lookup_ids``), to
        seed the draft; without them an embeddings request drafts from its
        generated tokens only."""
        self._check_leader()
        if self._prefix is not None:
            raise ValueError("submit_embeds does not compose with a shared prefix (the "
                             "meta bits cover the full splice); run an engine without "
                             "prefix_ids")
        l = inputs_embeds.shape[1]
        if l not in self.buckets:
            raise ValueError(f"embeddings length {l} must be one of {self.buckets}")
        if prompt_len < 1:
            raise ValueError("prompt_len must be >= 1")
        if tuple(meta_bits.shape) != (1, l):
            raise ValueError(f"meta_bits must be [1, {l}], got {tuple(meta_bits.shape)}")
        self._check_fit(l, max_new_tokens)
        lk = None
        if lookup_ids is not None and self.speculate_k > 0:
            lk = np.zeros((1, l), np.int64)
            ids = np.asarray(lookup_ids, np.int64).reshape(-1)[:l]
            lk[0, :len(ids)] = ids
        emb = inputs_embeds if isinstance(inputs_embeds, torch.Tensor) else \
            to_device(inputs_embeds, self.device)
        bits = meta_bits if isinstance(meta_bits, torch.Tensor) else \
            to_device(meta_bits, self.device, torch.int32)
        rid = next(self._rid)
        return self._enqueue(_Request(
            rid=rid, future=None, prompt_len=int(prompt_len),
            max_new_tokens=max_new_tokens, temperature=temperature,
            eot_token=eot_token, seed=self._request_seed(rid, seed),
            inputs_embeds=emb.to(self.device), meta_bits=bits.to(self.device),
            lookup_ids=lk, start=int(prompt_len)))

    def _check_leader(self) -> None:
        if self._follower:
            raise RuntimeError(
                f"rank {MH.process_index()} follows rank 0's plan under tensor parallelism: "
                "submit on rank 0")

    def _check_fit(self, bucket_len: int, max_new: int) -> None:
        if max_new < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {max_new}")
        # speculation writes up to k draft positions past the last accepted
        # token: the headroom keeps every budgeted write inside the cache. A
        # frozen row keeps writing at and above its index, which may reach
        # max_len: those writes are dropped (qwen2._cache_write) and never read
        if bucket_len + max_new + self.speculate_k > self.max_len:
            raise ValueError(
                f"bucket {bucket_len} + max_new_tokens {max_new} (+ speculate_k "
                f"{self.speculate_k}) exceeds the engine max_len {self.max_len}")

    def _enqueue(self, req: _Request) -> GenerationResult:
        if self._closing:
            raise RuntimeError("engine is closed")
        req.future = GenerationResult(req.rid)
        self._queue.put(req)
        # the scheduler may have died between the check and the put; a dead
        # thread never drains this item, so fail it here (idempotent with the
        # death handler's own drain)
        if self._closing and not self._thread.is_alive():
            req.future._fail(RuntimeError("engine is closed"))
        return req.future

    # -- scheduler loop -------------------------------------------------------

    def _warm_up(self, precompile: Tuple) -> bool:
        try:
            self._precompile(precompile)
        except BaseException as e:
            self._closing = True
            self._warmup_error = e
            self._ready.set()
            return False
        self._ready.set()
        return True

    def _loop(self, precompile: Tuple) -> None:
        if not self._warm_up(precompile):
            return
        # One-deep pipeline: chunk i + 1 is queued before chunk i's tokens
        # are waited for, so the host's harvest overlaps the device's work.
        # Tokens are unchanged: sampling is keyed by (seed, position), a slot
        # freed at harvest i decodes one junk chunk that the snapshot guard
        # discards, and admission lands before the next dispatch. Under
        # tensor parallelism the iteration's decisions are broadcast before
        # any of its device work (``_follow`` runs them on the other ranks).
        inflight = None   # (slot_req snapshot at dispatch, fetched toks) or None
        try:
            while True:
                idle = (inflight is None and not self._active.any() and not self._pending)
                if idle and self._closing:
                    break
                t0 = time.perf_counter()
                self._drain_queue(block=idle)
                t1 = time.perf_counter()
                if (inflight is None and self._closing and not self._pending
                        and not self._active.any()):
                    break
                groups = self._admit_pending()
                steps = self._pick_steps() if self._active.any() else None
                t2 = time.perf_counter()
                if self._distributed:
                    _send_plan(_Plan(0, steps, self._cancelled_rids, groups,
                                     None if steps is None else self._active.copy()))
                    self._cancelled_rids = []
                t3 = time.perf_counter()
                for group, slots in groups:
                    self._admit_group(group, slots)
                t4 = time.perf_counter()
                nxt = None if steps is None else self._dispatch_chunk(steps)
                t5 = time.perf_counter()
                if inflight is not None:
                    self._harvest(*inflight)
                t6 = time.perf_counter()
                self.stats.t_drain += t1 - t0
                self.stats.t_admit += (t2 - t1) + (t4 - t3)
                self.stats.t_plan += t3 - t2
                self.stats.t_dispatch += t5 - t4
                self.stats.t_harvest += t6 - t5
                inflight = nxt
            if self._distributed:   # the followers' last harvest, then they stop
                _send_plan(_Plan(_PLAN_STOP, None, self._cancelled_rids, [], None))
        except BaseException as e:  # resolve every future so callers unblock
            self._closing = True     # reject new submissions: no thread serves them
            undrained = []
            try:
                while True:
                    item = self._queue.get(block=False)
                    if item is not None:
                        undrained.append(item)
            except queue.Empty:
                pass
            for req in self._pending + undrained + [r for r in self._slot_req if r]:
                req.future._fail(e)
            if self._distributed:   # best effort: the followers stop and fail theirs
                with contextlib.suppress(Exception):
                    _send_plan(_Plan(_PLAN_ABORT, None, [], [], None))
            raise

    def _follow(self, precompile: Tuple) -> None:
        """A follower rank's loop: each of rank 0's plans in turn, through the
        same admission, chunk and harvest code. Rank 0 harvests chunk i - 1
        after it dispatches chunk i and sends that harvest's cancels with
        plan i + 1, so a follower harvests a chunk two plans after it
        dispatched it, with those cancels: the device work (admissions,
        chunks, the cancelled rows' deactivation) runs in rank 0's order."""
        if not self._warm_up(precompile):
            return
        dispatched = collections.deque()     # the last two plans' chunks (or None)
        try:
            while True:
                t0 = time.perf_counter()
                plan = _recv_plan(self.device)
                t1 = time.perf_counter()
                for rid in plan.cancels:
                    self.followed[rid].cancel()
                if len(dispatched) == 2:
                    done = dispatched.popleft()
                    if done is not None:
                        self._harvest(*done)
                        if not self._keep_followed:   # hold only the requests in flight
                            for rid in [r for r, f in self.followed.items() if f.done()]:
                                del self.followed[rid]
                if plan.flags & _PLAN_ABORT:
                    raise RuntimeError("rank 0's serving engine stopped on an error")
                if plan.flags & _PLAN_STOP:
                    if any(d is not None for d in dispatched):
                        raise RuntimeError("rank 0 stopped with a chunk this rank did not harvest")
                    return
                t2 = time.perf_counter()
                for group, slots in plan.groups:
                    if self._active[slots].any():
                        raise RuntimeError(f"rank 0 admits into slots {slots}, which this rank "
                                           "holds occupied: the ranks diverged")
                    self._occupy(group, slots)
                    for req in group:
                        self.followed[req.rid] = req.future
                    self._admit_group(group, slots)
                t3 = time.perf_counter()
                nxt = None
                if plan.steps is not None:
                    if not np.array_equal(self._active, plan.active):
                        raise RuntimeError(
                            f"active rows {np.flatnonzero(self._active).tolist()} differ from "
                            f"rank 0's {np.flatnonzero(plan.active).tolist()}: the ranks diverged")
                    nxt = self._dispatch_chunk(plan.steps)
                dispatched.append(nxt)
                t4 = time.perf_counter()
                self.stats.t_plan += t1 - t0
                self.stats.t_harvest += t2 - t1
                self.stats.t_admit += t3 - t2
                self.stats.t_dispatch += t4 - t3
        except BaseException as e:
            self._closing = True
            for fut in self.followed.values():
                if not fut.done():
                    fut._fail(e)
            raise

    def _drain_queue(self, block: bool) -> None:
        try:
            # an idle leader wakes up to send an empty plan, so the followers'
            # broadcast never waits past a collective timeout
            item = self._queue.get(block=block,
                                   timeout=_KEEPALIVE_S if self._distributed else None)
        except queue.Empty:
            return
        while True:
            if item is None:
                self._closing = True
            else:
                self._pending.append(item)
            try:
                item = self._queue.get(block=False)
            except queue.Empty:
                return

    def _admit_sig(self, req: _Request):
        """Requests of one signature share one prefill dispatch."""
        if req.input_ids is not None:
            return ("ids", req.input_ids.shape[1])
        return ("emb", req.inputs_embeds.shape[1], req.inputs_embeds.shape[2])

    def _admit_pending(self) -> List[Tuple[List[_Request], List[int]]]:
        """The groups to admit and their slots, taken from the pending
        requests and marked occupied on the host; ``_admit_group`` runs
        each on the device."""
        groups = []
        free = [i for i in range(self.slots) if not self._active[i]]
        while free and self._pending:
            head = self._pending.pop(0)
            if head.future._cancelled:  # cancelled before admission: no device work
                head.future._fail(CancelledError(f"request {head.rid} cancelled"))
                continue
            # batched admission: the longest FIFO run of pending requests of
            # the head's signature, up to the free slots and the group cap
            sig = self._admit_sig(head)
            group, slots_used = [head], [free.pop(0)]
            while (free and self._pending
                   and len(group) < self._admit_cap
                   and not self._pending[0].future._cancelled
                   and self._admit_sig(self._pending[0]) == sig):
                group.append(self._pending.pop(0))
                slots_used.append(free.pop(0))
            self._occupy(group, slots_used)
            groups.append((group, slots_used))
        return groups

    def _occupy(self, group: List[_Request], slots_used: List[int]) -> None:
        for slot, req in zip(slots_used, group):
            # no fetch at admission: the first token comes out with the next chunk
            self._slot_req[slot] = req
            self._active[slot] = True
            req.dispatched = 0

    def _admit_group(self, group: List[_Request], slots_used: List[int]) -> None:
        dev = self.device
        ints = to_device(np.asarray(
            [slots_used, [r.prompt_len for r in group], [r.max_new_tokens for r in group],
             [-1 if r.eot_token is None else r.eot_token for r in group]], np.int64), dev)
        temp = to_device(np.asarray([r.temperature for r in group], np.float32), dev)
        # the first token of row i is drawn at its position start (JAX's
        # _row_keys(seed, prompt_len), after the prefix if any)
        draws = [(i, r.seed, r.start) for i, r in enumerate(group) if r.temperature > 0]
        if group[0].input_ids is not None:
            ids = to_device(np.concatenate([r.input_ids for r in group], axis=0), dev)
            if self._prefix is not None:
                _admit_ids_prefix(self.params, self.cfg, self._cache, self._state,
                                  self._prefix, ids, ints, temp, self.top_k, draws, self._specs)
            else:
                _admit_ids(self.params, self.cfg, self._cache, self._state, ids, ints, temp,
                           self.top_k, draws, self._specs)
        else:
            # embeddings (VQA: the splice and its mmu_vit bits) stay on the
            # device: concatenated there
            emb = torch.cat([r.inputs_embeds for r in group], dim=0)
            bits = torch.cat([r.meta_bits for r in group], dim=0)
            _admit_core(self.params, self.cfg, self._cache, self._state, emb, bits, ints,
                        temp, self.top_k, draws, self._specs)
        if self.speculate_k > 0:
            rows, starts = [], []
            for req in group:
                if req.input_ids is not None:
                    row, start = req.input_ids, 0
                    if self._prefix_ids is not None:
                        row = np.concatenate([self._prefix_ids, row], axis=1)
                elif req.lookup_ids is not None:
                    row, start = req.lookup_ids, 0
                else:   # no ids known: draft from the generated region only
                    row, start = np.zeros((1, req.inputs_embeds.shape[1]), np.int64), \
                        req.prompt_len
                rows.append(row)
                starts.append(start)
            _ctx_install(self._ctx, self._ctx_start, ints[0],
                         to_device(np.concatenate(rows, axis=0), dev),
                         to_device(np.asarray(starts, np.int64), dev))

    def _pick_steps(self) -> Optional[int]:
        """The next chunk length from ``self.chunks``.

        Per active slot, ``budget - len(tokens) - unharvested steps`` bounds
        the tokens it still needs from above (one emission an active step;
        eot only stops earlier). If no bound is positive, every occupant
        finishes inside the in-flight chunk: skip. Otherwise run the longest
        chunk that no soon-finishing row outlives: with requests waiting,
        the earliest finish (frees its slot at the first harvest that can);
        with none, the latest (fewest syncs)."""
        pend_steps, pend_slots = self._unharvested or (0, frozenset())
        rem = []
        for slot in range(self.slots):
            req = self._slot_req[slot]
            if req is None or not self._active[slot]:
                continue
            rem.append(req.max_new_tokens - len(req.tokens)
                       - (pend_steps if slot in pend_slots else 0))
        positive = [r for r in rem if r > 0]
        if not positive:
            return None
        target = min(positive) if self._pending else max(positive)
        return max(c for c in self.chunks if c <= max(target, self.chunks[0]))

    def _run_chunk(self, steps: int, draws: Sequence[Draw]):
        """One decode chunk, plain or speculative: (cache, state, tokens) with
        tokens [B, steps], or [B, steps, k + 2] whose last entry is each
        step's accepted count (one tensor, so one fetch a chunk)."""
        if self.speculate_k > 0:
            cache, state, toks, counts = _spec_decode_chunk(
                self.decode_params, self.cfg, self._cache, self._state, self._ctx,
                self._ctx_start, steps, self.speculate_k, self.top_k, draws, self._decode_specs)
            return cache, state, torch.cat([toks, counts[..., None].to(toks.dtype)], dim=-1)
        return _decode_chunk(self.decode_params, self.cfg, self._cache, self._state, steps,
                             self.top_k, draws, self._decode_specs)

    def _dispatch_chunk(self, steps: int):
        """Queue one decode chunk of ``steps`` (``_pick_steps``) and the copy
        of its tokens to the host; returns (slot_req snapshot, fetched
        tokens) for a later ``_harvest``."""
        # a sampling row's token at decode step s of its occupancy is drawn at
        # position start + s + 1 (it accepts one token a step, speculating or
        # not); an inactive row draws nothing
        draws = []
        for slot in range(self.slots):
            req = self._slot_req[slot]
            if req is not None and self._active[slot]:
                if req.temperature > 0:
                    draws.append((slot, req.seed, req.start + req.dispatched + 1))
                req.dispatched += steps
        self._cache, self._state, toks = self._run_chunk(steps, draws)
        self.stats.decode_chunks += 1
        self.stats.slot_steps += self.slots * steps
        self.stats.busy_steps += int(self._active.sum()) * steps
        self._unharvested = (steps, frozenset(
            s for s in range(self.slots) if self._active[s]))
        return list(self._slot_req), fetch_async(toks)

    def _harvest(self, snapshot, fetched) -> None:
        """Take one chunk's tokens (the decode path's only wait on the
        device: its copy's event) and resolve what finished."""
        self._unharvested = None
        host, event = fetched
        if event is not None:
            event.synchronize()
        toks = host.numpy()
        if toks.ndim == 2:      # plain: one token a step
            toks, counts = toks[:, :, None], np.ones(toks.shape, np.int64)
        else:                   # speculative: the accepted count rides last
            toks, counts = toks[:, :, :-1], toks[:, :, -1]
        for slot in range(self.slots):
            req = snapshot[slot]
            # snapshot guard: tokens belong only to the request that held the
            # slot at dispatch; a slot freed by the previous harvest decodes
            # one junk chunk, and a newly admitted request's first tokens come
            # in the next chunk
            if req is None or req is not self._slot_req[slot]:
                continue
            if req.future._cancelled:  # free the slot, fail the future
                req.future._fail(CancelledError(f"request {req.rid} cancelled"))
                self._slot_req[slot] = None
                self._active[slot] = False
                # finished rows stop themselves on the device; a cancelled row
                # does not know it
                _state_deactivate(self._state, slot)
                if self._distributed and not self._follower:
                    self._cancelled_rids.append(req.rid)
                continue
            accepted = [int(t) for st in range(toks.shape[1])
                        for t in toks[slot, st, :counts[slot, st]]]
            for t in accepted:
                req.tokens.append(t)
                req.future._push(t)
                self.stats.tokens_generated += 1
                if (req.eot_token is not None and t == req.eot_token) or \
                        len(req.tokens) >= req.max_new_tokens:
                    break
            if self._finish_if_done(req):
                self._slot_req[slot] = None
                self._active[slot] = False

    def _finish_if_done(self, req: _Request) -> bool:
        done = len(req.tokens) >= req.max_new_tokens or (
            req.eot_token is not None and req.tokens and req.tokens[-1] == req.eot_token)
        if done:
            req.future._resolve(req.tokens[:req.max_new_tokens])
            self.stats.requests_completed += 1
        return done

    # -- lifecycle ------------------------------------------------------------

    def close(self, timeout: Optional[float] = 60.0) -> None:
        """Finish every queued and in-flight request, then stop the scheduler.
        On a follower rank: wait for rank 0's stop."""
        self._queue.put(None)
        self._thread.join(timeout)
        if self._thread.is_alive():
            return  # still draining a long backlog: do not steal its queue
        # fail any request that raced past the closed check after the
        # scheduler exited, so its caller unblocks
        try:
            while True:
                item = self._queue.get(block=False)
                if item is not None:
                    item.future._fail(RuntimeError("engine is closed"))
        except queue.Empty:
            pass

    def __enter__(self) -> "ServingEngine":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()

