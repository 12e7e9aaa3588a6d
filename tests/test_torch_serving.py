"""The port's continuous-batching engine, its per-row KV cache and its HTTP
front end against the JAX package (the oracle tests of tests/test_serving.py).

Tiny UniGen on the CPU in fp32, the JAX init (biases and norm scales
perturbed) carried across by ``weights.py``:

* the per-row cache index and the default masks of ``qwen2.forward``:
  hidden states and cache writes against JAX's ``forward`` with
  ``per_row_index=True`` and without a mask (2e-5, as tests/test_torch_qwen2.py),
  and the per-row path bit for bit against the port's scalar path;
* the engine, greedy, token for token against JAX's batch decoder
  (``generate_text``, or ``mmu_generate`` for the int8 cache and the
  embeddings path) and against JAX's ``ServingEngine`` on the same trace
  (bf16/fp32 trees, and the mixed W8A8 admission / W4A8 decode trees);
  ``vqa_serving_inputs`` through ``submit_embeds`` against JAX's
  ``understand``;
* the host side against the port itself: sampled streams do not depend on
  the schedule, cancellation, stream and result, latency marks, a decode
  chunk that reads nothing back to the host, the warm-up that changes no
  result;
* the HTTP routes as JAX's answer them, and ``/v1/images`` over the port's
  image engine.

Every wait has a timeout. The JAX references are computed once per prompt,
in one batch shape, so that JAX compiles once.
"""
import dataclasses
import json
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unigen_tpu.generation import decode as JD
from unigen_tpu.models import magvit as JMV
from unigen_tpu.models import qwen2 as JQ
from unigen_tpu.models import siglip as JS
from unigen_tpu.models import unigen as JU
from unigen_tpu.ops import int4 as J4
from unigen_tpu.ops import quantization as JQZ
from unigen_tpu.pipeline import UniGenPipeline as JPipeline
from unigen_tpu.prompting import UniPrompting as JPrompting
from unigen_tpu.serving import ServingEngine as JServingEngine
from unigen_tpu_torch import weights as W
from unigen_tpu_torch.evaluation.geneval import load_png
from unigen_tpu_torch.launch import build_pipeline
from unigen_tpu_torch.models import qwen2 as TQ
from unigen_tpu_torch.models import siglip as TS
from unigen_tpu_torch.models import unigen as TU
from unigen_tpu_torch.ops import masks as TM
from unigen_tpu_torch.ops.sampling import derived_generator
from unigen_tpu_torch.pipeline import UniGenPipeline as TPipeline
from unigen_tpu_torch.pipeline import pixels_to_uint8
from unigen_tpu_torch.prompting import UniPrompting as TPrompting
from unigen_tpu_torch.serving import (GenerationResult, ImageServingEngine, ServingEngine,
                                      ServingHTTPServer)
from unigen_tpu_torch.serving import engine as TE

from test_pipeline import DecodableMockTokenizer
from test_prompting import SPECIALS
from test_torch_qwen2 import _perturb

CPU = torch.device("cpu")
T = 120   # seconds: the bound of every wait


@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = JU.UniGenConfig.tiny(), TU.UniGenConfig.tiny()
    tree = _perturb(jax.tree.map(np.asarray, JU.init(jax.random.key(0), jcfg)),
                    np.random.default_rng(0))
    return jcfg, jax.tree.map(jnp.asarray, tree), tcfg, W.unigen_from_jax(tree, tcfg)


def _engine(model, **kw):
    return ServingEngine(model[3], model[2], device="cpu", **kw)


def _prompts(cfg, lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(3, cfg.text_vocab_len - 1, size=(n,)).tolist() for n in lens]


# JAX's references are computed once per prompt, as rows of one batch shape
_REF_ROWS, _REF_LEN, _REF_NEW = 16, 96, 24
_REFS = {}


def _expect(model, prompts, budgets, eot=None):
    """JAX's greedy batch decode (``generate_text``) of each prompt, cut to its
    budget and after its eot: rows of one [16, 96] batch of 24 new tokens
    without an eot, so that JAX compiles once (greedy tokens before a stop
    do not depend on the stop)."""
    jcfg, jparams = model[0], model[1]
    todo = list(dict.fromkeys(tuple(p) for p in prompts if (id(jparams), tuple(p)) not in _REFS))
    for i in range(0, len(todo), _REF_ROWS):
        batch = todo[i:i + _REF_ROWS]
        arr = np.zeros((_REF_ROWS, _REF_LEN), np.int32)
        plen = np.ones((_REF_ROWS,), np.int32)
        for j, p in enumerate(batch):
            arr[j, :len(p)], plen[j] = p, len(p)
        out = np.asarray(JD.generate_text(jparams, jcfg, jax.random.key(1), jnp.asarray(arr),
                                          jnp.asarray(plen), max_new_tokens=_REF_NEW,
                                          temperature=0.0))
        for j, p in enumerate(batch):
            _REFS[(id(jparams), p)] = out[j].tolist()
    want = []
    for p, m in zip(prompts, budgets):
        assert m <= _REF_NEW
        toks = _REFS[(id(jparams), tuple(p))][:m]
        want.append(toks[:toks.index(eot) + 1] if eot in toks else toks)
    return want


# ---------------------------------------------------------------------------
# the per-row cache index and the default masks
# ---------------------------------------------------------------------------

def _emb(model, ids):
    jcfg, jparams, tcfg, tparams = model
    return (JU.embed_tokens(jparams, jnp.asarray(ids)),
            TU.embed_tokens(tparams, torch.from_numpy(np.asarray(ids))))


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("quantize", [False, True])
def test_per_row_cache_uniform_matches_scalar(model, quantize):
    """A [B] index with one value equals the int index bit for bit (cache,
    hidden states, greedy steps), and both equal JAX's per-row path."""
    jcfg, jparams, tcfg, tparams = model
    b, l0 = 3, 7
    ids = np.random.default_rng(3).integers(3, 100, size=(b, l0))
    jemb, temb = _emb(model, ids)
    pos = np.broadcast_to(np.arange(l0)[None], (b, l0))
    causal = np.broadcast_to((np.arange(l0)[:, None] >= np.arange(l0)[None, :])[None, None],
                             (b, 1, l0, l0))
    jmask = np.concatenate([causal, np.zeros((b, 1, l0, 4), bool)], -1)

    def run_port(per_row):
        cache = TQ.init_kv_cache(tcfg.llm, b, l0 + 4, CPU, quantize=quantize,
                                 per_row_index=per_row)
        h, cache = TQ.forward(tparams["llm"], tcfg.llm, inputs_embeds=temb,
                              positions=torch.from_numpy(pos.copy()),
                              mask=torch.from_numpy(jmask), cache=cache)
        outs, tok = [h[:, -1]], torch.argmax(h[:, -1] @ tparams["llm"]["embed"].T, -1)
        for _ in range(3):
            h, cache = TQ.forward(tparams["llm"], tcfg.llm,
                                  inputs_embeds=TU.embed_tokens(tparams, tok[:, None]),
                                  cache=cache)
            outs.append(h[:, 0])
            tok = torch.argmax(h[:, 0] @ tparams["llm"]["embed"].T, -1)
        return torch.stack(outs).numpy(), cache

    h_s, c_s = run_port(False)
    h_r, c_r = run_port(True)
    np.testing.assert_array_equal(h_s, h_r)
    np.testing.assert_array_equal(c_s.k.numpy(), c_r.k.numpy())
    if quantize:
        np.testing.assert_array_equal(c_s.k_scale.numpy(), c_r.k_scale.numpy())
    assert c_s.index == l0 + 3 and c_r.index.tolist() == [l0 + 3] * b
    assert c_r.index.dtype == torch.int32

    cache = JQ.init_kv_cache(jcfg.llm, b, l0 + 4, quantize=quantize, per_row_index=True)
    h, cache = JQ.forward(jparams["llm"], jcfg.llm, inputs_embeds=jemb, positions=jnp.asarray(pos),
                          mask=jnp.asarray(jmask), cache=cache)
    outs, tok = [h[:, -1]], jnp.argmax(h[:, -1] @ jparams["llm"]["embed"]["weight"].T, -1)
    for _ in range(3):
        h, cache = JQ.forward(jparams["llm"], jcfg.llm,
                              inputs_embeds=JU.embed_tokens(jparams, tok[:, None]), cache=cache)
        outs.append(h[:, 0])
        tok = jnp.argmax(h[:, 0] @ jparams["llm"]["embed"]["weight"].T, -1)
    _close(h_r, jnp.stack(outs))
    if quantize:   # int8 values may round to a neighbour where fp32 sums differ
        assert np.abs(c_r.k.numpy().astype(int) - np.asarray(cache.k).astype(int)).max() <= 1
    else:
        _close(c_r.k.numpy(), cache.k)


@pytest.mark.parametrize("quantize", [False, True])
def test_per_row_cache_staggered_positions(model, quantize):
    """Rows writing at different positions land in their own slots only: a
    one-token step at [0, 3, 7, 12] and a 3-token chunk at [2, 9, 13, 15] in
    a 16-slot cache (the last two rows run past it: those writes drop, as
    JAX's per-row select drops them), against JAX's per-row forward."""
    jcfg, jparams, tcfg, tparams = model
    b, s = 4, 16
    for l, start in ((1, [0, 3, 7, 12]), (3, [2, 9, 13, 15])):
        ids = np.random.default_rng(l).integers(3, 100, size=(b, l))
        jemb, temb = _emb(model, ids)
        tc = TQ.init_kv_cache(tcfg.llm, b, s, CPU, quantize=quantize, per_row_index=True)
        tc = tc._replace(index=torch.tensor(start, dtype=torch.int32))
        jc = JQ.init_kv_cache(jcfg.llm, b, s, quantize=quantize, per_row_index=True)
        jc = jc._replace(index=jnp.asarray(start, jnp.int32))
        th, tc2 = TQ.forward(tparams["llm"], tcfg.llm, inputs_embeds=temb, cache=tc)
        jh, jc2 = JQ.forward(jparams["llm"], jcfg.llm, inputs_embeds=jemb, cache=jc)
        assert tc2.index.tolist() == [i + l for i in start] == np.asarray(jc2.index).tolist()
        _close(th, jh)
        k2 = tc2.k.numpy()
        for row, idx in enumerate(start):
            written = [idx + j for j in range(l) if idx + j < s]
            assert np.abs(k2[:, row, written]).sum() > 0
            np.testing.assert_array_equal(np.delete(k2[:, row], written, axis=1), 0)
        if quantize:
            assert np.abs(k2.astype(int) - np.asarray(jc2.k).astype(int)).max() <= 1
            _close(tc2.k_scale.numpy(), jc2.k_scale)
        else:
            _close(k2, jc2.k)


@pytest.mark.parametrize("case", ["no cache", "int index, l=1", "int index, l=3",
                                  "row index, l=1", "row index, l=3"])
def test_default_masks_match_jax(model, case):
    """``forward`` without a mask builds JAX's defaults: causal without a
    cache; with one, key s visible to query j of row b when s <= index[b] + j
    (a cache already holding a prefilled prompt, rows at their own ages)."""
    jcfg, jparams, tcfg, tparams = model
    b, s, l0 = 3, 20, 6
    rng = np.random.default_rng(11)
    pre = rng.integers(3, 100, size=(b, l0))
    l = 3 if case.endswith("l=3") else (l0 if case == "no cache" else 1)
    ids = rng.integers(3, 100, size=(b, l))
    jemb, temb = _emb(model, ids)
    if case == "no cache":
        jh, _ = JQ.forward(jparams["llm"], jcfg.llm, inputs_embeds=jemb)
        th, _ = TQ.forward(tparams["llm"], tcfg.llm, inputs_embeds=temb)
        _close(th, jh)
        return
    per_row = case.startswith("row")
    jpre, tpre = _emb(model, pre)
    jc = JQ.init_kv_cache(jcfg.llm, b, s, per_row_index=per_row)
    tc = TQ.init_kv_cache(tcfg.llm, b, s, CPU, per_row_index=per_row)
    _, jc = JQ.forward(jparams["llm"], jcfg.llm, inputs_embeds=jpre, cache=jc)
    _, tc = TQ.forward(tparams["llm"], tcfg.llm, inputs_embeds=tpre, cache=tc)
    if per_row:   # rows at their own ages: 6, 4, 2 slots written
        jc = jc._replace(index=jnp.asarray([6, 4, 2], jnp.int32))
        tc = tc._replace(index=torch.tensor([6, 4, 2], dtype=torch.int32))
    jh, jc2 = JQ.forward(jparams["llm"], jcfg.llm, inputs_embeds=jemb, cache=jc)
    th, tc2 = TQ.forward(tparams["llm"], tcfg.llm, inputs_embeds=temb, cache=tc)
    _close(th, jh)
    _close(tc2.k.numpy(), jc2.k)
    got = tc2.index.tolist() if per_row else tc2.index
    assert got == np.asarray(jc2.index).tolist()


def test_forward_meta_bits_refuses_a_written_cache(model):
    """Meta bits describe the prefill of an empty cache: a per-row index
    refuses them."""
    _, _, tcfg, tparams = model
    cache = TQ.init_kv_cache(tcfg.llm, 2, 8, CPU, per_row_index=True)
    with pytest.raises(ValueError, match="meta_bits"):
        TQ.forward(tparams["llm"], tcfg.llm, input_ids=torch.ones((2, 3), dtype=torch.long),
                   meta_bits=torch.zeros((2, 3), dtype=torch.int32), cache=cache)


# ---------------------------------------------------------------------------
# the engine against JAX, greedy
# ---------------------------------------------------------------------------

def test_engine_greedy_matches_batch_decoder(model):
    """Mixed prompt lengths across buckets, more requests than slots: every
    request equals JAX's batch decoder."""
    prompts = _prompts(model[2], [5, 11, 3, 17, 9, 6, 14, 4, 12, 7])
    want = _expect(model, prompts, [10] * len(prompts))
    with _engine(model, slots=3, max_len=64, buckets=(8, 16, 24), chunk=4) as eng:
        futs = [eng.submit(p, max_new_tokens=10) for p in prompts]
        got = [f.result(timeout=T) for f in futs]
    assert got == want
    assert eng.stats.requests_completed == len(prompts)


def test_engine_matches_jax_engine(model):
    """The same trace through JAX's ServingEngine and the port's: token for
    token, and the same chunk count (the scheduler decides alike)."""
    jcfg, jparams, tcfg, tparams = model
    prompts = _prompts(tcfg, [6, 10, 4, 13, 7], seed=7)
    budgets = [12, 5, 8, 8, 3]
    kw = dict(slots=2, max_len=48, buckets=(16,), chunk=(2, 4))
    with JServingEngine(jparams, jcfg, **kw) as jeng:
        want = [f.result(timeout=300) for f in
                [jeng.submit(p, max_new_tokens=m) for p, m in zip(prompts, budgets)]]
    with _engine(model, **kw) as eng:
        got = [f.result(timeout=T) for f in
               [eng.submit(p, max_new_tokens=m) for p, m in zip(prompts, budgets)]]
    assert got == want
    assert eng.stats.decode_chunks == jeng.stats.decode_chunks
    assert eng.stats.busy_steps == jeng.stats.busy_steps


def test_engine_staggered_admission(model):
    """Requests submitted while others decode (the continuous part)."""
    prompts = _prompts(model[2], [6, 10, 4, 13], seed=7)
    budgets = [12, 5, 8, 8]
    want = _expect(model, prompts, budgets)
    eng = _engine(model, slots=2, max_len=64, buckets=(16,), chunk=2)
    try:
        f0 = eng.submit(prompts[0], max_new_tokens=12)
        f1 = eng.submit(prompts[1], max_new_tokens=5)
        f1.result(timeout=T)  # a slot frees while f0 still decodes
        f2 = eng.submit(prompts[2], max_new_tokens=8)
        f3 = eng.submit(prompts[3], max_new_tokens=8)
        got = [f.result(T) for f in (f0, f1, f2, f3)]
    finally:
        eng.close()
    assert got == want


def test_engine_batched_admission_exact(model):
    """Same-bucket waves fill a group in one prefill; mixed buckets break
    groups at signature boundaries; groups of 1-5 rows (no padding rows)."""
    prompts = _prompts(model[2], [3, 5, 7, 4, 6, 20, 22, 8, 21], seed=17)
    want = _expect(model, prompts, [6] * len(prompts))
    with _engine(model, slots=8, max_len=64, buckets=(16, 32), chunk=4) as eng:
        got = [f.result(timeout=T) for f in [eng.submit(p, max_new_tokens=6) for p in prompts]]
    assert got == want


def test_engine_chunk_boundary_finish_and_readmission(model):
    """Budgets on chunk boundaries and a backlog: every slot freed and
    re-admitted while the next chunk is in flight (the snapshot guard)."""
    chunk = 3
    budgets = [chunk, 2 * chunk, chunk, chunk, 2 * chunk, chunk]
    prompts = _prompts(model[2], [5, 7, 9, 4, 6, 8], seed=13)
    want = _expect(model, prompts, budgets)
    with _engine(model, slots=2, max_len=64, buckets=(16,), chunk=chunk) as eng:
        got = [f.result(timeout=T) for f in
               [eng.submit(p, max_new_tokens=m) for p, m in zip(prompts, budgets)]]
    assert got == want


def test_engine_eot_stops_and_frees_slot(model):
    prompts = _prompts(model[2], [8, 8, 8, 8], seed=11)
    eot = _expect(model, prompts[:1], [6])[0][1]   # prompt 0's 2nd token
    want = _expect(model, prompts, [6] * 4, eot=eot)
    with _engine(model, slots=2, max_len=32, buckets=(8,), chunk=3) as eng:
        got = [f.result(timeout=T) for f in
               [eng.submit(p, max_new_tokens=6, eot_token=eot) for p in prompts]]
    assert got == want and len(got[0]) == 2


def test_engine_device_stop_long_chunk_no_overshoot(model):
    """A chunk far longer than any budget: each row stops itself on the
    device at its eot or budget, in a couple of host syncs."""
    prompts = _prompts(model[2], [5, 9, 7, 4], seed=31)
    budgets = [3, 6, 5, 4]
    eot = _expect(model, prompts[:1], [6])[0][1]
    want = _expect(model, prompts, budgets, eot=eot)
    with _engine(model, slots=4, max_len=64, buckets=(16,), chunk=24) as eng:
        got = [f.result(timeout=T) for f in
               [eng.submit(p, max_new_tokens=m, eot_token=eot) for p, m in zip(prompts, budgets)]]
    assert got == want and len(got[0]) == 2
    assert eng.stats.decode_chunks <= 3


def test_engine_adaptive_chunks_exact(model):
    """Adaptive chunks equal a fixed-chunk engine and the reference, in
    fewer chunks."""
    prompts = _prompts(model[2], [5, 8, 11, 4, 6, 9, 7, 5], seed=41)
    budgets = [2, 17, 5, 9, 3, 12, 1, 7]
    want = _expect(model, prompts, budgets)

    def run(chunk):
        with _engine(model, slots=3, max_len=64, buckets=(16,), chunk=chunk) as eng:
            got = [f.result(timeout=T) for f in
                   [eng.submit(p, max_new_tokens=m) for p, m in zip(prompts, budgets)]]
            return got, eng.stats.decode_chunks

    fixed, n_fixed = run(2)
    adaptive, n_adaptive = run((2, 4, 8, 16))
    assert fixed == adaptive == want
    assert n_adaptive < n_fixed


def test_engine_quantized_cache_matches_jax_decode(model):
    """The int8 cache: tokens equal JAX's decode with an int8 cache
    (``mmu_generate(quantized_cache=True)`` under generate_text's mask)."""
    jcfg, jparams, tcfg, _ = model
    prompts = _prompts(tcfg, [7, 12, 5], seed=9)
    plen = np.asarray([len(p) for p in prompts])
    ids = np.zeros((3, 12), np.int32)
    for i, p in enumerate(prompts):
        ids[i, :len(p)] = p
    pos = np.arange(12)
    keep = pos[None] < plen[:, None]
    mask = ((pos[:, None] >= pos[None, :])[None, None]
            & keep[:, None, None, :] & keep[:, None, :, None])
    want = np.asarray(JD.mmu_generate(
        jparams, jcfg, jax.random.key(0), input_ids=jnp.asarray(ids),
        attention_mask=jnp.asarray(mask), prompt_len=jnp.asarray(plen), max_new_tokens=6,
        temperature=0.0, quantized_cache=True)).tolist()
    with _engine(model, slots=2, max_len=32, buckets=(16,), chunk=4, quantized_cache=True) as eng:
        got = [f.result(timeout=T) for f in [eng.submit(p, max_new_tokens=6) for p in prompts]]
    assert got == want


def test_engine_shared_prefix_matches_full_prompt(model):
    """A prefix prefilled once, suffix-only admission: the tokens of the full
    prompt, across staggered admissions, in the float and the int8 cache."""
    rng = np.random.default_rng(53)
    prefix = rng.integers(3, model[2].text_vocab_len - 1, size=9).tolist()
    suffixes = _prompts(model[2], [5, 11, 7], seed=54)
    budgets = [6, 4, 7]
    want = _expect(model, [prefix + s for s in suffixes], budgets)
    for quantized in (False, True):
        with _engine(model, slots=2, max_len=64, buckets=(16,), chunk=3, prefix_ids=prefix,
                     quantized_cache=quantized) as eng:
            assert eng.prefix_len == 9
            got = [f.result(timeout=T) for f in
                   [eng.submit(s, max_new_tokens=b) for s, b in zip(suffixes, budgets)]]
        if not quantized:
            assert got == want
        else:   # against the int8 engine on the full prompts
            with _engine(model, slots=2, max_len=64, buckets=(32,), chunk=3,
                         quantized_cache=True) as eng:
                full = [f.result(timeout=T) for f in
                        [eng.submit(prefix + s, max_new_tokens=b)
                         for s, b in zip(suffixes, budgets)]]
            assert got == full


def test_engine_shared_prefix_rejects_embeds_and_overflow(model):
    with _engine(model, slots=1, max_len=32, buckets=(16,), prefix_ids=list(range(3, 12))) as eng:
        with pytest.raises(ValueError):  # 9 + 16 + 10 > 32
            eng.submit([5, 6], max_new_tokens=10)
        with pytest.raises(ValueError):
            eng.submit_embeds(torch.zeros((1, 16, 64)), torch.zeros((1, 16), dtype=torch.int32),
                              4, max_new_tokens=2)


def _embeds_request(model, seed=2, l=12, plen=9):
    jcfg, jparams, tcfg, tparams = model
    ids = np.random.default_rng(seed).integers(3, 100, size=(1, l))
    pos = np.arange(l)
    keep = pos < plen
    mask = ((pos[:, None] >= pos[None, :])[None, None]
            & keep[None, None, None, :] & keep[None, None, :, None])
    want = np.asarray(JD.mmu_generate(jparams, jcfg, jax.random.key(0), input_ids=jnp.asarray(ids),
                                      attention_mask=jnp.asarray(mask),
                                      prompt_len=jnp.asarray([plen]), max_new_tokens=7,
                                      temperature=0.0))[0].tolist()
    pad = torch.from_numpy(~keep[None])
    bits = TM.pack_meta(TM.AttnMeta(pad=pad, bidir_q=torch.zeros_like(pad),
                                    bidir_k=torch.zeros_like(pad)))
    return TU.embed_tokens(tparams, torch.from_numpy(ids)), bits, plen, want


def test_engine_embeddings_path_matches_mmu_generate(model):
    """Spliced embeddings with their meta bits through the engine equal JAX's
    ``mmu_generate`` under the dense mask the bits describe."""
    emb, bits, plen, want = _embeds_request(model)
    with _engine(model, slots=2, max_len=32, buckets=(12,), chunk=4) as eng:
        got = eng.submit_embeds(emb, bits, plen, max_new_tokens=7).result(T)
        got_np = eng.submit_embeds(emb.numpy(), bits.numpy(), plen, max_new_tokens=7).result(T)
    assert got == got_np == want


@pytest.fixture(scope="module")
def vqa_pipes():
    tok = DecodableMockTokenizer()
    jprompt = JPrompting(tok, special_tokens=SPECIALS, max_seq_len=64, cond_dropout_prob=0.0)
    cfg_kw = dict(text_vocab_len=len(tok), w_und_encoder=True, mm_input_dim=32)
    jcfg, tcfg = JU.UniGenConfig.tiny(**cfg_kw), TU.UniGenConfig.tiny(**cfg_kw)
    jvs, tvs = (JS.SiglipConfig.tiny(image_size=28, patch_size=14, hidden_size=32),
                TS.SiglipConfig.tiny(image_size=28, patch_size=14, hidden_size=32))
    params, vs_params = JU.init(jax.random.key(0), jcfg), JS.init(jax.random.key(2), jvs)
    vq_cfg = JMV.MagvitConfig.tiny(resolution=8, z_channels=5)
    jpipe = JPipeline(params, jcfg, JMV.init(jax.random.key(1), vq_cfg), vq_cfg, jprompt,
                      vision_params=vs_params, vision_cfg=jvs)
    tpipe = TPipeline(W.unigen_from_jax(jax.tree.map(np.asarray, params), tcfg), tcfg, None, None,
                      TPrompting(DecodableMockTokenizer(), special_tokens=SPECIALS, max_seq_len=64),
                      CPU, vision_params=W.siglip_from_jax(jax.tree.map(np.asarray, vs_params), tvs),
                      vision_cfg=tvs)
    return jpipe, tpipe


VQA_QUESTIONS = ["is there a cat?", "what color is the large bus on the left?", "why?"]


def test_vqa_serving_inputs_through_engine_match_understand(vqa_pipes):
    """``vqa_serving_inputs`` (embeddings and mmu_vit bits, the question's part
    bucketed to 16) through ``submit_embeds`` gives JAX's ``understand``
    tokens, cut at the eos as the engine stops there; the splice equals JAX's
    and the bits are its dense mask on every non-pad query row."""
    jpipe, tpipe = vqa_pipes
    px = np.random.default_rng(5).integers(0, 256, size=(3, 28, 28, 3), dtype=np.uint8)
    want = np.asarray(jpipe.understand(jnp.asarray(px), VQA_QUESTIONS, jax.random.key(6),
                                       max_new_tokens=8))
    reqs = tpipe.vqa_serving_inputs(px, VQA_QUESTIONS, l2_bucket=16)
    jreqs = jpipe.vqa_serving_inputs(jnp.asarray(px), VQA_QUESTIONS, l2_bucket=16)
    eos = tpipe.prompting.eos_token_id
    lengths = sorted({r[0].shape[1] for r in reqs})
    for (emb, bits, plen), (jemb, jmask, jplen, _) in zip(reqs, jreqs):
        assert plen == jplen and emb.shape[1] == jemb.shape[1]
        np.testing.assert_allclose(emb.numpy(), np.asarray(jemb), atol=1e-5, rtol=1e-5)
        vis = TM.unpack_meta(bits).visibility().numpy()[0, 0]
        np.testing.assert_array_equal(vis[:plen], np.asarray(jmask)[0, 0, :plen])
    with ServingEngine(tpipe.params, tpipe.cfg, slots=2, max_len=max(lengths) + 8,
                       buckets=tuple(lengths), chunk=4, device="cpu") as eng:
        futs = [eng.submit_embeds(e, b, p, max_new_tokens=8, eot_token=eos)
                for e, b, p in reqs]
        got = [f.result(timeout=T) for f in futs]
    for g, w in zip(got, want.tolist()):
        assert g == (w[:w.index(eos) + 1] if eos in w else w)


def test_engine_mixed_w8a8_admission_w4a8_decode_matches_jax_engine(model):
    """``decode_params``: admission on the W8A8 tree, decode chunks on the
    W4A8 tree, the mode of JAX's serving bench, against JAX's engine on the
    same two trees."""
    jcfg, jparams, tcfg, _ = model
    j8 = JQZ.quantize_unigen_params(jparams, jcfg, lm_head=True)
    j4 = J4.quantize_unigen_params_int4(jparams, jcfg, group=32)
    t8, t4 = (W.unigen_from_jax(jax.tree.map(np.asarray, t), tcfg) for t in (j8, j4))
    prompts = _prompts(tcfg, [6, 9, 12], seed=61)
    kw = dict(slots=2, max_len=32, buckets=(16,), chunk=3)
    with JServingEngine(j8, jcfg, decode_params=j4, **kw) as jeng:
        want = [f.result(timeout=300) for f in [jeng.submit(p, max_new_tokens=6) for p in prompts]]
    with ServingEngine(t8, tcfg, decode_params=t4, device="cpu", **kw) as eng:
        got = [f.result(timeout=T) for f in [eng.submit(p, max_new_tokens=6) for p in prompts]]
    assert got == want


# ---------------------------------------------------------------------------
# the host side, against the port itself
# ---------------------------------------------------------------------------

def test_engine_rejects_oversized_and_unported_options(model):
    with _engine(model, slots=1, max_len=32, buckets=(8, 16)) as eng:
        with pytest.raises(ValueError, match="exceeds largest bucket"):
            eng.submit(list(range(3, 20)))
        with pytest.raises(ValueError, match="exceeds the"):
            eng.submit([3, 4, 5], max_new_tokens=100)
        with pytest.raises(ValueError, match="at least one token"):
            eng.submit([])
    with pytest.raises(NotImplementedError, match="5\\(b\\)"):
        _engine(model, speculate_k=2)
    cfg = dataclasses.replace(model[2], llm=dataclasses.replace(model[2].llm, kv_layout="skbd"))
    with pytest.raises(NotImplementedError, match="bskd"):
        ServingEngine(model[3], cfg, device="cpu")


def test_engine_occupancy_and_latency_marks(model):
    with _engine(model, slots=4, max_len=32, buckets=(8,), chunk=2) as eng:
        fut = eng.submit(_prompts(model[2], [5])[0], max_new_tokens=6)
        fut.result(timeout=T)
    s = eng.stats
    assert s.slot_steps >= s.busy_steps > 0 and 0 < s.occupancy <= 1.0
    # one occupied row of 4, chunks of 2
    assert s.busy_steps == 2 * s.decode_chunks and s.slot_steps == 8 * s.decode_chunks
    assert fut.ttft is not None and fut.ttft > 0 and fut.itl is not None and fut.itl >= 0
    assert fut.done_t >= fut.first_token_t >= fut.submit_t


def test_engine_cancel_deactivates_device_row(model):
    """A cancelled occupant's device row is frozen, and the slot then serves
    the queue exactly."""
    prompts = _prompts(model[2], [6, 7], seed=71)
    want = _expect(model, prompts[1:], [5])[0]
    with _engine(model, slots=1, max_len=64, buckets=(8,), chunk=2) as eng:
        f0 = eng.submit(prompts[0], max_new_tokens=40)
        next(f0.stream(timeout=T))   # it decodes
        f0.cancel()
        got = eng.submit(prompts[1], max_new_tokens=5).result(timeout=T)
        with pytest.raises(Exception):
            f0.result(timeout=T)
    assert got == want
    assert not bool(eng._state.active.any())


def test_engine_cancellation_frees_slot(model):
    from concurrent.futures import CancelledError
    prompts = _prompts(model[2], [6, 7, 8], seed=41)
    want = _expect(model, prompts[2:], [5])[0]
    with _engine(model, slots=1, max_len=96, buckets=(16,), chunk=2) as eng:
        running = eng.submit(prompts[0], max_new_tokens=64)
        queued = eng.submit(prompts[1], max_new_tokens=64)
        survivor = eng.submit(prompts[2], max_new_tokens=5)
        running.cancel()
        queued.cancel()
        got = survivor.result(timeout=T)
        for f in (running, queued):
            with pytest.raises(CancelledError):
                f.result(timeout=T)
    assert got == want


def test_stream_timeout_raises_timeout_error():
    with pytest.raises(TimeoutError):
        next(GenerationResult(0).stream(timeout=0.01))


def test_engine_stream_matches_result(model):
    prompts = _prompts(model[2], [6, 9], seed=13)
    want = _expect(model, prompts, [7, 7])
    with _engine(model, slots=2, max_len=32, buckets=(16,), chunk=3) as eng:
        futs = [eng.submit(p, max_new_tokens=7) for p in prompts]
        streamed = [list(f.stream(timeout=T)) for f in futs]
        results = [f.result(timeout=T) for f in futs]
    assert streamed == results == want


def test_engine_concurrent_submitters_exact(model):
    """4 threads x 4 requests race their submissions, half read by stream();
    every output equals the reference."""
    rng = np.random.default_rng(7)
    prompts = _prompts(model[2], rng.integers(4, 13, size=16).tolist(), seed=7)
    budgets = rng.integers(2, 7, size=16).tolist()
    want = _expect(model, prompts, budgets)
    got, err = {}, []
    with _engine(model, slots=3, max_len=32, buckets=(16,), chunk=3) as eng:
        def worker(k):
            try:
                futs = [(i, eng.submit(prompts[i], max_new_tokens=budgets[i]))
                        for i in range(k, 16, 4)]
                for i, f in futs:
                    got[i] = list(f.stream(timeout=T)) if i % 2 else f.result(timeout=T)
            except BaseException as e:  # surface failures to the main thread
                err.append(e)
        threads = [threading.Thread(target=worker, args=(k,)) for k in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=2 * T)
        assert not any(t.is_alive() for t in threads)
    assert not err, err
    assert [got[i] for i in range(16)] == want


def test_engine_per_request_temperature(model):
    """A greedy row stays exact beside a sampled one; the sampled row's
    tokens are in the vocabulary and follow its seed."""
    prompts = _prompts(model[2], [6, 6], seed=5)
    want = _expect(model, prompts[:1], [8])[0]
    runs = []
    for _ in range(2):
        with _engine(model, slots=2, max_len=32, buckets=(8,), chunk=4, top_k=20) as eng:
            fg = eng.submit(prompts[0], max_new_tokens=8, temperature=0.0)
            fs = eng.submit(prompts[1], max_new_tokens=8, temperature=1.0, seed=3)
            runs.append((fg.result(T), fs.result(T)))
    assert runs[0] == runs[1] and runs[0][0] == want
    assert all(0 <= t < model[2].vocab_size for t in runs[0][1])


def test_engine_sampled_schedule_independent(model):
    """A sampled request with a seed yields the same tokens however it is
    scheduled: slot counts, chunk lengths, queue position, adaptive chunks.
    Its draws come from derived_generator(seed, position)."""
    prompt = _prompts(model[2], [7], seed=23)[0]
    noise = _prompts(model[2], [5, 9], seed=24)

    def run(slots, chunk, lead):
        with _engine(model, slots=slots, max_len=48, buckets=(16,), chunk=chunk, seed=99,
                     top_k=50) as eng:
            lead_futs = [eng.submit(n, max_new_tokens=4, temperature=0.7) for n in noise[:lead]]
            fut = eng.submit(prompt, max_new_tokens=8, temperature=0.9, seed=1234)
            [f.result(timeout=T) for f in lead_futs]
            return fut.result(timeout=T)

    base = run(slots=3, chunk=2, lead=0)
    assert base == run(slots=1, chunk=5, lead=2)          # queued behind
    assert base == run(slots=2, chunk=(2, 3, 8), lead=1)  # adaptive chunks, shared batch
    # the first token is drawn at the prompt's length, JAX's _row_keys(seed, prompt_len)
    cfg, params = model[2], model[3]
    h, _ = TQ.forward(params["llm"], cfg.llm, input_ids=torch.tensor([prompt]))
    lg = TQ.logits(params["llm"], cfg.llm, h[:, -1]).float()
    u = torch.rand((lg.shape[-1],), generator=derived_generator(1234, len(prompt)))
    assert base[0] == int(TE._sample_rows(lg, torch.tensor([0.9]), 50, u[None])[0])


def test_decode_chunk_reads_nothing_back(model):
    """One decode chunk of a running engine's state makes no device-to-host
    read: no item(), tolist(), cpu(), numpy() or truth test of a tensor."""
    from torch.overrides import TorchFunctionMode

    reads = []

    class Spy(TorchFunctionMode):
        READS = {torch.Tensor.item, torch.Tensor.tolist, torch.Tensor.cpu, torch.Tensor.numpy,
                 torch.Tensor.__bool__, torch.Tensor.__int__, torch.Tensor.__index__,
                 torch.Tensor.__float__}

        def __torch_function__(self, func, types, args=(), kwargs=None):
            if func in self.READS:
                reads.append(func.__name__)
            return func(*args, **(kwargs or {}))

    cfg, params = model[2], model[3]
    cache = TQ.init_kv_cache(cfg.llm, 3, 16, CPU, per_row_index=True)
    cache = cache._replace(index=torch.tensor([4, 0, 9], dtype=torch.int32))
    state = TE.init_slot_state(3, CPU)._replace(
        active=torch.tensor([True, False, True]), budget=torch.full((3,), 5, dtype=torch.int32),
        temp=torch.tensor([0.0, 0.0, 0.8]), last_tok=torch.tensor([7, 0, 9]))
    with Spy():
        _, state2, toks = TE._decode_chunk(params, cfg, cache, state, 4, None, [(2, 5, 10)])
    assert reads == []
    assert toks.shape == (3, 4) and state2.active.tolist() == [True, False, True]


def test_engine_precompile_is_noop_and_memo(model):
    """The warm-up changes no result, for the ids (with and without a prefix)
    and the embeddings signatures; a second engine of one key skips it; the
    key enters the memo only after its dispatches succeeded."""
    prompts = _prompts(model[2], [3, 5, 7, 4, 20, 6, 21, 8], seed=23)
    want = _expect(model, prompts, [6] * len(prompts))

    def run(pre):
        with _engine(model, slots=4, max_len=64, buckets=(16, 32), chunk=(2, 4, 8),
                     precompile=pre) as eng:
            return [f.result(timeout=T) for f in [eng.submit(p, max_new_tokens=6) for p in prompts]]

    TE._PRECOMPILED_KEYS.clear()
    assert run(()) == want and not TE._PRECOMPILED_KEYS
    assert run([("ids", 16), ("ids", 32)]) == want and len(TE._PRECOMPILED_KEYS) == 1
    assert run([("ids", 16), ("ids", 32)]) == want and len(TE._PRECOMPILED_KEYS) == 1
    prefix = [9, 8, 7]
    with _engine(model, slots=2, max_len=64, buckets=(16,), chunk=3, prefix_ids=prefix,
                 precompile=[("ids", 16)]) as eng:
        got = eng.submit(prompts[0], max_new_tokens=6).result(T)
    assert got == _expect(model, [prefix + prompts[0]], [6])[0]
    emb, bits, plen, want_e = _embeds_request(model)
    with _engine(model, slots=2, max_len=32, buckets=(12,), chunk=4,
                 precompile=[("emb", 12, model[2].llm.hidden_size)]) as eng:
        assert eng.submit_embeds(emb, bits, plen, max_new_tokens=7).result(T) == want_e
    n = len(TE._PRECOMPILED_KEYS)
    with pytest.raises(ValueError, match="unknown precompile signature"):
        _engine(model, slots=2, max_len=32, buckets=(12,), precompile=[("bogus", 12)])
    assert len(TE._PRECOMPILED_KEYS) == n


# ---------------------------------------------------------------------------
# HTTP
# ---------------------------------------------------------------------------

def _post(url, body, timeout=T):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def _status(url, body):
    try:
        _post(url, body, timeout=60)
    except urllib.error.HTTPError as e:
        return e.code
    return 200


class _Tok:
    """A trivial tokenizer for the HTTP routes (tests/test_serving.py's)."""

    def __init__(self, vocab):
        self.v = vocab

    def encode(self, text):
        return [3 + (ord(c) % (self.v - 4)) for c in text]

    def decode(self, ids):
        return ",".join(str(int(i)) for i in ids)


def test_healthz_reports_dead_engine(model):
    eng = _engine(model, slots=2, max_len=32, buckets=(16,))
    with ServingHTTPServer(eng) as srv:
        url = f"http://{srv.host}:{srv.port}/healthz"
        with urllib.request.urlopen(url, timeout=60) as r:
            assert json.loads(r.read())["status"] == "ok"
        eng.close()
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(url, timeout=60)
        assert e.value.code == 503 and json.loads(e.value.read())["status"] == "dead"


def test_http_openai_routes(model):
    """/v1/completions and /v1/chat/completions: the response shapes, usage,
    stop strings, null max_tokens, content parts, the raw flag and 400s, with
    greedy tokens equal to JAX's batch decoder."""
    tok = _Tok(model[2].text_vocab_len)
    prompt = "hello tpu"
    ids = tok.encode(prompt)
    templ = ("<|im_start|>system\nbe brief<|im_end|>\n"
             "<|im_start|>user\nhi<|im_end|>\n<|im_start|>assistant\n")
    ref, ref_c, ref_raw = _expect(model, [ids, tok.encode(templ), ids[:3]], [5, 4, 2])
    with _engine(model, slots=2, max_len=112, buckets=(16, 96)) as eng:
        with ServingHTTPServer(eng, tokenizer=tok, default_max_new_tokens=5) as srv:
            url = f"http://{srv.host}:{srv.port}"
            out = _post(url + "/v1/completions", {"prompt": prompt, "max_tokens": 5})
            assert out["object"] == "text_completion" and out["model"] == "unigen-tpu"
            assert out["choices"][0]["text"] == tok.decode(ref)
            assert out["choices"][0]["finish_reason"] == "length"
            assert out["usage"] == {"prompt_tokens": len(ids), "completion_tokens": 5,
                                    "total_tokens": len(ids) + 5}
            stop = "," + str(ref[2])
            out = _post(url + "/v1/completions", {"prompt": prompt, "max_tokens": 5, "stop": stop})
            assert out["choices"][0]["finish_reason"] == "stop"
            assert out["choices"][0]["text"] == tok.decode(ref).split(stop)[0]
            out = _post(url + "/v1/completions", {"prompt": prompt, "max_tokens": None})
            assert out["usage"]["completion_tokens"] == 5
            msgs = [{"role": "system", "content": "be brief"}, {"role": "user", "content": "hi"}]
            out = _post(url + "/v1/chat/completions", {"messages": msgs, "max_tokens": 4})
            assert out["object"] == "chat.completion"
            assert out["choices"][0]["message"] == {"role": "assistant",
                                                    "content": tok.decode(ref_c)}
            msgs_p = [msgs[0], {"role": "user", "content": [{"type": "text", "text": "hi"}]}]
            out_p = _post(url + "/v1/chat/completions", {"messages": msgs_p, "max_tokens": 4})
            assert out_p["choices"] == out["choices"]
            tok.encode_raw = lambda t: tok.encode(t)[:3]
            out = _post(url + "/v1/generate", {"prompt": prompt, "raw": True, "max_new_tokens": 2})
            assert out["tokens"] == ref_raw
            del tok.encode_raw
            for body, route in [({"prompt": "x", "stream": True}, "/v1/completions"),
                                ({"messages": []}, "/v1/chat/completions"),
                                ({"prompt": "", "max_tokens": 3}, "/v1/completions"),
                                ({"prompt": "x", "n": 2}, "/v1/completions")]:
                assert _status(url + route, body) == 400


def test_http_server_end_to_end(model):
    """Concurrent /v1/generate clients, /healthz, a 400, and SSE streaming."""
    prompts = _prompts(model[2], [5, 9, 12], seed=4)
    want = _expect(model, prompts, [6] * 3)
    eng = _engine(model, slots=2, max_len=48, buckets=(16,), chunk=4)
    with ServingHTTPServer(eng, port=0) as srv:
        url = f"http://{srv.host}:{srv.port}"
        results = [None] * len(prompts)

        def client(i):
            results[i] = _post(url + "/v1/generate", {"prompt_ids": prompts[i],
                                                      "max_new_tokens": 6})
        threads = [threading.Thread(target=client, args=(i,)) for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=T)
        assert [r["tokens"] for r in results] == want
        with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
            health = json.loads(r.read())
        assert health["status"] == "ok" and health["stats"]["requests_completed"] == 3
        assert _status(url + "/v1/generate", {"nonsense": 1}) == 400
        assert _status(url + "/v1/nowhere", {}) == 404
        sreq = urllib.request.Request(
            url + "/v1/generate", headers={"Content-Type": "application/json"},
            data=json.dumps({"prompt_ids": prompts[0], "max_new_tokens": 6,
                             "stream": True}).encode())
        with urllib.request.urlopen(sreq, timeout=T) as r:
            assert r.headers["Content-Type"] == "text/event-stream"
            events = [json.loads(line[len(b"data: "):]) for line in r.read().splitlines()
                      if line.startswith(b"data: ")]
        assert events[-1]["done"] is True
        streamed = [e["token"] for e in events[:-1]]
        assert streamed == events[-1]["tokens"] == want[0]
    eng.close()


def test_http_images_endpoint_and_without_engine(model, tmp_path):
    """POST /v1/images: a base64 PNG (the port's zlib writer) that reads back
    as the direct call's pixels; a missing prompt, and a server without an
    image engine, answer 400."""
    import base64
    pipe = build_pipeline("tiny", device="cpu", seed=4)
    protocol = dict(guidance_scale=2.0, timesteps=3, temperature=1.0, max_text_len=8)
    text_eng = ServingEngine(pipe.params, pipe.cfg, slots=2, max_len=32, buckets=(16,),
                             device="cpu")
    with ImageServingEngine(pipe, batch=1, max_wait_s=0.01, seed=0, **protocol) as ieng:
        with ServingHTTPServer(text_eng, image_engine=ieng) as srv:
            url = f"http://{srv.host}:{srv.port}"
            out = _post(url + "/v1/images", {"prompt": "a red cat"}, timeout=300)
            path = tmp_path / "img.png"
            path.write_bytes(base64.b64decode(out["image_png"]))
            arr = load_png(str(path))
            assert arr.shape == (out["height"], out["width"], 3)
            direct = pixels_to_uint8(pipe.generate_images(
                ["a red cat"], derived_generator(0, 0), **protocol))[0]
            np.testing.assert_array_equal(arr, direct)
            assert _status(url + "/v1/images", {}) == 400
    with ServingHTTPServer(text_eng) as srv:
        assert _status(f"http://{srv.host}:{srv.port}/v1/images", {"prompt": "x"}) == 400
    text_eng.close()
