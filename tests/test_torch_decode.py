"""The port's cached text decode (``generation.decode``) against the JAX package.

Tiny UniGen backbone on the CPU in fp32, the float tree and the W4A8 tree
packed by JAX (group 32), carried across by ``weights.py``. Tokens must be
exact: greedy, and temperature 0.8 with top-k 5 under shared noise
(``noise=``, the same uniforms fed to both); right-padded ragged prompts; an
``eot`` that stops a row, which then repeats it.

The port's routing differs from JAX's (prefill through the flash path with
pad bits, decode steps through the chunk path with a per-row key mask); on
the CPU both wrappers run their plain versions, and the decode-step routing
is also held directly against the dense step mask.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unigen_tpu.generation import decode as JD
from unigen_tpu.models import unigen as JU
from unigen_tpu.ops import int4 as J4
from unigen_tpu.ops import masks as JM
from unigen_tpu_torch import weights as W
from unigen_tpu_torch.generation import decode as TD
from unigen_tpu_torch.models import qwen2 as TQ
from unigen_tpu_torch.models import unigen as TU
from unigen_tpu_torch.ops import masks as TM

from test_torch_qwen2 import _perturb

B, L, NEW = 3, 10, 8
PROMPT_LEN = np.array([10, 7, 5])
PREFIX, NUM_IMG = 2, 3


@pytest.fixture(scope="module")
def trees():
    jcfg, tcfg = JU.UniGenConfig.tiny(), TU.UniGenConfig.tiny()
    tree = _perturb(jax.tree.map(np.asarray, JU.init(jax.random.key(0), jcfg)),
                    np.random.default_rng(0))
    jfloat = jax.tree.map(jnp.asarray, tree)
    jq = J4.quantize_unigen_params_int4(jfloat, jcfg, group=32)
    return {"float": (jfloat, W.unigen_from_jax(tree, tcfg)),
            "w4a8": (jq, W.unigen_from_jax(jax.tree.map(np.asarray, jq), tcfg))}, jcfg, tcfg


def _ids():
    ids = np.random.default_rng(1).integers(3, 150, size=(B, L))
    for i, n in enumerate(PROMPT_LEN):
        ids[i, n:] = 0                                  # right padding
    return ids


def _run_both(trees, tree, temperature, top_k, eot, noise):
    params, jcfg, tcfg = trees
    jp, tp = params[tree]
    ids = _ids()
    keep = np.arange(L)[None] < PROMPT_LEN[:, None]
    mask = np.asarray(JM.create_attention_mask_for_mmu_vit(
        B, L, num_tokens=NUM_IMG, prefix_length=PREFIX))
    mask = mask & keep[:, None, None, :] & keep[:, None, :, None]
    want = JD.mmu_generate(jp, jcfg, jax.random.key(0), input_ids=jnp.asarray(ids),
                           attention_mask=jnp.asarray(mask), prompt_len=jnp.asarray(PROMPT_LEN),
                           max_new_tokens=NEW, temperature=temperature, top_k=top_k,
                           eot_token=eot, noise=None if noise is None else jnp.asarray(noise))
    plen = torch.from_numpy(PROMPT_LEN)
    meta = TM.pack_meta(TM.mmu_vit_attn_meta(B, L, num_tokens=NUM_IMG, prefix_length=PREFIX,
                                             prompt_len=plen))
    got = TD.mmu_generate(tp, tcfg, None, input_ids=torch.from_numpy(ids), meta_bits=meta,
                          prompt_len=plen, max_new_tokens=NEW, temperature=temperature,
                          top_k=top_k, eot_token=eot,
                          noise=None if noise is None else torch.from_numpy(noise))
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("tree", ["float", "w4a8"])
@pytest.mark.parametrize("mode", ["greedy", "noise"])
def test_mmu_generate_tokens_exact(trees, tree, mode):
    vocab = trees[2].vocab_size
    noise = (np.random.default_rng(2).random((NEW, B, vocab), dtype=np.float32)
             if mode == "noise" else None)
    temperature, top_k = (0.8, 5) if mode == "noise" else (0.0, None)
    got, want = _run_both(trees, tree, temperature, top_k, None, noise)
    assert got.shape == (B, NEW)
    np.testing.assert_array_equal(got, want)
    # an eot that row 1 emits mid-way: the row stops there and repeats it
    eot = int(want[1, 3])
    got, want = _run_both(trees, tree, temperature, top_k, eot, noise)
    np.testing.assert_array_equal(got, want)
    assert (got[1, 3:] == eot).all()


@pytest.mark.parametrize("tree", ["float", "w4a8"])
def test_generate_text_tokens_exact(trees, tree):
    params, jcfg, tcfg = trees
    jp, tp = params[tree]
    ids = _ids()
    want = JD.generate_text(jp, jcfg, jax.random.key(0), jnp.asarray(ids),
                            jnp.asarray(PROMPT_LEN), max_new_tokens=NEW, eot_token=11)
    got = TD.generate_text(tp, tcfg, None, torch.from_numpy(ids), torch.from_numpy(PROMPT_LEN),
                           max_new_tokens=NEW, eot_token=11)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sample_step_top_k_matches_jax():
    rng = np.random.default_rng(3)
    logits = rng.normal(size=(4, 50)).astype(np.float32) * 3
    u = rng.random((4, 50), dtype=np.float32)
    for temperature, top_k in ((0.8, 5), (1.3, None), (0.0, None)):
        want = JD._sample_step(None, jnp.asarray(logits), temperature, top_k, jnp.asarray(u))
        got = TD._sample_step(None, torch.from_numpy(logits), temperature, top_k,
                              torch.from_numpy(u))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    ties = np.zeros((2, 6), np.float32)
    ties[:, [2, 4]] = 1.0
    assert TD._sample_step(None, torch.from_numpy(ties), 0.0, None).tolist() == [2, 2]


def test_decode_step_chunk_routing_equals_dense_mask(trees):
    """One decode step: the per-row key mask through ``chunk_attention``
    against the same visibility as a dense [B, 1, 1, S] mask."""
    params, _, tcfg = trees
    tp = params["float"][1]
    total = L + 2
    ids = torch.from_numpy(_ids())
    cache = TQ.init_kv_cache(tcfg.llm, B, total, torch.device("cpu"))
    plen = torch.from_numpy(PROMPT_LEN)
    pos = torch.arange(L)[None]
    meta = TM.pack_meta(TM.AttnMeta(pad=pos >= plen[:, None], bidir_q=torch.zeros(B, L, dtype=bool),
                                    bidir_k=torch.zeros(B, L, dtype=bool)))
    _, cache = TQ.forward(tp["llm"], tcfg.llm, input_ids=ids, meta_bits=meta,
                          positions=torch.minimum(pos, plen[:, None] - 1), cache=cache)
    valid = torch.cat([pos < plen[:, None], torch.zeros(B, 2, dtype=bool)], 1)
    valid[:, L] = True
    tok = torch.tensor([[5], [6], [7]])
    outs = []
    for kw in ({"kv_rowmask": valid}, {"mask": valid[:, None, None, :]}):
        c = TQ.KVCache(cache.k.clone(), cache.v.clone(), cache.index)
        h, _ = TQ.forward(tp["llm"], tcfg.llm, input_ids=tok, positions=plen[:, None],
                          cache=c, **kw)
        outs.append(h.numpy())
    np.testing.assert_allclose(outs[0], outs[1], atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("sys_len,prefix", [(0, -1), (3, -1), (0, 5)])
def test_mmu_vit_masks_match_jax(sys_len, prefix):
    """The metadata form gives the same visibility as JAX's dense
    ``create_attention_mask_for_mmu_vit & keep_q & keep_k`` on every non-pad
    query row and nothing on pad rows."""
    b, l, n = 3, 16, 4
    want = np.asarray(JM.create_attention_mask_for_mmu_vit(
        b, l, system_prompt_len=sys_len, num_tokens=n, prefix_length=prefix))
    plen = np.array([16, 11, 9])
    keep = np.arange(l)[None] < plen[:, None]
    start = prefix if prefix > 0 else 2 + sys_len
    vis = TM.mmu_vit_attn_meta(b, l, num_tokens=n, prefix_length=start,
                               prompt_len=torch.from_numpy(plen)).visibility().numpy()
    ref = want & keep[:, None, None, :] & keep[:, None, :, None]
    np.testing.assert_array_equal(vis, ref)
