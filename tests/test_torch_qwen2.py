"""The port's Qwen2 backbone against the JAX package's ``qwen2.forward``.

Weights are the JAX tiny init (biases and norm scales perturbed so that they
matter), carried across by ``unigen_tpu_torch.weights``. fp32 on the CPU.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unigen_tpu.models import qwen2 as JQ
from unigen_tpu.models import unigen as JU
from unigen_tpu_torch import weights as W
from unigen_tpu_torch.models import qwen2 as TQ
from unigen_tpu_torch.models import unigen as TU
from unigen_tpu_torch.ops import masks as TM

PAD = 0


def _perturb(tree, rng):
    """Nonzero biases and non-unit norm scales, the same in both frameworks."""
    def fix(path, a):
        a = np.array(a)
        name = jax.tree_util.keystr(path)
        if "bias" in name:
            return (a + 0.05 * rng.normal(size=a.shape)).astype(a.dtype)
        if "scale" in name:
            return (a + 0.1 * rng.normal(size=a.shape)).astype(a.dtype)
        return a
    return jax.tree_util.tree_map_with_path(fix, tree)


@pytest.fixture(scope="module")
def model():
    jcfg = JU.UniGenConfig.tiny()
    tree = _perturb(jax.tree.map(np.asarray, JU.init(jax.random.key(0), jcfg)),
                    np.random.default_rng(0))
    jparams = jax.tree.map(jnp.asarray, tree)
    tcfg = TU.UniGenConfig.tiny()
    tparams = W.unigen_from_jax(tree, tcfg)
    return jcfg, jparams, tcfg, tparams


def _prompt(rb=4, lp=9, seed=1):
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, 100, size=(rb, lp))
    for r in range(rb):
        ids[r, :r] = PAD                                # left padding, 0..rb-1 pads
    return ids


def _prefill(model, ids, total):
    jcfg, jparams, tcfg, tparams = model
    rb, lp = ids.shape
    keep = ids != PAD
    pos = np.arange(lp)
    pm = (pos[:, None] >= pos[None, :])[None, None] & keep[:, None, None, :]
    pm = np.concatenate([np.broadcast_to(pm, (rb, 1, lp, lp)),
                         np.zeros((rb, 1, lp, total - lp), bool)], axis=-1)
    jh, jc = JQ.forward(jparams["llm"], jcfg.llm, input_ids=jnp.asarray(ids),
                        mask=jnp.asarray(pm), cache=JQ.init_kv_cache(jcfg.llm, rb, total))
    tids = torch.from_numpy(ids)
    th, tc = TQ.forward(tparams["llm"], tcfg.llm, input_ids=tids,
                        meta_bits=TM.pack_meta(TM.lm_attn_meta(tids, PAD)),
                        cache=TQ.init_kv_cache(tcfg.llm, rb, total, torch.device("cpu")))
    return jh, jc, th, tc, keep


def test_prefill_hidden_and_cache_match_on_non_pad(model):
    ids = _prompt()
    jh, jc, th, tc, keep = _prefill(model, ids, ids.shape[1] + 6)
    assert tc.index == ids.shape[1] and int(jc.index) == ids.shape[1]
    # pad rows differ by design (they are never visible to a later query);
    # fp32 on both sides: the order of sums differs
    np.testing.assert_allclose(th.numpy()[keep], np.asarray(jh)[keep], atol=2e-5, rtol=2e-5)
    lp = ids.shape[1]
    for got, ref in ((tc.k, jc.k), (tc.v, jc.v)):
        got, ref = got.numpy()[:, :, :lp], np.asarray(ref)[:, :, :lp]
        np.testing.assert_allclose(got[:, keep], ref[:, keep], atol=2e-5, rtol=2e-5)


def test_cached_chunk_with_rowmask_matches(model):
    """A 258-style [soi][img x n][eoi] chunk against the prefilled cache:
    port (kv_rowmask -> chunk attention) vs JAX (dense step mask)."""
    jcfg, jparams, tcfg, tparams = model
    ids = _prompt()
    rb, lp = ids.shape
    chunk_len = 7
    total = lp + chunk_len
    _, jc, _, tc, keep = _prefill(model, ids, total)
    rng = np.random.default_rng(2)
    emb = rng.normal(size=(rb, chunk_len, tcfg.llm.hidden_size)).astype(np.float32) * 0.05
    vis = np.concatenate([keep, np.ones((rb, chunk_len), bool)], axis=1)
    positions = np.broadcast_to(lp + np.arange(chunk_len), (rb, chunk_len))
    jh, jc2 = JQ.forward(jparams["llm"], jcfg.llm, inputs_embeds=jnp.asarray(emb),
                         mask=jnp.asarray(np.broadcast_to(vis[:, None, None, :],
                                                          (rb, 1, chunk_len, total))),
                         positions=jnp.asarray(positions),
                         cache=JQ.KVCache(jc.k, jc.v, jnp.asarray(lp, jnp.int32)))
    th, tc2 = TQ.forward(tparams["llm"], tcfg.llm, inputs_embeds=torch.from_numpy(emb),
                         positions=torch.from_numpy(np.array(positions)),
                         cache=TQ.KVCache(tc.k, tc.v, lp),
                         kv_rowmask=torch.from_numpy(vis))
    assert tc2.index == total
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(tc2.k.numpy()[:, :, lp:], np.asarray(jc2.k)[:, :, lp:],
                               atol=2e-5, rtol=2e-5)


def test_cache_free_dense_mask_matches(model):
    """The full-path call: no cache, a dense [B, 1, L, L] mask."""
    jcfg, jparams, tcfg, tparams = model
    ids = _prompt(rb=2, lp=12, seed=3)
    pos = np.arange(12)
    mask = np.broadcast_to((pos[:, None] >= pos[None, :])[None, None], (2, 1, 12, 12)).copy()
    mask[0, 0, 5:, :2] = False
    jh, _ = JQ.forward(jparams["llm"], jcfg.llm, input_ids=jnp.asarray(ids),
                       mask=jnp.asarray(mask))
    th, _ = TQ.forward(tparams["llm"], tcfg.llm, input_ids=torch.from_numpy(ids),
                       mask=torch.from_numpy(mask))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=2e-5, rtol=2e-5)


def test_rms_norm_and_rope_match():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 5, 3, 16)).astype(np.float32)
    scale = rng.normal(size=(16,)).astype(np.float32)
    pos = rng.integers(0, 300, size=(2, 5))
    np.testing.assert_allclose(
        TQ.rms_norm(torch.from_numpy(x), torch.from_numpy(scale), 1e-6).numpy(),
        np.asarray(JQ.rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-6)), atol=1e-6, rtol=1e-5)
    for factor in (1.0, 2.0):
        np.testing.assert_allclose(
            TQ.rope(torch.from_numpy(x), torch.from_numpy(pos), 1e4, factor).numpy(),
            np.asarray(JQ.rope(jnp.asarray(x), jnp.asarray(pos), 1e4, factor)),
            atol=2e-5, rtol=1e-5)


def test_init_matches_jax_tree_layout():
    """The port's random init has the layout weights.py gives a JAX tree."""
    for kw in ({}, {"gen_proj_depth": 2}):
        jcfg, tcfg = JU.UniGenConfig.tiny(**kw), TU.UniGenConfig.tiny(**kw)
        tree = jax.tree.map(np.asarray, JU.init(jax.random.key(1), jcfg))
        bridged = W.unigen_from_jax(tree, tcfg)
        fresh = W.init_unigen(tcfg, torch.Generator().manual_seed(0), "cpu")
        shapes = lambda p: jax.tree.map(lambda a: tuple(a.shape), p)  # noqa: E731
        assert shapes(bridged) == shapes(fresh)


def test_forward_default_causal_mask_matches_jax(model):
    """Without a mask or a cache ``forward`` builds JAX's causal default
    (tests/test_torch_serving.py holds the cached defaults)."""
    jcfg, jparams, tcfg, tparams = model
    ids = _prompt()
    jh, _ = JQ.forward(jparams["llm"], jcfg.llm, input_ids=jnp.asarray(ids))
    th, _ = TQ.forward(tparams["llm"], tcfg.llm, input_ids=torch.from_numpy(ids))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=2e-5, rtol=2e-5)


def test_forward_without_a_mask_raises(model):
    """What ``forward`` still refuses where it used to want a mask: meta bits
    (the cache-free prefill's mask) over a cache that already holds
    positions, whose keys the bits cannot describe."""
    _, _, tcfg, tparams = model
    ids = _prompt()
    cache = TQ.init_kv_cache(tcfg.llm, ids.shape[0], 16, torch.device("cpu"))._replace(index=3)
    with pytest.raises(ValueError, match="meta_bits"):
        TQ.forward(tparams["llm"], tcfg.llm, input_ids=torch.from_numpy(ids), cache=cache,
                   meta_bits=torch.zeros(ids.shape, dtype=torch.int32))
