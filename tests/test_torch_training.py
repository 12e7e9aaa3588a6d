"""The port's pretraining path against the JAX package's, on the CPU in fp32.

Each piece of the unified train step: the flash attention gradients, the
MaskGIT corruption under JAX's draws, the ``t2i`` and ``lm`` prompts, the
lr schedules, the optax AdamW chain, the EMA, ``unigen.forward`` and its
losses and gradients, then the whole step (losses, updated parameters,
gradient accumulation). Weights are the JAX tiny inits (biases and norm
scales perturbed so that they matter), carried across by
``unigen_tpu_torch.weights``; JAX's Pallas kernel runs in interpret mode.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from unigen_tpu import launch as JL
from unigen_tpu.models import magvit as JMV
from unigen_tpu.models import unigen as JU
from unigen_tpu.ops import masking as JMK
from unigen_tpu.ops import masks as JM
from unigen_tpu.ops import sampling as JS
from unigen_tpu.ops.attention import dot_product_attention as j_dpa
from unigen_tpu.ops.flash_attention import flash_attention as j_flash
from unigen_tpu.ops.flash_attention import pack_meta as j_pack
from unigen_tpu.prompting import UniPrompting as JPrompting
from unigen_tpu.training import ema as JE
from unigen_tpu.training import lr_schedules as JLRS
from unigen_tpu.training import optimizer as JO
from unigen_tpu.training import train_step as JT
from unigen_tpu_torch import launch as TL
from unigen_tpu_torch import weights as W
from unigen_tpu_torch.models import magvit as TMV
from unigen_tpu_torch.models import unigen as TU
from unigen_tpu_torch.ops import masking as TMK
from unigen_tpu_torch.ops import masks as TM
from unigen_tpu_torch.ops import sampling as TS
from unigen_tpu_torch.ops.flash_attention import flash_attention as t_flash
from unigen_tpu_torch.prompting import UniPrompting as TPrompting
from unigen_tpu_torch.training import ema as TE
from unigen_tpu_torch.training import lr_schedules as TLRS
from unigen_tpu_torch.training import optimizer as TO
from unigen_tpu_torch.training import train_step as TT


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


def _models(**kw):
    jcfg = JU.UniGenConfig.tiny(**kw)
    tree = _perturb(jax.tree.map(np.asarray, JU.init(jax.random.key(0), jcfg)),
                    np.random.default_rng(0))
    tcfg = TU.UniGenConfig.tiny(**kw)
    return jcfg, jax.tree.map(jnp.asarray, tree), tcfg, W.unigen_from_jax(tree, tcfg)


def _leaf_errors(jtree, ttree_jax_layout):
    """{path: max |a - b| / max(max |a|, 1e-12)} over the JAX tree's leaves."""
    out = {}
    for path, a in jax.tree_util.tree_leaves_with_path(jtree):
        b = ttree_jax_layout
        for p in path:
            b = b[getattr(p, "key", getattr(p, "idx", None))]
        a = np.asarray(a, np.float64)
        b = b.detach().double().numpy()
        out[jax.tree_util.keystr(path)] = np.abs(a - b).max() / max(np.abs(a).max(), 1e-12)
    return out


def _grad_tree(params, loss):
    """d loss / d params as a tree shaped like ``params``."""
    leaves = [t for _, t in TO.named_leaves(params)]
    grads = iter(torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True))

    def rebuild(tree):
        if isinstance(tree, dict):
            return {k: rebuild(tree[k]) for k in sorted(tree)}
        if isinstance(tree, list):
            return [rebuild(v) for v in tree]
        return next(grads)
    return rebuild(params)


def _trainable(params):
    return W.map_tree(params, lambda t: t.detach().clone().requires_grad_(True))


# ---------------------------------------------------------------------------
# flash attention gradients
# ---------------------------------------------------------------------------

def _flash_meta(case, b, l):
    z = np.zeros((b, l), bool)
    pos = np.arange(l)[None].repeat(b, 0)
    if case == "causal":
        return z, z, z, None
    if case == "t2i":                       # left pads, a bidirectional image block
        pad = pos < np.array([[0], [3]])
        return pad, (pos >= 6) & (pos < 12) & ~pad, z, None
    if case == "mmu":                        # a visible prefix, right pads
        pad = pos >= np.array([[l], [l - 4]])
        return pad, z, (pos <= 5) & ~pad, None
    if case == "gqa":
        return pos < np.array([[2], [0]]), z, z, None
    seg = (pos >= l // 2).astype(np.int32)   # two packed segments
    return z, (pos >= 2) & (pos < 6), z, seg


@pytest.mark.parametrize("case,h,kvh", [("causal", 2, 2), ("t2i", 4, 2), ("mmu", 4, 2),
                                        ("gqa", 4, 2), ("segments", 4, 2)])
def test_flash_gradients_match_jax(case, h, kvh):
    """dq, dk, dv of the port (CPU: the plain version under autograd) against
    ``jax.grad`` through JAX's kernel in interpret mode (its custom_vjp)."""
    b, l, dh = 2, 16, 8
    rng = np.random.default_rng(6)
    q, k, v = (rng.normal(size=(b, l, n, dh)).astype(np.float32) for n in (h, kvh, kvh))
    pad, bq, bk, seg = _flash_meta(case, b, l)
    jmeta = JM.AttnMeta(pad=jnp.asarray(pad), bidir_q=jnp.asarray(bq), bidir_k=jnp.asarray(bk),
                        seg=None if seg is None else jnp.asarray(seg))
    jbits = j_pack(jmeta)
    tbits = TM.pack_meta(TM.AttnMeta(pad=torch.as_tensor(pad), bidir_q=torch.as_tensor(bq),
                                     bidir_k=torch.as_tensor(bk),
                                     seg=None if seg is None else torch.as_tensor(seg)))
    np.testing.assert_array_equal(tbits.numpy(), np.asarray(jbits))
    wts = rng.normal(size=(b, l, h, dh)).astype(np.float32)

    def loss(out, w):
        return (out * w).sum() + (out ** 2).sum()

    jg = jax.grad(lambda *a: loss(j_flash(*a, jbits, None, 8, True), jnp.asarray(wts)),
                  argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    jx = jax.grad(lambda *a: loss(j_dpa(*a, meta=jmeta), jnp.asarray(wts)),
                  argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    tg = torch.autograd.grad(loss(t_flash(tq, tk, tv, tbits), torch.as_tensor(wts)),
                             (tq, tk, tv))
    for a, x, t in zip(jg, jx, tg):
        np.testing.assert_allclose(t.numpy(), np.asarray(a), atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(t.numpy(), np.asarray(x), atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# masking under JAX's draws
# ---------------------------------------------------------------------------

def _jax_draws(key, b, n, codebook_size=8192, dtype=jnp.int32, n_eval=0):
    """JAX's ``mask_or_random_replace_tokens`` draws as a port ``MaskDraws``."""
    k_t, k_choice, k_mask, k_replace, k_eval = jax.random.split(key, 5)

    def t(a):
        return torch.as_tensor(np.array(a))
    return TMK.MaskDraws(
        timesteps=t(jax.random.uniform(k_t, (b,))), scores=t(jax.random.uniform(k_mask, (b, n))),
        replace=t(jax.random.randint(k_replace, (b, n), 0, codebook_size, dtype=dtype)),
        choice=t(jax.random.uniform(k_choice, ())),
        rect=t(jnp.stack([jax.random.uniform(kk, (b,)) for kk in jax.random.split(k_mask, 3)])),
        eval_idx=t(jax.random.randint(k_eval, (b,), 0, n_eval)) if n_eval else None)


MASKING_CASES = {
    "counts_and_labels": (0, np.arange(4 * 256).reshape(4, 256) % 8192, 8192, {}),
    "min_masking_rate": (1, np.zeros((8, 64), np.int32), 99, {"min_masking_rate": 0.4}),
    "contiguous": (2, np.zeros((4, 256), np.int32), 99, {"mask_contiguous_region_prob": 1.0}),
    "random_replace": (3, np.full((2, 64), 5000, np.int32), 8192,
                       {"noise_type": "random_replace", "codebook_size": 8192}),
    "predict_all": (4, np.zeros((2, 16), np.int32), 99, {"predict_all_tokens": True}),
    "eval_ratios": (5, np.zeros((16, 64), np.int32), 99,
                    {"eval_mask_ratios": [0.25, 0.5], "is_train": False}),
}


@pytest.mark.parametrize("case", sorted(MASKING_CASES))
def test_masking_matches_jax_draws(case):
    """tests/test_masking.py's six cases, token-exact under JAX's draws."""
    seed, tokens, mask_id, kw = MASKING_CASES[case]
    key = jax.random.key(seed)
    tokens = tokens.astype(np.int32)
    j = JMK.mask_or_random_replace_tokens(key, jnp.asarray(tokens), mask_id,
                                          JS.cosine_schedule, **kw)
    draws = _jax_draws(key, *tokens.shape, codebook_size=kw.get("codebook_size", 8192),
                       n_eval=len(kw.get("eval_mask_ratios", ())))
    t = TMK.mask_or_random_replace_tokens(draws, torch.as_tensor(tokens), mask_id,
                                          TS.cosine_schedule, **kw)
    np.testing.assert_array_equal(t.input_ids.numpy(), np.asarray(j.input_ids))
    np.testing.assert_array_equal(t.labels.numpy(), np.asarray(j.labels))
    np.testing.assert_array_equal(t.mask_prob.numpy(), np.asarray(j.mask_prob))
    assert (t.loss_weight is None) == (j.loss_weight is None)
    if j.loss_weight is not None:
        np.testing.assert_allclose(t.loss_weight.numpy(), np.asarray(j.loss_weight), rtol=1e-6)
    # the port's own draws from a generator: the JAX test's invariants
    gen = torch.Generator().manual_seed(seed)
    own = TMK.mask_or_random_replace_tokens(gen, torch.as_tensor(tokens), mask_id,
                                            TS.cosine_schedule, **kw)
    if case in ("counts_and_labels", "min_masking_rate"):
        masked = own.input_ids.numpy() == mask_id
        want = np.clip(np.round(tokens.shape[1] * own.mask_prob.numpy()), 1, None)
        np.testing.assert_array_equal(masked.sum(-1), want)
        assert ((own.labels.numpy() == -100) == ~masked).all()


# ---------------------------------------------------------------------------
# prompting: t2i and lm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dropout", [0.0, 0.5])
def test_t2i_and_lm_prompts_match_jax(dropout):
    """Token-exact ids, attention masks and labels with the byte tokenizer,
    the conditioning dropout drawn from the same numpy seed."""
    def engines(mod, tok, prompting):
        return prompting(tok, special_tokens=mod.TRAIN_SPECIAL_TOKENS, max_seq_len=48,
                         cond_dropout_prob=dropout, rng=np.random.default_rng(3))
    jp = engines(JL, JL.FallbackTokenizer(), JPrompting)
    tp = engines(TL, TL.FallbackTokenizer(), TPrompting)
    texts = ["a red cat", "dog", "a very long caption " * 4, ""]
    img = np.random.default_rng(0).integers(151700, 151740, size=(4, 16))
    for _ in range(3):
        for a, b in zip(jp((texts, img, img + 1), "t2i"), tp((texts, img, img + 1), "t2i")):
            np.testing.assert_array_equal(b, a)
    for a, b in zip(jp((texts, 20), "lm"), tp((texts, 20), "lm")):
        np.testing.assert_array_equal(b, a)
    for a, b in zip(jp((img, np.arange(20)[None].repeat(4, 0) + 3, None, None), "mmu_conv"),
                    tp((img, np.arange(20)[None].repeat(4, 0) + 3, None, None), "mmu_conv")):
        np.testing.assert_array_equal(b, a)


# ---------------------------------------------------------------------------
# schedules, optimizer, EMA
# ---------------------------------------------------------------------------

SCHEDULES = {
    "constant": {},
    "constant_with_warmup": {"num_warmup_steps": 10},
    "linear": {"num_warmup_steps": 10, "num_training_steps": 100},
    "cosine": {"num_warmup_steps": 10, "num_training_steps": 100, "min_scale": 0.1},
    "cosine_with_restarts": {"num_warmup_steps": 10, "num_training_steps": 100,
                             "num_cycles": 3},
    "polynomial": {"num_warmup_steps": 5, "num_training_steps": 100, "lr_init": 1e-3,
                   "power": 2.0},
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_lr_schedules_match_jax(name):
    js = JLRS.get_scheduler(name, **SCHEDULES[name])
    ts = TLRS.get_scheduler(name, **SCHEDULES[name])
    for step in range(121):
        assert abs(float(ts(step)) - float(js(step))) < 1e-7, (name, step)
    assert abs(float(ts(torch.tensor(37, dtype=torch.int32))) - float(js(37))) < 1e-7


def test_lr_schedules_match_reference_formulas():
    """tests/test_training.py's formula checks, on the port."""
    import math
    s = TLRS.get_scheduler("cosine", num_warmup_steps=10, num_training_steps=100,
                           min_scale=0.1)
    assert abs(float(s(5)) - 0.5) < 1e-6
    prog = (55 - 10) / 90
    want = max(0.1, 0.1 + 0.5 * 0.9 * (1 + math.cos(math.pi * prog)))
    assert abs(float(s(55)) - want) < 1e-6
    lin = TLRS.get_scheduler("linear", num_warmup_steps=0, num_training_steps=100)
    assert abs(float(lin(50)) - 0.5) < 1e-6
    poly = TLRS.get_scheduler("polynomial", num_warmup_steps=0, num_training_steps=10,
                              lr_init=1e-3, lr_end=1e-7)
    assert float(poly(20)) == pytest.approx(1e-7 / 1e-3)
    with pytest.raises(ValueError):
        TLRS.get_scheduler("cosine")


def _jax_value(tree, jpath):
    for k in jpath.split("/"):
        tree = tree[int(k)] if isinstance(tree, list) else tree[k]
    return tree


def test_decay_trainable_and_lr_masks_match_jax():
    jcfg, jparams, tcfg, tparams = _models(w_und_encoder=True, gen_proj_depth=2)
    mapper = {"mm_projector": 2.0, "layers": 0.5}
    for tunable in (None, ["mm_projector"], ["mm_projector", "llm"]):
        jt = JO.trainable_mask(jparams, tunable)
        for path, want in TO.trainable_mask(tparams, tunable).items():
            assert want is _jax_value(jt, W.jax_leaf_path(path)), (tunable, path)
    jd, jm = JO.decay_mask(jparams), JO.lr_multiplier_mask(jparams, mapper)
    for path, want in TO.decay_mask(tparams).items():
        assert want is _jax_value(jd, W.jax_leaf_path(path)), path
    for path, want in TO.lr_multiplier_mask(tparams, mapper).items():
        assert want == _jax_value(jm, W.jax_leaf_path(path)), path
    # tests/test_training.py::test_decay_and_trainable_masks' own checks
    dm = TO.decay_mask(tparams)
    assert dm["llm/embed"] is False and dm["llm/final_ln"] is False
    assert dm["llm/layers/0/q_w"] is True and dm["llm/layers/1/q_b"] is False
    tm = TO.trainable_mask(tparams, ["mm_projector"])
    assert tm["mm_projector/0/w"] is True and tm["llm/embed"] is False


@pytest.mark.parametrize("steps", [1, 3])
def test_optimizer_matches_optax_chain(steps):
    """Clip, Adam, decay on the decay mask, lr_mapper, the schedule and
    frozen parts against optax on the same fp32 tree and gradients."""
    jcfg, jparams, tcfg, tparams = _models(w_und_encoder=True)
    kw = dict(max_grad_norm=0.5, weight_decay=0.1, tunable_parts=["mm_projector", "layers"],
              lr_mapper={"mm_projector": 3.0})
    sched = dict(num_warmup_steps=2, num_training_steps=20)
    jtx = JO.make_optimizer(jparams, 1e-2, JLRS.get_scheduler("cosine", **sched), **kw)
    ttx = TO.make_optimizer(tparams, 1e-2, TLRS.get_scheduler("cosine", **sched), **kw)
    jstate = jtx.init(jparams)
    leaves = [t.clone() for _, t in TO.named_leaves(tparams)]
    tstate = ttx.init(leaves)
    rng = np.random.default_rng(1)
    for _ in range(steps):
        jg = jax.tree.map(lambda a: jnp.asarray(rng.normal(size=a.shape), a.dtype), jparams)
        tg = W.unigen_from_jax(jax.tree.map(np.asarray, jg), tcfg)
        upd, jstate = jtx.update(jg, jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        tstate = ttx.update([g for _, g in TO.named_leaves(tg)], tstate, leaves)
    assert int(tstate.count) == steps
    tree = _tree_from_leaves(tparams, leaves)
    errs = _leaf_errors(jparams, W.unigen_to_jax(tree, tcfg))
    assert max(errs.values()) < 1e-6, {k: v for k, v in errs.items() if v >= 1e-6}


def _tree_from_leaves(like, leaves):
    it = iter(leaves)

    def rebuild(tree):
        if isinstance(tree, dict):
            return {k: rebuild(tree[k]) for k in sorted(tree)}
        if isinstance(tree, list):
            return [rebuild(v) for v in tree]
        return next(it)
    return rebuild(like)


def test_ema_matches_jax():
    rng = np.random.default_rng(2)
    p0 = {"w": rng.normal(size=(3, 4)).astype(np.float32), "b": [np.zeros(5, np.float32)]}
    cfg_kw = dict(decay=0.999, update_after_step=1)
    jstate = JE.ema_init(jax.tree.map(jnp.asarray, p0))
    tstate = TE.ema_init(jax.tree.map(torch.as_tensor, p0))
    for i in range(6):
        target = jax.tree.map(lambda a: a + rng.normal(size=a.shape).astype(np.float32), p0)
        jstate = JE.ema_update(JE.EMAConfig(**cfg_kw), jstate, jax.tree.map(jnp.asarray, target))
        tstate = TE.ema_update(TE.EMAConfig(**cfg_kw), tstate,
                               jax.tree.map(torch.as_tensor, target))
        for step in (0, 1, 2, 50):
            assert abs(float(TE.ema_decay_at(TE.EMAConfig(**cfg_kw), step))
                       - float(JE.ema_decay_at(JE.EMAConfig(**cfg_kw), step))) < 1e-7
    np.testing.assert_allclose(tstate.params["w"].numpy(), np.asarray(jstate.params["w"]),
                               atol=1e-7)
    np.testing.assert_allclose(tstate.params["b"][0].numpy(),
                               np.asarray(jstate.params["b"][0]), atol=1e-7)
    assert int(tstate.step) == int(jstate.step) == 6


def test_ema_update_moves_toward_params():
    cfg = TE.EMAConfig(decay=0.9, use_ema_warmup=False)
    state = TE.ema_init({"w": torch.zeros(3)})
    for _ in range(20):
        state = TE.ema_update(cfg, state, {"w": torch.ones(3)})
    assert 0.5 < float(state.params["w"][0]) <= 1.0


# ---------------------------------------------------------------------------
# unigen.forward: losses and gradients
# ---------------------------------------------------------------------------

def _forward_batch(cfg, bt, bl, bm, L=24, gen=False):
    rng = np.random.default_rng(1)
    ids = rng.integers(0, cfg.text_vocab_len - 20, size=(bt + bl + bm, L))
    labels = rng.integers(0, cfg.text_vocab_len - 20, size=(bt + bl + bm, L))
    labels[labels % 3 == 0] = -100
    if gen:
        n = cfg.num_vq_tokens
        r9 = np.random.default_rng(9)
        ids[:bt, -(n + 1):-1] = r9.integers(0, cfg.codebook_size, (bt, n))
        labels[:bt, -(n + 1):-1] = r9.integers(0, cfg.codebook_size, (bt, n))
    return ids, labels


FORWARD_CASES = {
    "dense_mask": (dict(), (2, 1, 2), dict()),
    "chunked_mask": (dict(), (2, 1, 2), dict(memory_efficient_loss=True)),
    "dense_ar": (dict(), (2, 1, 1), dict(t2i_mode="ar")),
    "chunked_ar": (dict(), (2, 1, 1), dict(t2i_mode="ar", memory_efficient_loss=True)),
    "gen_projector": (dict(gen_proj_depth=2), (2, 0, 1), dict()),
    "remat_omni_mask": (dict(), (2, 1, 2), dict(remat=True, memory_efficient_loss=True)),
}


@pytest.mark.parametrize("case", sorted(FORWARD_CASES))
def test_unigen_forward_losses_and_grads_match_jax(case):
    """The three losses (1e-5) and the parameter gradients of their weighted
    sum (1e-4 of each leaf's largest gradient) against ``jax.grad``."""
    model_kw, (bt, bl, bm), fwd_kw = FORWARD_CASES[case]
    jcfg, jparams, tcfg, tparams = _models(**model_kw)
    ids, labels = _forward_batch(jcfg, bt, bl, bm, gen="gen_proj_depth" in model_kw)
    jkw, tkw = dict(fwd_kw), dict(fwd_kw)
    if case == "remat_omni_mask":
        jkw["attention_mask"] = JM.create_attention_mask_predict_next(
            jnp.asarray(ids), 0, 1, 2, rm_pad_in_image=True)
        tkw["attention_mask"] = TM.create_attention_mask_predict_next(
            torch.as_tensor(ids), 0, 1, 2, rm_pad_in_image=True)

    def jloss(p):
        _, lt, ll, lm = JU.forward(p, jcfg, input_ids=jnp.asarray(ids),
                                   labels=jnp.asarray(labels), batch_size_t2i=bt,
                                   batch_size_lm=bl, batch_size_mmu=bm, **jkw)
        return lt + 0.1 * ll + lm, (lt, ll, lm)

    (_, jl), jg = jax.value_and_grad(jloss, has_aux=True)(jparams)
    tp = _trainable(tparams)
    logits, lt, ll, lm = TU.forward(tp, tcfg, input_ids=torch.as_tensor(ids),
                                    labels=torch.as_tensor(labels), batch_size_t2i=bt,
                                    batch_size_lm=bl, batch_size_mmu=bm, **tkw)
    assert (logits is None) == bool(fwd_kw.get("memory_efficient_loss"))
    for a, b in zip(jl, (lt, ll, lm)):
        np.testing.assert_allclose(float(b.detach()), float(a), rtol=1e-5, atol=1e-6)
    grads = W.unigen_to_jax(_grad_tree(tp, lt + 0.1 * ll + lm), tcfg)
    for path, a in jax.tree_util.tree_leaves_with_path(jg):
        b = grads
        for p in path:
            b = b[getattr(p, "key", getattr(p, "idx", None))]
        a = np.asarray(a)
        np.testing.assert_allclose(b.numpy(), a, rtol=0, atol=1e-4 * max(np.abs(a).max(), 1e-6),
                                   err_msg=jax.tree_util.keystr(path))


def test_cross_entropy_matches_torch():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(4, 7, 11)).astype(np.float32)
    labels = rng.integers(0, 11, size=(4, 7))
    labels[0, :3] = -100
    labels[2] = -100
    ref = torch.nn.functional.cross_entropy(torch.tensor(logits).reshape(-1, 11),
                                            torch.tensor(labels).reshape(-1), ignore_index=-100)
    ours = TU._cross_entropy(torch.tensor(logits), torch.tensor(labels))
    assert abs(float(ours) - float(ref)) < 1e-5
    w = torch.tensor(rng.normal(size=(11, 5)).astype(np.float32))
    h = torch.tensor(rng.normal(size=(4, 7, 5)).astype(np.float32))
    dense = TU._cross_entropy(h @ w.T, torch.tensor(labels))
    chunked = TU._chunked_ce(h, w, torch.tensor(labels), chunk=3)
    assert abs(float(dense) - float(chunked)) < 1e-6


def test_training_masks_match_jax():
    rng = np.random.default_rng(4)
    ids = rng.integers(3, 50, size=(3, 20))
    ids[:, 2], ids[:, 9] = 1, 2
    ids[0, 15:], ids[1, 12:] = 0, 0
    j = JM.mmu_attn_meta(jnp.asarray(ids), 0, 1, 2)
    t = TM.mmu_train_attn_meta(torch.as_tensor(ids), 0, 1, 2)
    for a, b in zip(j[:3], t[:3]):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    lm = TM.lm_attn_meta(torch.as_tensor(ids), 0)
    cat = TM.concat_meta(t, lm._replace(seg=torch.ones((3, 20), dtype=torch.int32)))
    jcat = JM.concat_meta(j, JM.lm_attn_meta(jnp.asarray(ids), 0)._replace(
        seg=jnp.ones((3, 20), jnp.int32)))
    for a, b in zip(jcat, cat):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    np.testing.assert_array_equal(TM.create_attention_mask_for_mmu(torch.as_tensor(ids), 2).numpy(),
                                  np.asarray(JM.create_attention_mask_for_mmu(jnp.asarray(ids), 2)))
    keep = (ids != 0).astype(np.int32)
    np.testing.assert_array_equal(TM.causal_mask_from_attention(torch.as_tensor(keep)).numpy(),
                                  np.asarray(JM.causal_mask_from_attention(jnp.asarray(keep))))


# ---------------------------------------------------------------------------
# the whole step (tests/test_training.py::_tiny_setup's shapes)
# ---------------------------------------------------------------------------

def _step_setup(bt=2, bl=2, bm=2, accum=1, b_mult=1):
    jcfg, jparams, tcfg, tparams = _models()
    jvq = JMV.MagvitConfig.tiny(z_channels=5, resolution=8)
    tvq = TMV.MagvitConfig.tiny(z_channels=5, resolution=8)
    vq_tree = jax.tree.map(np.asarray, JMV.init(jax.random.key(1), jvq))
    n, L = jcfg.num_vq_tokens, 28
    rng = np.random.default_rng(0)
    bt_, bl_, bm_ = bt * b_mult, bl * b_mult, bm * b_mult
    t2i_template = rng.integers(3, 100, size=(bt_, L))
    t2i_template[:, -n - 2] = 1
    t2i_template[:, -1] = 2
    t2i_template[:, -n - 1:-1] = 0
    t2i_template[0, :3] = 0                               # left pads in one row
    mmu_template = rng.integers(3, 100, size=(bm_, L))
    mmu_template[:, 2] = 1
    mmu_template[:, 3 + n] = 2
    mmu_template[:, 3:3 + n] = 0
    mmu_template[0, -2:] = 0                              # right pads in one row
    mmu_labels = np.where(rng.random((bm_, L)) < 0.5, rng.integers(3, 100, (bm_, L)), -100)
    mmu_labels[:, :4 + n] = -100
    lm_ids = rng.integers(3, 100, size=(bl_, L))
    batch = {"t2i_template": t2i_template, "t2i_labels": np.full((bt_, L), -100),
             "t2i_pixels": rng.normal(size=(bt_, 8, 8, 3)).astype(np.float32),
             "lm_ids": lm_ids, "lm_labels": lm_ids.copy(),
             "mmu_template": mmu_template, "mmu_labels": mmu_labels,
             "mmu_pixels": rng.normal(size=(bm_, 8, 8, 3)).astype(np.float32)}
    kw = dict(batch_size_t2i=bt, batch_size_lm=bl, batch_size_mmu=bm, grad_accum_steps=accum,
              max_grad_norm=1.0)
    jtx = JO.make_optimizer(jparams, 1e-3, JLRS.get_scheduler(
        "cosine", num_warmup_steps=2, num_training_steps=50), max_grad_norm=1.0)
    ttx = TO.make_optimizer(tparams, 1e-3, TLRS.get_scheduler(
        "cosine", num_warmup_steps=2, num_training_steps=50), max_grad_norm=1.0)
    j = dict(cfg=jcfg, params=jparams, vq=jax.tree.map(jnp.asarray, vq_tree), tx=jtx,
             batch={k: jnp.asarray(v) for k, v in batch.items()},
             flash=jax.jit(JT.make_train_step(jcfg, jvq, jtx, JT.TrainStepConfig(
                 use_flash_attention=True, **kw))),
             dense=jax.jit(JT.make_train_step(jcfg, jvq, jtx, JT.TrainStepConfig(**kw))))
    t = dict(cfg=tcfg, params=tparams, vq=W.magvit_from_jax(vq_tree, tvq), tx=ttx,
             batch={k: torch.as_tensor(v) for k, v in batch.items()},
             step=TT.make_train_step(tcfg, tvq, ttx, TT.TrainStepConfig(**kw)))
    return j, t


def _step_draws(key, accum, bt):
    if accum == 1:
        return _jax_draws(key, bt, 16)
    return [_jax_draws(k, bt, 16) for k in jax.random.split(key, accum)]


@pytest.fixture(scope="module")
def step_setup():
    return _step_setup()


def test_train_step_matches_jax(step_setup):
    """Losses against JAX's step with the flash kernel (1e-5) and with its
    dense default (rtol 1e-4), and the updated parameters after 1 and 3
    steps (1e-5 of each leaf's largest magnitude), under JAX's draws."""
    j, t = step_setup
    jstate, jdense = JT.init_train_state(j["params"], j["tx"]), None
    tstate = TT.init_train_state(t["params"], t["tx"])
    for i in range(3):
        key = jax.random.key(i)
        _, md = j["dense"](jstate, j["vq"], j["batch"], key)
        jstate, mf = j["flash"](jstate, j["vq"], j["batch"], key)
        tstate, mt = t["step"](tstate, t["vq"], t["batch"], _step_draws(key, 1, 2))
        for k in TT.METRICS + ("grad_norm",):
            np.testing.assert_allclose(float(mt[k]), float(mf[k]), rtol=1e-5, atol=1e-6,
                                       err_msg=k)
            np.testing.assert_allclose(float(mt[k]), float(md[k]), rtol=1e-4, atol=1e-5,
                                       err_msg=k)
        if i in (0, 2):
            errs = _leaf_errors(jstate.params, W.unigen_to_jax(tstate.params, t["cfg"]))
            assert max(errs.values()) < 1e-5, {k: v for k, v in errs.items() if v >= 1e-5}
    assert int(tstate.step) == 3 and int(tstate.opt_state.count) == 3
    # the caller's tree is left as it was (the state holds a copy)
    assert torch.equal(t["params"]["llm"]["embed"],
                       W.unigen_from_jax(jax.tree.map(np.asarray, j["params"]),
                                         t["cfg"])["llm"]["embed"])


def test_train_step_loss_decreases(step_setup):
    _, t = step_setup
    state = TT.init_train_state(t["params"], t["tx"])
    gen = torch.Generator().manual_seed(0)
    losses = []
    for _ in range(6):
        state, m = t["step"](state, t["vq"], t["batch"], gen)
        losses.append(float(m["loss"]))
        assert np.isfinite(losses[-1])
    assert losses[-1] < losses[0]
    assert int(state.step) == 6


def test_grad_accum_matches_jax_and_halves():
    """accum=2 over a doubled batch: JAX's accumulated step (its split keys'
    draws), and the mean of the two halves' gradients."""
    j, t = _step_setup(accum=2, b_mult=2)
    key = jax.random.key(5)
    draws = _step_draws(key, 2, 2)
    jstate, jm = jax.jit(JT.make_train_step(
        j["cfg"], JMV.MagvitConfig.tiny(z_channels=5, resolution=8), j["tx"],
        JT.TrainStepConfig(batch_size_t2i=2, batch_size_lm=2, batch_size_mmu=2,
                           grad_accum_steps=2, max_grad_norm=1.0,
                           use_flash_attention=True)))(
        JT.init_train_state(j["params"], j["tx"]), j["vq"], j["batch"], key)
    tstate = TT.init_train_state(t["params"], t["tx"])
    grads, metrics = t["step"].loss_and_grads(tstate.params, t["vq"], t["batch"], draws)
    halves = TT.make_train_step(t["cfg"], t["step"].vq_cfg, t["tx"],
                                dataclasses.replace(t["step"].tcfg, grad_accum_steps=1))
    parts = [halves.loss_and_grads(tstate.params, t["vq"],
                                   {k: v.reshape(2, v.shape[0] // 2, *v.shape[1:])[i]
                                    for k, v in t["batch"].items()}, draws[i])
             for i in range(2)]
    for g, g0, g1 in zip(grads, parts[0][0], parts[1][0]):
        torch.testing.assert_close(g, (g0 + g1) / 2, rtol=1e-6, atol=1e-7)
    for k in TT.METRICS:
        assert abs(float(metrics[k]) - (float(parts[0][1][k]) + float(parts[1][1][k])) / 2) < 1e-6
    tstate, tm = t["step"](tstate, t["vq"], t["batch"], draws)
    for k in TT.METRICS + ("grad_norm",):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, atol=1e-6, err_msg=k)
    errs = _leaf_errors(jstate.params, W.unigen_to_jax(tstate.params, t["cfg"]))
    assert max(errs.values()) < 1e-5
    assert int(tstate.step) == 1
