"""The port's int8 inference (W8A8 layers and heads, the int8 SigLIP tower, the
int8 KV cache) against the JAX package, on the CPU in fp32.

* ``quantize_dense`` and ``_kv_quantize`` are bit-identical to JAX's (the
  shared ``quantize_activations`` is held so in tests/test_torch_w4a8_fused.py);
  the port's W8A8 leaf is JAX's transposed, with its rows padded with zeros
  to a multiple of 8;
* ``dense_int8`` agrees with JAX's within 1e-6 of the output's largest
  magnitude: the int32 product is exact in both, and only XLA:CPU's rounding
  of the fp32 epilogue may differ from the port's one operation at a time
  (as for W4A8, tests/test_torch_int4.py);
* a tree that JAX quantized loads through ``weights.py`` and equals the
  port's own quantization of the same float weights, leaf for leaf;
* the tiny W8A8 backbone gives JAX's hidden states within 1e-5 at the
  prefill and at one cached decode step, token by token. As with W4A8, fp32
  sums in another order can move an activation across an int8 rounding
  boundary and its whole token with it, so ``_match_but_flips`` allows one
  such token at a cosine of 0.999 (the allowance of ROADMAP Queue 3);
* the int8 text head's logits with and without ``vocab_slice``, the int8
  SigLIP features, and the int8 KV cache's prefill (the flash path on the
  dequantized chunk) and decode step (``dot_product_attention_q8`` with the
  per-row key mask) agree with JAX's within 1e-5;
* t2i codes on ``img_head_q`` under shared noise (both ``cfg_combine``
  modes, the tied and the gen-projector head) and the greedy tokens of
  ``mmu_generate`` / ``understand`` with ``quantized_cache=True`` are exact;
* JAX's own int8 quality gates (tests/test_quantization.py), run on the
  port: one t2i step at the flagship widths agrees with fp32 on >= 85% of
  the tokens, 50 bf16 steps on >= 50%, and the int8 text head keeps >= 70%
  of the greedy argmaxes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unigen_tpu.generation import decode as JD
from unigen_tpu.generation import t2i_generate as j_t2i
from unigen_tpu.models import magvit as JMV
from unigen_tpu.models import qwen2 as JQ
from unigen_tpu.models import siglip as JS
from unigen_tpu.models import unigen as JU
from unigen_tpu.ops import attention as JA
from unigen_tpu.ops import masks as JM
from unigen_tpu.ops import quantization as JQZ
from unigen_tpu.pipeline import UniGenPipeline as JPipeline
from unigen_tpu.prompting import UniPrompting as JPrompting
from unigen_tpu_torch import weights as W
from unigen_tpu_torch.generation import decode as TD
from unigen_tpu_torch.generation import t2i as TT
from unigen_tpu_torch.generation import t2i_generate as t_t2i
from unigen_tpu_torch.launch import build_pipeline
from unigen_tpu_torch.models import qwen2 as TQ
from unigen_tpu_torch.models import siglip as TS
from unigen_tpu_torch.models import unigen as TU
from unigen_tpu_torch.ops import attention as TA
from unigen_tpu_torch.ops import masks as TM
from unigen_tpu_torch.ops import quantization as TQZ
from unigen_tpu_torch.pipeline import UniGenPipeline as TPipeline
from unigen_tpu_torch.prompting import UniPrompting as TPrompting

from test_pipeline import DecodableMockTokenizer
from test_prompting import SPECIALS
from test_torch_int4 import _match_but_flips
from test_torch_qwen2 import _perturb

PAD, SOI, EOI = 0, 1, 2


def _np(t):
    return np.asarray(t)


def _leaf_equals_jax(ours, theirs):
    """The port's W8A8 leaf against JAX's: [Npad, K] = JAX's [K, N] transposed
    and padded with zero rows; scale and bias equal."""
    w = ours["kernel_int8"].numpy()
    n = _np(theirs["kernel_int8"]).shape[1]
    assert w.shape[0] % 8 == 0 and w.shape[0] - n < 8 and not w[n:].any()
    np.testing.assert_array_equal(w[:n].T, _np(theirs["kernel_int8"]))
    np.testing.assert_array_equal(ours["scale"].numpy(), _np(theirs["scale"]))
    assert ("bias" in ours) == ("bias" in theirs)
    if "bias" in ours:
        np.testing.assert_array_equal(ours["bias"].numpy(), _np(theirs["bias"]))


# ---------------------------------------------------------------------------
# the quantizers and the dense layer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k,n,bias", [(64, 32, True), (128, 161, False), (96, 5, True)])
def test_quantize_dense_bit_identical(k, n, bias):
    rng = np.random.default_rng(0)
    w = rng.normal(size=(k, n)).astype(np.float32)
    w[:, 1] = 0.0                                      # an all-zero channel: scale floor
    p = {"kernel": w}
    if bias:
        p["bias"] = rng.normal(size=(n,)).astype(np.float32)
    want = JQZ.quantize_dense({a: jnp.asarray(v) for a, v in p.items()})
    got = TQZ.quantize_dense({a: torch.from_numpy(v) for a, v in p.items()})
    assert got["kernel_int8"].dtype == torch.int8 and got["kernel_int8"].is_contiguous()
    _leaf_equals_jax(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kv_quantize_bit_identical(dtype):
    x = np.random.default_rng(2).normal(size=(2, 7, 2, 16)).astype(np.float32) * 2
    x[0, 3] = 0.0                                      # zero heads: scale floor
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    jq, js = JQ._kv_quantize(jnp.asarray(xt.float().numpy(), getattr(jnp, dtype)))
    tq, ts = TQ._kv_quantize(xt)
    assert tq.dtype == torch.int8 and ts.shape == (2, 7, 2)
    np.testing.assert_array_equal(tq.numpy(), _np(jq))
    np.testing.assert_array_equal(ts.numpy(), _np(js))
    np.testing.assert_array_equal(
        TQ._kv_dequantize(tq, ts, torch.float32).numpy(),
        _np(JQ._kv_dequantize(jq, js, jnp.float32)))


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("lead", [(6,), (3, 7)])
def test_dense_int8_matches_jax(bias, lead):
    rng = np.random.default_rng(4)
    p = {"kernel": rng.normal(size=(128, 100)).astype(np.float32) * 0.05}
    if bias:
        p["bias"] = rng.normal(size=(100,)).astype(np.float32) * 0.01
    x = rng.normal(size=(*lead, 128)).astype(np.float32)
    want = _np(JQZ.dense_int8(JQZ.quantize_dense({a: jnp.asarray(v) for a, v in p.items()}),
                              jnp.asarray(x)))
    tp = TQZ.quantize_dense({a: torch.from_numpy(v) for a, v in p.items()})
    got = TQZ.dense_int8(tp, torch.from_numpy(x))
    assert got.shape == (*lead, 100) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6 * np.abs(want).max(), rtol=0)
    # the plain epilogue is the CPU path, and counts no launch
    before = TQZ.w8a8_epilogue.launches
    x8, xs = TQZ.quantize_activations(torch.from_numpy(x))
    assert torch.equal(TQZ.dense_int8_prequant(tp, x8, xs, torch.float32),
                       TQZ.dense_int8_prequant_plain(tp, x8, xs, torch.float32))
    assert TQZ.w8a8_epilogue.launches == before


def test_q8_attention_matches_jax():
    rng = np.random.default_rng(5)
    q = rng.normal(size=(2, 3, 4, 16)).astype(np.float32)
    kq = rng.integers(-127, 128, size=(2, 9, 2, 16)).astype(np.int8)
    vq = rng.integers(-127, 128, size=(2, 9, 2, 16)).astype(np.int8)
    ks, vs = (rng.random((2, 9, 2)).astype(np.float32) * 0.02 for _ in range(2))
    mask = rng.random((2, 1, 3, 9)) > 0.3
    mask[0, 0, 1] = False                              # a fully masked row
    want = _np(JA.dot_product_attention_q8(*map(jnp.asarray, (q, kq, ks, vq, vs)),
                                           mask=jnp.asarray(mask)))
    got = TA.dot_product_attention_q8(*map(torch.from_numpy, (q, kq, ks, vq, vs)),
                                      mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# the W8A8 backbone, its heads, the tower
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def model():
    jcfg = JU.UniGenConfig.tiny()
    tree = _perturb(jax.tree.map(np.asarray, JU.init(jax.random.key(0), jcfg)),
                    np.random.default_rng(0))
    jfloat = jax.tree.map(jnp.asarray, tree)
    jq = JQZ.quantize_unigen_params(jfloat, jcfg, lm_head=True)
    tcfg = TU.UniGenConfig.tiny()
    tq = W.unigen_from_jax(jax.tree.map(np.asarray, jq), tcfg)
    return jcfg, jfloat, jq, tcfg, W.unigen_from_jax(tree, tcfg), tq


def test_jax_int8_tree_loads_and_equals_ours(model):
    jcfg, _, jq, tcfg, tfloat, tq = model
    jl = jq["llm"]["layers"]
    ours = TQZ.quantize_unigen_params(tfloat, tcfg, lm_head=True)
    for i, (a, b) in enumerate(zip(ours["llm"]["layers"], tq["llm"]["layers"])):
        assert "q_w" not in b and "down_b" not in b
        for name, group in (("q", "attn"), ("k", "attn"), ("v", "attn"), ("o", "attn"),
                            ("gate", "mlp"), ("up", "mlp"), ("down", "mlp")):
            _leaf_equals_jax(b[name], jax.tree.map(lambda x: x[i], jl[group][name]))
            for leaf in b[name]:
                assert torch.equal(a[name][leaf], b[name][leaf]), (name, leaf)
    for ours_leaf, theirs in ((ours["llm"]["lm_head_q"], jq["llm"]["lm_head_q"]),
                              (ours["img_head_q"], jq["img_head_q"])):
        _leaf_equals_jax(ours_leaf, theirs)
    _leaf_equals_jax(tq["llm"]["lm_head_q"], jq["llm"]["lm_head_q"])
    _leaf_equals_jax(tq["img_head_q"], jq["img_head_q"])
    assert tq["llm"]["lm_head_q"]["kernel_int8"].shape == (168, tcfg.llm.hidden_size)  # 161


def test_w8a8_backbone_prefill_and_decode_step_match_jax(model):
    jcfg, _, jq, tcfg, _, tq = model
    rb, lp, total = 3, 9, 12
    ids = np.random.default_rng(5).integers(3, 100, size=(rb, lp))
    pos = np.arange(lp)
    pm = np.broadcast_to((pos[:, None] >= pos[None, :])[None, None], (rb, 1, lp, lp))
    pm = np.concatenate([pm, np.zeros((rb, 1, lp, total - lp), bool)], axis=-1)
    jh, jc = JQ.forward(jq["llm"], jcfg.llm, input_ids=jnp.asarray(ids), mask=jnp.asarray(pm),
                        cache=JQ.init_kv_cache(jcfg.llm, rb, total))
    tids = torch.from_numpy(ids)
    th, tc = TQ.forward(tq["llm"], tcfg.llm, input_ids=tids,
                        meta_bits=TM.pack_meta(TM.lm_attn_meta(tids, None)),
                        cache=TQ.init_kv_cache(tcfg.llm, rb, total, torch.device("cpu")))
    _match_but_flips(th.numpy(), _np(jh), max_flipped=1)

    tok = np.array([[7], [8], [9]])
    valid = np.arange(total)[None].repeat(rb, 0) <= lp
    jh2, _ = JQ.forward(jq["llm"], jcfg.llm, input_ids=jnp.asarray(tok),
                        mask=jnp.asarray(valid[:, None, None, :]),
                        positions=jnp.full((rb, 1), lp), cache=jc)
    th2, _ = TQ.forward(tq["llm"], tcfg.llm, input_ids=torch.from_numpy(tok),
                        positions=torch.full((rb, 1), lp), cache=tc,
                        kv_rowmask=torch.from_numpy(valid))
    _match_but_flips(th2.numpy(), _np(jh2), max_flipped=1)


@pytest.mark.parametrize("vocab_slice", [None, (128, 160), (3, 157), (150, 161)])
def test_int8_head_logits_match_jax(model, vocab_slice):
    """The int8 text head, whole and sliced; (3, 157) and (150, 161) are not
    multiples of 8 wide, and the last runs into the padded rows."""
    jcfg, _, jq, tcfg, _, tq = model
    h = np.random.default_rng(6).normal(size=(2, 3, tcfg.llm.hidden_size)).astype(np.float32)
    want = _np(JQ.logits(jq["llm"], jcfg.llm, jnp.asarray(h), vocab_slice=vocab_slice))
    got = TQ.logits(tq["llm"], tcfg.llm, torch.from_numpy(h), vocab_slice=vocab_slice)
    width = tcfg.vocab_size if vocab_slice is None else vocab_slice[1] - vocab_slice[0]
    assert got.shape == (2, 3, width)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6 * np.abs(want).max(), rtol=0)


def test_int8_siglip_features_match_jax():
    jcfg, tcfg = JS.SiglipConfig.tiny(), TS.SiglipConfig.tiny()
    tree = _perturb(jax.tree.map(np.asarray, JS.init(jax.random.key(2), jcfg)),
                    np.random.default_rng(1))
    jq = JQZ.quantize_siglip_params(jax.tree.map(jnp.asarray, tree))
    tq = W.siglip_from_jax(jax.tree.map(np.asarray, jq), tcfg)
    ours = TQZ.quantize_siglip_params(W.siglip_from_jax(tree, tcfg))
    for a, b in zip(ours["layers"], tq["layers"]):
        for name in TQZ.SIGLIP_PROJECTIONS:
            assert f"{name}_w" not in b
            for leaf in b[name]:
                assert torch.equal(a[name][leaf], b[name][leaf])
    px = np.random.default_rng(3).uniform(-1, 1, size=(2, 28, 28, 3)).astype(np.float32)
    want = _np(JS.forward(jq, jcfg, jnp.asarray(px)))
    got = TS.forward(tq, tcfg, torch.from_numpy(px))
    assert got.shape == want.shape
    _match_but_flips(got.numpy(), want, max_flipped=1)


# ---------------------------------------------------------------------------
# the int8 KV cache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tree", ["float", "w8a8"])
def test_int8_cache_prefill_and_decode_step_match_jax(model, tree):
    """The prefill writes the quantized chunk and attends to it dequantized
    (flash path, pad bits); the decode step reads the int8 cache through
    ``dot_product_attention_q8`` with the per-row key mask. JAX runs both
    through ``dot_product_attention_q8`` with dense masks."""
    jcfg, jfloat, jq, tcfg, tfloat, tq = model
    jp, tp = (jfloat["llm"], tfloat["llm"]) if tree == "float" else (jq["llm"], tq["llm"])
    rb, lp, total = 3, 9, 12
    ids = np.random.default_rng(8).integers(3, 100, size=(rb, lp))
    pos = np.arange(lp)
    pm = np.broadcast_to((pos[:, None] >= pos[None, :])[None, None], (rb, 1, lp, lp))
    pm = np.concatenate([pm, np.zeros((rb, 1, lp, total - lp), bool)], axis=-1)
    jh, jc = JQ.forward(jp, jcfg.llm, input_ids=jnp.asarray(ids), mask=jnp.asarray(pm),
                        cache=JQ.init_kv_cache(jcfg.llm, rb, total, quantize=True))
    tids = torch.from_numpy(ids)
    tc0 = TQ.init_kv_cache(tcfg.llm, rb, total, torch.device("cpu"), quantize=True)
    assert tc0.quantized and tc0.k.dtype == torch.int8 and tc0.k_scale.shape == (2, rb, total, 2)
    th, tc = TQ.forward(tp, tcfg.llm, input_ids=tids,
                        meta_bits=TM.pack_meta(TM.lm_attn_meta(tids, None)), cache=tc0)
    _match_but_flips(th.numpy(), _np(jh), max_flipped=int(tree == "w8a8"))
    # the cache holds what JAX's holds (a token moved by a flip may move its slots)
    for a, b in ((tc.k, jc.k), (tc.v, jc.v)):
        assert (a.numpy() != _np(b)).mean() < 0.02
    tok = np.array([[7], [8], [9]])
    valid = np.arange(total)[None].repeat(rb, 0) <= lp
    jh2, _ = JQ.forward(jp, jcfg.llm, input_ids=jnp.asarray(tok),
                        mask=jnp.asarray(valid[:, None, None, :]),
                        positions=jnp.full((rb, 1), lp), cache=jc)
    th2, tc2 = TQ.forward(tp, tcfg.llm, input_ids=torch.from_numpy(tok),
                          positions=torch.full((rb, 1), lp), cache=tc,
                          kv_rowmask=torch.from_numpy(valid))
    assert tc2.index == lp + 1 and tc2.quantized
    _match_but_flips(th2.numpy(), _np(jh2), max_flipped=int(tree == "w8a8"))


B, L, NEW = 3, 10, 8
PROMPT_LEN = np.array([10, 7, 5])


@pytest.mark.parametrize("tree", ["float", "w8a8"])
def test_mmu_generate_quantized_cache_tokens_exact(model, tree):
    jcfg, jfloat, jq, tcfg, tfloat, tq = model
    jp, tp = (jfloat, tfloat) if tree == "float" else (jq, tq)
    ids = np.random.default_rng(1).integers(3, 150, size=(B, L))
    for i, n in enumerate(PROMPT_LEN):
        ids[i, n:] = 0
    keep = np.arange(L)[None] < PROMPT_LEN[:, None]
    mask = _np(JM.create_attention_mask_for_mmu_vit(B, L, num_tokens=3, prefix_length=2))
    mask = mask & keep[:, None, None, :] & keep[:, None, :, None]
    want = JD.mmu_generate(jp, jcfg, jax.random.key(0), input_ids=jnp.asarray(ids),
                           attention_mask=jnp.asarray(mask), prompt_len=jnp.asarray(PROMPT_LEN),
                           max_new_tokens=NEW, temperature=0.0, quantized_cache=True)
    plen = torch.from_numpy(PROMPT_LEN)
    meta = TM.pack_meta(TM.mmu_vit_attn_meta(B, L, num_tokens=3, prefix_length=2,
                                             prompt_len=plen))
    got = TD.mmu_generate(tp, tcfg, None, input_ids=torch.from_numpy(ids), meta_bits=meta,
                          prompt_len=plen, max_new_tokens=NEW, temperature=0.0,
                          quantized_cache=True)
    np.testing.assert_array_equal(got.numpy(), _np(want))


# ---------------------------------------------------------------------------
# t2i on the int8 image head
# ---------------------------------------------------------------------------

STEPS = 4


def _t2i_prompts(cfg, b=2):
    rng = np.random.default_rng(11)
    n = cfg.num_vq_tokens
    text = rng.integers(3, 100, size=(b, 6))
    ids = np.concatenate([np.zeros((b, 2), np.int64), text, np.full((b, 1), SOI),
                          np.full((b, n), cfg.mask_token_id), np.full((b, 1), EOI)], axis=1)
    ids[1, 2] = PAD
    uncond = np.roll(ids, 1, axis=0)
    uncond[:, 2:6] = PAD
    return ids, uncond


def _t2i_both(jcfg, jparams, tcfg, tparams, combine, cached=True):
    ids, uncond = _t2i_prompts(jcfg)
    rng = np.random.default_rng(5)
    u_s = rng.random((STEPS, 2, jcfg.num_vq_tokens, jcfg.codebook_size), dtype=np.float32)
    u_m = rng.random((STEPS, 2, jcfg.num_vq_tokens), dtype=np.float32)
    both = np.concatenate([ids, uncond])
    mask = JM.create_attention_mask_predict_next(jnp.asarray(both), PAD, SOI, EOI,
                                                 rm_pad_in_image=True)
    kw = dict(guidance_scale=2.0, timesteps=STEPS, temperature=1.0, reuse_prefix_cache=cached,
              pad_id=PAD, cfg_combine=combine)
    want = j_t2i(jparams, jcfg, jax.random.key(0), jnp.asarray(ids), mask,
                 uncond_input_ids=jnp.asarray(uncond), noise=(jnp.asarray(u_s), jnp.asarray(u_m)),
                 **kw)
    tmask = TM.create_attention_mask_predict_next(torch.from_numpy(both), PAD, SOI, EOI,
                                                  rm_pad_in_image=True)
    got = t_t2i(tparams, tcfg, None, torch.from_numpy(ids), tmask,
                uncond_input_ids=torch.from_numpy(uncond),
                noise=(torch.from_numpy(u_s), torch.from_numpy(u_m)), **kw)
    return got.numpy(), _np(want)


@pytest.mark.parametrize("cached", [True, False], ids=["prefix_cached", "full"])
@pytest.mark.parametrize("combine", ["hidden", "logits"])
def test_t2i_int8_codes_exact_vs_jax(model, combine, cached):
    jcfg, _, jq, tcfg, _, tq = model
    got, want = _t2i_both(jcfg, jq, tcfg, tq, combine, cached)
    assert got.shape == want.shape == (2, jcfg.num_vq_tokens)
    np.testing.assert_array_equal(got, want)


def test_t2i_int8_gen_projector_codes_exact_vs_jax():
    jcfg, tcfg = JU.UniGenConfig.tiny(gen_proj_depth=2), TU.UniGenConfig.tiny(gen_proj_depth=2)
    tree = jax.tree.map(np.asarray, JU.init(jax.random.key(0), jcfg))
    jq = JQZ.quantize_unigen_params(jax.tree.map(jnp.asarray, tree), jcfg)
    tq = W.unigen_from_jax(jax.tree.map(np.asarray, jq), tcfg)
    assert tq["img_head_q"]["kernel_int8"].shape == (tcfg.codebook_size, tcfg.llm.hidden_size)
    got, want = _t2i_both(jcfg, jq, tcfg, tq, "hidden")
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# the pipeline: understand and generate_text with the int8 tree and cache
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pipes():
    tok = DecodableMockTokenizer()
    jprompt = JPrompting(tok, special_tokens=SPECIALS, max_seq_len=64, cond_dropout_prob=0.0)
    cfg_kw = dict(text_vocab_len=len(tok), w_und_encoder=True, mm_input_dim=32)
    jcfg, tcfg = JU.UniGenConfig.tiny(**cfg_kw), TU.UniGenConfig.tiny(**cfg_kw)
    jvs, tvs = (JS.SiglipConfig.tiny(image_size=28, patch_size=14, hidden_size=32),
                TS.SiglipConfig.tiny(image_size=28, patch_size=14, hidden_size=32))
    params = JQZ.quantize_unigen_params(JU.init(jax.random.key(0), jcfg), jcfg, lm_head=True)
    vs_params = JQZ.quantize_siglip_params(JS.init(jax.random.key(2), jvs))
    vq_cfg = JMV.MagvitConfig.tiny(resolution=8, z_channels=5)
    jpipe = JPipeline(params, jcfg, JMV.init(jax.random.key(1), vq_cfg), vq_cfg, jprompt,
                      vision_params=vs_params, vision_cfg=jvs, quantized_cache=True)
    tpipe = TPipeline(W.unigen_from_jax(jax.tree.map(np.asarray, params), tcfg), tcfg,
                      None, None,
                      TPrompting(DecodableMockTokenizer(), special_tokens=SPECIALS,
                                 max_seq_len=64),
                      torch.device("cpu"),
                      vision_params=W.siglip_from_jax(jax.tree.map(np.asarray, vs_params), tvs),
                      vision_cfg=tvs, quantized_cache=True)
    return jpipe, tpipe


QUESTIONS = ["is there a cat?", "what color is the large bus on the left?"]


def test_understand_int8_quantized_cache_tokens_exact(pipes):
    jpipe, tpipe = pipes
    px = np.random.default_rng(5).integers(0, 256, size=(2, 28, 28, 3), dtype=np.uint8)
    want = _np(jpipe.understand(jnp.asarray(px), QUESTIONS, jax.random.key(6),
                                max_new_tokens=6))
    got = tpipe.understand(px, QUESTIONS, None, max_new_tokens=6)
    np.testing.assert_array_equal(got.numpy(), want)


def test_generate_text_quantized_cache_matches_jax_decode(pipes):
    """``generate_text`` on the int8 tree and cache against JAX's decode
    with the same causal mask, prompt lengths and cache (JAX's pipeline
    passes no ``quantized_cache`` to its text decode, so ``mmu_generate`` is
    called directly)."""
    jpipe, tpipe = pipes
    prompts = ["hello there", "a much longer question?"]
    tok_ids = [jpipe.prompting._tokenize(
        f"<|im_start|>user\n{p}<|im_end|>\n<|im_start|>assistant\n")[0] for p in prompts]
    ids = np.full((2, max(map(len, tok_ids))), jpipe.prompting.pad_id, np.int64)
    for i, t in enumerate(tok_ids):
        ids[i, :len(t)] = t
    plen = np.array([len(t) for t in tok_ids])
    pos = np.arange(ids.shape[1])
    keep = pos[None] < plen[:, None]
    mask = (pos[:, None] >= pos[None, :])[None, None] & keep[:, None, None, :] \
        & keep[:, None, :, None]
    want = JD.mmu_generate(jpipe.params, jpipe.cfg, jax.random.key(0), input_ids=jnp.asarray(ids),
                           attention_mask=jnp.asarray(mask), prompt_len=jnp.asarray(plen),
                           max_new_tokens=5, temperature=0.0,
                           eot_token=jpipe.prompting.eos_token_id, quantized_cache=True)
    assert tpipe.generate_text(prompts, None, max_new_tokens=5) == jpipe.decode_text(want)


def test_build_pipeline_int8_quantizes_every_dense_layer():
    p = build_pipeline("tiny", device="cpu", vision=True, quantization="int8",
                       quantized_cache=True)
    assert p.quantized_cache
    for lp in p.params["llm"]["layers"]:
        assert all(TQZ.is_quantized(lp[n]) for n in TQZ.QWEN2_PROJECTIONS)
    for lp in p.vision_params["layers"]:
        assert all(TQZ.is_quantized(lp[n]) for n in TQZ.SIGLIP_PROJECTIONS)
    assert TQZ.is_quantized(p.params["llm"]["lm_head_q"])
    assert TQZ.is_quantized(p.params["img_head_q"])
    assert "kernel" in p.vision_params["patch_embed"]
    w4 = build_pipeline("tiny", device="cpu", quantization="int4")
    assert "kernel_int4" in w4.params["llm"]["layers"][0]["q"] and not w4.quantized_cache
    with pytest.raises(ValueError):
        build_pipeline("tiny", device="cpu", quantization="fp8")


# ---------------------------------------------------------------------------
# JAX's int8 quality gates, run on the port
# ---------------------------------------------------------------------------

def _flagship_width_cfg(dtype):
    llm = TQ.Qwen2Config(vocab_size=128 + 8192 + 1, hidden_size=1536, intermediate_size=8960,
                         num_hidden_layers=2, num_attention_heads=12, num_key_value_heads=2,
                         head_dim=128, rope_theta=1e6, dtype=dtype)
    return TU.UniGenConfig(llm=llm, vocab_size=128 + 8192 + 1, llm_vocab_size=112,
                           text_vocab_len=128, codebook_size=8192, num_vq_tokens=16)


def _gate_agreement(dtype, steps):
    """Shared-noise t2i codes of the float and the int8 tree (the port's init
    at the flagship widths, 2 layers), as tests/test_quantization.py runs its
    gates: the fraction of equal tokens."""
    cfg = _flagship_width_cfg(dtype)
    params = W.init_unigen(cfg, torch.Generator().manual_seed(0), "cpu", dtype)
    qparams = TQZ.quantize_unigen_params(params, cfg)
    assert qparams["img_head_q"]["kernel_int8"].dtype == torch.int8
    rng = np.random.default_rng(17)
    b, n = 2, cfg.num_vq_tokens
    text = rng.integers(3, 100, size=(b, 6))
    ids = np.concatenate([text, np.full((b, 1), 1), np.full((b, n), cfg.mask_token_id),
                          np.full((b, 1), 2)], axis=1)
    uncond = np.roll(ids, 1, axis=0)
    noise = (torch.from_numpy(rng.random((steps, b, n, cfg.codebook_size), dtype=np.float32)),
             torch.from_numpy(rng.random((steps, b, n), dtype=np.float32)))
    kw = dict(uncond_input_ids=torch.from_numpy(uncond), guidance_scale=6.0, timesteps=steps,
              temperature=1.0, noise=noise, pad_id=0)
    ref = t_t2i(params, cfg, None, torch.from_numpy(ids), None, **kw)
    got = t_t2i(qparams, cfg, None, torch.from_numpy(ids), None, **kw)
    return (ref == got).float().mean().item()


def test_t2i_int8_token_agreement_gate_on_the_port():
    agree = _gate_agreement(torch.float32, 1)
    assert agree >= 0.85, f"int8 per-step token agreement {agree:.2f} below gate"


def test_t2i_int8_cumulative_gate_on_the_port():
    agree = _gate_agreement(torch.bfloat16, 50)
    assert agree >= 0.5, f"cumulative int8 final-grid agreement {agree:.3f} < 0.5"


def test_int8_lm_head_greedy_agreement_on_the_port():
    cfg = TU.UniGenConfig.tiny()
    params = W.init_unigen(cfg, torch.Generator().manual_seed(0), "cpu")
    qparams = TQZ.quantize_unigen_params(params, cfg, lm_head=True)
    h = torch.from_numpy(np.random.default_rng(1).normal(
        size=(4, 7, cfg.llm.hidden_size)).astype(np.float32))
    l_ref = TQ.logits(params["llm"], cfg.llm, h)
    l_q = TQ.logits(qparams["llm"], cfg.llm, h)
    agree = (l_ref.argmax(-1) == l_q.argmax(-1)).float().mean().item()
    assert agree >= 0.7, agree
    sl = (3, 3 + cfg.codebook_size)
    np.testing.assert_allclose(
        TQ.logits(qparams["llm"], cfg.llm, h, vocab_slice=sl).numpy(),
        l_q[..., sl[0]:sl[1]].numpy(), rtol=1e-5, atol=1e-5)
    # the image head of the same tree is the tied head's codebook rows in int8
    img = TT._image_head(qparams, cfg, h)
    tied = TQ.logits(qparams["llm"], cfg.llm, h,
                     vocab_slice=(cfg.text_vocab_len, cfg.text_vocab_len + cfg.codebook_size))
    np.testing.assert_array_equal(img.numpy(), tied.numpy())
