"""Every NaFlex branch of the port against the JAX package, fp32 on the CPU.

The tiny pipeline of tests/test_pipeline.py::test_understand_naflex_tower
(tiny Qwen2, an 8 px MAGViTv2, the tiny SigLIP2-NaFlex tower: 3 layers 32
wide, patch 4, a 4 x 4 position grid), its JAX init carried across by
``weights.py``, the same mock tokenizer on both sides:

* ``data/transform.py``: ``naflex_target_dims`` exact; the resizes, which
  use ``F.interpolate`` where JAX uses PIL's bicubic, within 2 uint8 levels
  on under 2% of the values (measured: at most 2 levels, under 1%), and
  exact where the size does not change;
* ``mmu_vit_attn_meta`` with [B, 2] spatial shapes equal to JAX's;
* ``understand`` tokens exact and ``score_continuations`` within 1e-5
  relative (tests/test_torch_pipeline_more.py's tolerance), greedy flags
  equal; ragged images in one batch equal to each image alone;
* ``vqa_serving_inputs`` (embeddings 1e-5, bits equal to JAX's dense mask
  on every non-pad row) and ``vqa_lookup_ids``;
* the CoT vision rater's NaFlex branch: rows equal to JAX's;
* the NaFlex ``SFTStep`` against JAX's ``make_sft_train_step`` on the same
  batch and masking draws: losses and grad norm against JAX's flash step
  (1e-5) and dense step (1e-4), the updated parameters within 1e-4.

(``collate_batch`` of NaFlex samples is held to JAX's in
tests/test_torch_sft.py::test_preprocess_and_collate_match_jax.)
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from test_pipeline import DecodableMockTokenizer
from test_prompting import SPECIALS
from test_torch_qwen2 import _perturb
from test_torch_sft import METRICS, OPT_KW, _t2i_rows
from test_torch_training import _jax_draws, _leaf_errors
from unigen_tpu.data import transform as JT
from unigen_tpu.evaluation import cot as JCOT
from unigen_tpu.models import magvit as JMV
from unigen_tpu.models import siglip2 as JS2
from unigen_tpu.models import unigen as JU
from unigen_tpu.ops import masks as JM
from unigen_tpu.pipeline import UniGenPipeline as JPipeline
from unigen_tpu.prompting import UniPrompting as JPrompting
from unigen_tpu.training import lr_schedules as JLRS
from unigen_tpu.training import optimizer as JO
from unigen_tpu.training import sft as JSFT
from unigen_tpu.training import train_step as JTS
from unigen_tpu_torch import weights as W
from unigen_tpu_torch.data import transform as TT
from unigen_tpu_torch.evaluation import cot as TCOT
from unigen_tpu_torch.models import magvit as TMV
from unigen_tpu_torch.models import siglip2 as TS2
from unigen_tpu_torch.models import unigen as TU
from unigen_tpu_torch.ops import masks as TM
from unigen_tpu_torch.pipeline import UniGenPipeline as TPipeline
from unigen_tpu_torch.prompting import UniPrompting as TPrompting
from unigen_tpu_torch.training import lr_schedules as TLRS
from unigen_tpu_torch.training import optimizer as TO
from unigen_tpu_torch.training import sft as TSFT

QUESTIONS = ["is there a cat?", "what color is the large bus on the left?"]


def _tree(tree):
    return jax.tree.map(np.asarray, tree)


def make_naflex_pipes():
    """(JAX pipeline, port pipeline) with the tiny NaFlex tower on shared weights."""
    tok = DecodableMockTokenizer()
    jprompt = JPrompting(tok, special_tokens=SPECIALS, max_seq_len=64, cond_dropout_prob=0.0)
    cfg_kw = dict(text_vocab_len=len(tok), w_und_encoder=True, mm_input_dim=32)
    jcfg, tcfg = JU.UniGenConfig.tiny(**cfg_kw), TU.UniGenConfig.tiny(**cfg_kw)
    jvs, tvs = (m.Siglip2Config.tiny(hidden_size=32, num_patches=16, patch_size=4)
                for m in (JS2, TS2))
    jvq, tvq = (m.MagvitConfig.tiny(resolution=8, z_channels=5) for m in (JMV, TMV))
    params = JU.init(jax.random.key(0), jcfg)
    vq_params = JMV.init(jax.random.key(1), jvq)
    vs_tree = _perturb(_tree(JS2.init(jax.random.key(2), jvs)), np.random.default_rng(1))
    jpipe = JPipeline(params, jcfg, vq_params, jvq, jprompt,
                      vision_params=jax.tree.map(jnp.asarray, vs_tree), vision_cfg=jvs)
    tpipe = TPipeline(W.unigen_from_jax(_tree(params), tcfg), tcfg,
                      W.magvit_from_jax(_tree(vq_params), tvq), tvq,
                      TPrompting(DecodableMockTokenizer(), special_tokens=SPECIALS,
                                 max_seq_len=64),
                      torch.device("cpu"), vision_params=W.siglip2_from_jax(vs_tree, tvs),
                      vision_cfg=tvs)
    return jpipe, tpipe


@pytest.fixture(scope="module")
def pipes():
    return make_naflex_pipes()


def _pixels(shape, seed=3):
    return np.random.default_rng(seed).uniform(-1, 1, size=shape).astype(np.float32)


# --------------------------------------------------------------- transform --

def test_naflex_target_dims_match_jax():
    for w, h in [(40, 24), (24, 40), (1, 1), (4000, 10), (10, 4000), (384, 384), (512, 256),
                 (256, 640), (333, 777), (17, 16)]:
        for p, n in ((16, 256), (4, 16), (14, 729)):
            assert TT.naflex_target_dims(w, h, p, n) == JT.naflex_target_dims(w, h, p, n)


@pytest.mark.parametrize("hw", [(30, 40), (24, 40), (48, 48), (16, 16), (100, 7)])
def test_resizes_match_jax(hw):
    """The port's PIL-free resizes against JAX's PIL ones, on arrays and on
    PIL images (read by duck typing); the same size is the identity."""
    rng = np.random.default_rng(hw[0])
    arr = rng.integers(0, 256, size=hw + (3,), dtype=np.uint8)
    step = 2 / 255 / 0.5 + 1e-6                   # 2 uint8 levels after normalization
    for image in (arr, Image.fromarray(arr), Image.fromarray(arr).convert("L")):
        got, want = TT.naflex_resize(image, 4, 16), JT.naflex_resize(image, 4, 16)
        assert got.shape == want.shape and got.dtype == np.float32
        diff = np.abs(got - want)
        assert diff.max() <= step and (diff > 0).mean() < 0.02, (diff.max(), (diff > 0).mean())
        if want.shape[:2] == hw:
            np.testing.assert_array_equal(got, want)
        got8 = TT.siglip_preprocess(image, 28, as_uint8=True)
        want8 = JT.siglip_preprocess(image, 28, as_uint8=True)
        assert got8.dtype == np.uint8 and got8.shape == want8.shape == (28, 28, 3)
        assert np.abs(got8.astype(int) - want8.astype(int)).max() <= 2
        np.testing.assert_array_equal(TT.siglip_preprocess(image, 28),
                                      (got8.astype(np.float32) / 255.0 - 0.5) / 0.5)
    j, t = JT.naflex_preprocess(arr, 4, 16), TT.naflex_preprocess(arr, 4, 16)
    assert sorted(j) == sorted(t)
    np.testing.assert_array_equal(t["pixel_attention_mask"], j["pixel_attention_mask"])
    np.testing.assert_array_equal(t["spatial_shapes"], j["spatial_shapes"])
    assert np.abs(t["pixel_values"] - j["pixel_values"]).max() <= step


def test_mmu_vit_attn_meta_spatial_shapes_match_jax():
    """[B, 2] spatial shapes: each row's bidirectional block is its own
    h * w patches; the int form is unchanged."""
    shapes = np.array([[2, 3], [4, 4], [1, 1]])
    plen = np.array([30, 25, 12])
    for num_tokens in (shapes, 16):
        j = JM.mmu_vit_attn_meta(3, 32, num_tokens=jnp.asarray(num_tokens) if
                                 isinstance(num_tokens, np.ndarray) else num_tokens,
                                 prefix_length=3, prompt_len=jnp.asarray(plen))
        t = TM.mmu_vit_attn_meta(3, 32, num_tokens=torch.as_tensor(num_tokens) if
                                 isinstance(num_tokens, np.ndarray) else num_tokens,
                                 prefix_length=3, prompt_len=torch.as_tensor(plen))
        for name in ("pad", "bidir_q", "bidir_k"):
            np.testing.assert_array_equal(getattr(t, name).numpy(),
                                          np.asarray(getattr(j, name)), err_msg=name)


# ---------------------------------------------------------------- pipeline --

@pytest.mark.parametrize("hw", [(12, 8), (16, 16)])
def test_understand_naflex_matches_jax(pipes, hw):
    jpipe, tpipe = pipes
    px = _pixels((2,) + hw + (3,))
    want = np.asarray(jpipe.understand(jnp.asarray(px), QUESTIONS, jax.random.key(4),
                                       max_new_tokens=4))
    got = tpipe.understand(px, QUESTIONS, None, max_new_tokens=4)
    np.testing.assert_array_equal(got.numpy(), want)


def test_ragged_images_in_one_batch(pipes):
    """Images of several sizes in one call: each row's features equal the
    image's alone on its patches (pads mask keys only)."""
    _, tpipe = pipes
    imgs = [_pixels((12, 8, 3), 5), _pixels((16, 16, 3), 6), _pixels((4, 8, 3), 7)]
    both = tpipe._image_embeds(imgs)
    assert both.shape[:2] == (3, 16)
    for i, img in enumerate(imgs):
        alone = tpipe._image_embeds(img[None])
        n = alone.shape[1]
        torch.testing.assert_close(both[i, :n], alone[0], rtol=1e-5, atol=1e-5)


def test_score_continuations_naflex_match_jax(pipes):
    jpipe, tpipe = pipes
    px = _pixels((2, 12, 8, 3), 8)
    conts = [np.asarray(tpipe.prompting._tokenize(c)[0]) for c in ("a cat", "blue and red")]
    want = jpipe.score_continuations(jnp.asarray(px), QUESTIONS, conts)
    got = tpipe.score_continuations(px, QUESTIONS, conts)
    for (lp_t, g_t), (lp_j, g_j) in zip(got, want):
        assert g_t == g_j
        np.testing.assert_allclose(lp_t, lp_j, rtol=1e-5)


def test_vqa_serving_inputs_naflex_match_jax(pipes):
    jpipe, tpipe = pipes
    px = _pixels((2, 12, 8, 3), 9)
    sys_ids = np.asarray([tpipe.prompting._tokenize("<|im_start|>system\nhi<|im_end|>\n")[0]])
    want = jpipe.vqa_serving_inputs(jnp.asarray(px), QUESTIONS, system_prompt_ids=sys_ids)
    got = tpipe.vqa_serving_inputs(px, QUESTIONS, system_prompt_ids=sys_ids)
    lookups = tpipe.vqa_lookup_ids(QUESTIONS, system_prompt_ids=sys_ids, num_patches=6)
    for (e_t, bits, plen_t), (e_j, attn, plen_j, look_j), look_t in zip(got, want, lookups):
        assert plen_t == int(plen_j)
        np.testing.assert_allclose(e_t.numpy(), np.asarray(e_j), rtol=1e-5, atol=1e-5)
        vis = TM.unpack_meta(bits).visibility()[0, 0].numpy()
        dense = np.asarray(attn)[0, 0]
        np.testing.assert_array_equal(vis[:plen_t], dense[:plen_t])
        np.testing.assert_array_equal(look_t, np.asarray(look_j))


def test_cot_rating_naflex_matches_jax(pipes):
    """tests/test_pipeline.py::test_cot_vision_tower_rating_naflex on both
    sides, candidates of 16 px (the patch budget's own size, so neither
    resize moves a value): rows equal."""
    jpipe, tpipe = pipes
    px = _pixels((2, 16, 16, 3), 10)
    kw = dict(style="rule", max_new_tokens=2, use_vision_tower=True)
    want = JCOT.rate_candidates(jpipe, jnp.asarray(px), "a photo of a cup",
                                jax.random.key(4), **kw)
    got = TCOT.rate_candidates(tpipe, px, "a photo of a cup", None, **kw)
    assert len(got) >= 2 and got == want


# --------------------------------------------------------------------- SFT --

@pytest.fixture(scope="module")
def sft_models():
    kw = dict(w_und_encoder=True, mm_input_dim=32)
    jcfg, tcfg = JU.UniGenConfig.tiny(**kw), TU.UniGenConfig.tiny(**kw)
    tree = _perturb(_tree(JU.init(jax.random.key(0), jcfg)), np.random.default_rng(0))
    jvq, tvq = (m.MagvitConfig.tiny(resolution=8, z_channels=5) for m in (JMV, TMV))
    vq_tree = _tree(JMV.init(jax.random.key(1), jvq))
    jvs, tvs = (m.Siglip2Config.tiny(hidden_size=32, num_patches=16, patch_size=4)
                for m in (JS2, TS2))
    vs_tree = _perturb(_tree(JS2.init(jax.random.key(2), jvs)), np.random.default_rng(1))
    j = dict(cfg=jcfg, params=jax.tree.map(jnp.asarray, tree), vq_cfg=jvq,
             vq=jax.tree.map(jnp.asarray, vq_tree), vs_cfg=jvs,
             vs=jax.tree.map(jnp.asarray, vs_tree))
    t = dict(cfg=tcfg, params=W.unigen_from_jax(tree, tcfg), vq_cfg=tvq,
             vq=W.magvit_from_jax(vq_tree, tvq), vs_cfg=tvs, vs=W.siglip2_from_jax(vs_tree, tvs))
    return j, t


def _naflex_batch(cfg, vs_tree_pos):
    """tests/test_torch_sft.py's separate-mode batch with NaFlex mmu rows:
    2 t2i + 2 lm rows, 2 mmu rows of 2 x 3 and 4 x 4 patches padded to 16."""
    n = cfg.num_vq_tokens
    rng = np.random.default_rng(7)
    t2i, t2i_labels = _t2i_rows(rng, 2, n)
    shapes = np.array([[2, 3], [4, 4]], np.int32)
    pv = rng.uniform(-1, 1, size=(2, 16, 48)).astype(np.float32)
    mask = np.zeros((2, 16), np.int32)
    for i, (h, w) in enumerate(shapes):
        mask[i, :h * w] = 1
        pv[i, h * w:] = 0.0
    mmu_len = 3 + 16 + 8
    mmu_labels = np.full((2, mmu_len), -100)
    mmu_labels[:, -6:] = rng.integers(3, 100, size=(2, 6))
    return {"t2i_template": t2i, "t2i_labels": t2i_labels,
            "t2i_pixels": rng.normal(size=(2, 8, 8, 3)).astype(np.float32),
            "lm_ids": rng.integers(3, 100, size=(2, 28)),
            "lm_labels": rng.integers(3, 100, size=(2, 28)),
            "mmu_part1": rng.integers(3, 100, size=(2, 3)),
            "mmu_part2": rng.integers(3, 100, size=(2, 8)),
            "mmu_labels": mmu_labels, "mmu_prompt_len": np.array([mmu_len, mmu_len - 2]),
            "mmu_pixel_values": pv, "mmu_pixel_attention_mask": mask,
            "mmu_spatial_shapes": shapes,
            "mmu_pos_embeds": JS2.resize_positional_embeddings(vs_tree_pos, shapes, 16)}


def test_naflex_sft_step_matches_jax(sft_models):
    """One separate-mode step with the NaFlex tower: losses and grad norm
    against JAX's flash step (rtol 1e-5) and dense step (1e-4), parameters
    within 1e-4 of each leaf's largest magnitude (test_torch_sft.py's
    standard); the tower untouched."""
    j, t = sft_models
    batch = _naflex_batch(j["cfg"], np.asarray(j["vs"]["pos_embed"]["weight"]))
    step_kw = dict(batch_size_t2i=2, batch_size_lm=2, batch_size_mmu=2)
    key = jax.random.key(5)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    out = {}
    for flash in (False, True):
        tx = JO.make_optimizer(j["params"], 1e-3, JLRS.get_scheduler("constant"), **OPT_KW)
        tcfg = JSFT.SFTStepConfig(use_flash_attention=flash, max_grad_norm=1.0, **step_kw)
        step = jax.jit(JSFT.make_sft_train_step(j["cfg"], j["vq_cfg"], j["vs_cfg"], tx, tcfg))
        state, m = step(JTS.init_train_state(j["params"], tx), j["vq"], j["vs"], jb, key)
        out[flash] = (state, {k: float(v) for k, v in m.items()})
    tx = TO.make_optimizer(t["params"], 1e-3, TLRS.get_scheduler("constant"), **OPT_KW)
    step = TSFT.make_sft_train_step(t["cfg"], t["vq_cfg"], t["vs_cfg"], tx,
                                    TSFT.SFTStepConfig(max_grad_norm=1.0, **step_kw))
    assert step.naflex and step.mode == "separate"
    vs_before = [x.clone() for _, x in TO.named_leaves(t["vs"])]
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    state, m = step(TSFT.init_sft_state(t["params"], tx), t["vq"], t["vs"], tb,
                    _jax_draws(key, 2, j["cfg"].num_vq_tokens))
    (_, dense), (jstate, flash) = out[False], out[True]
    for k in METRICS:
        np.testing.assert_allclose(float(m[k]), flash[k], rtol=1e-5, atol=1e-6, err_msg=k)
        np.testing.assert_allclose(float(m[k]), dense[k], rtol=1e-4, atol=1e-5, err_msg=k)
    errs = _leaf_errors(jstate.params, W.unigen_to_jax(state.params, t["cfg"]))
    assert max(errs.values()) < 1e-4, {k: v for k, v in errs.items() if v >= 1e-4}
    assert all(torch.equal(a, b) for a, b in zip(vs_before, (x for _, x in
                                                          TO.named_leaves(t["vs"]))))
