"""``UniGenPipeline.understand`` in the port against the JAX package.

The tiny pipeline of tests/test_pipeline.py (SigLIP tiny tower over 28 px
images, 4 patches; 2-layer projector; tiny Qwen2), the JAX init carried
across by ``weights.py``, the same mock tokenizer on both sides. CPU, fp32:
the prompt splice, the tokens of ``understand`` (float and W4A8 trees,
greedy) and ``decode_text`` must be equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unigen_tpu.models import magvit as JMV
from unigen_tpu.models import siglip as JS
from unigen_tpu.models import unigen as JU
from unigen_tpu.ops import int4 as J4
from unigen_tpu.pipeline import UniGenPipeline as JPipeline
from unigen_tpu.prompting import UniPrompting as JPrompting
from unigen_tpu_torch import weights as W
from unigen_tpu_torch.models import siglip as TS
from unigen_tpu_torch.models import unigen as TU
from unigen_tpu_torch.pipeline import UniGenPipeline as TPipeline
from unigen_tpu_torch.prompting import UniPrompting as TPrompting

from test_pipeline import DecodableMockTokenizer
from test_prompting import SPECIALS

QUESTIONS = ["is there a cat?", "what color is the large bus on the left?"]


@pytest.fixture(scope="module")
def pipes():
    tok = DecodableMockTokenizer()
    jprompt = JPrompting(tok, special_tokens=SPECIALS, max_seq_len=64, cond_dropout_prob=0.0)
    cfg_kw = dict(text_vocab_len=len(tok), w_und_encoder=True, mm_input_dim=32)
    jcfg, tcfg = JU.UniGenConfig.tiny(**cfg_kw), TU.UniGenConfig.tiny(**cfg_kw)
    jvs, tvs = (JS.SiglipConfig.tiny(image_size=28, patch_size=14, hidden_size=32),
                TS.SiglipConfig.tiny(image_size=28, patch_size=14, hidden_size=32))
    params = JU.init(jax.random.key(0), jcfg)
    vs_params = JS.init(jax.random.key(2), jvs)
    vq_cfg = JMV.MagvitConfig.tiny(resolution=8, z_channels=5)
    jpipe = JPipeline(params, jcfg, JMV.init(jax.random.key(1), vq_cfg), vq_cfg, jprompt,
                      vision_params=vs_params, vision_cfg=jvs)
    tpipe = TPipeline(W.unigen_from_jax(jax.tree.map(np.asarray, params), tcfg), tcfg,
                      None, None,
                      TPrompting(DecodableMockTokenizer(), special_tokens=SPECIALS,
                                 max_seq_len=64),
                      torch.device("cpu"),
                      vision_params=W.siglip_from_jax(jax.tree.map(np.asarray, vs_params), tvs),
                      vision_cfg=tvs)
    jq = J4.quantize_unigen_params_int4(params, jcfg, group=32)
    quant = (dataclasses.replace(jpipe, params=jq),
             dataclasses.replace(tpipe, params=W.unigen_from_jax(
                 jax.tree.map(np.asarray, jq), tcfg)))
    return {"float": (jpipe, tpipe), "w4a8": quant}


def _pixels(dtype):
    rng = np.random.default_rng(5)
    if dtype == "uint8":
        return rng.integers(0, 256, size=(2, 28, 28, 3), dtype=np.uint8)
    return rng.uniform(-1, 1, size=(2, 28, 28, 3)).astype(np.float32)


def test_prompt_splice_matches_jax(pipes):
    jpipe, tpipe = pipes["float"]
    for q in QUESTIONS:
        np.testing.assert_array_equal(tpipe._vqa_question_ids(q), jpipe._vqa_question_ids(q))
    q_ids = [jpipe._vqa_question_ids(q) for q in QUESTIONS]
    q_arr = np.full((2, max(map(len, q_ids))), jpipe.prompting.pad_id, np.int64)
    for i, q in enumerate(q_ids):
        q_arr[i, :len(q)] = q
    sys_ids = np.asarray([[40, 41, 42]])
    for sys in (None, sys_ids):
        want = jpipe.prompting((np.zeros((2, 4, 1)), q_arr, None, sys), "mmu_conv")
        got = tpipe.prompting((np.zeros((2, 4, 1)), q_arr, None, sys), "mmu_conv")
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    part1 = want[0]
    prompt_len = part1.shape[1] + 4 + 1 + (np.asarray([len(q) for q in q_ids]) - 1)
    # every real token of part2 lies before prompt_len; the rest are pads
    assert (prompt_len <= part1.shape[1] + 4 + want[1].shape[1]).all()


@pytest.mark.parametrize("tree", ["float", "w4a8"])
@pytest.mark.parametrize("pixels", ["float", "uint8"])
def test_understand_tokens_exact(pipes, tree, pixels):
    jpipe, tpipe = pipes[tree]
    px = _pixels(pixels)
    want = np.asarray(jpipe.understand(jnp.asarray(px), QUESTIONS, jax.random.key(6),
                                       max_new_tokens=6))
    got = tpipe.understand(px, QUESTIONS, None, max_new_tokens=6)
    assert got.shape == (2, 6)
    np.testing.assert_array_equal(got.numpy(), want)
    assert tpipe.decode_text(got) == jpipe.decode_text(want)


def test_image_embeds_match_jax(pipes):
    jpipe, tpipe = pipes["float"]
    px = _pixels("uint8")
    want = np.asarray(jpipe._image_embeds(jnp.asarray(px)))
    got = tpipe._image_embeds(px)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_generate_text_matches_jax(pipes):
    jpipe, tpipe = pipes["float"]
    want = jpipe.generate_text(["hello there", "a much longer question?"], jax.random.key(0),
                               max_new_tokens=5)
    assert tpipe.generate_text(["hello there", "a much longer question?"], None,
                               max_new_tokens=5) == want


def test_decode_text_cuts_at_eos(pipes):
    jpipe, tpipe = pipes["float"]
    eos = tpipe.prompting.eos_token_id
    ids = np.array([[104, 105, eos, 106], [107, 108, 109, 110]])
    assert tpipe.decode_text(torch.from_numpy(ids)) == jpipe.decode_text(ids) == ["hi", "klmn"]
