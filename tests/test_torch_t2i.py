"""The port's MaskGIT sampler against JAX ``t2i_generate``: token-exact under
shared noise, with CFG (guidance > 1) and left padding, for the
prefix-cached and the full path and both ``cfg_combine`` modes.

Both samplers get the same weights (the JAX tiny init through
``unigen_tpu_torch.weights``) and the same pre-drawn uniforms
(``noise=(u_sample [T, B, N, CB], u_mask [T, B, N])``), as in
tests/test_generation.py::test_t2i_prefix_cached_matches_full_path.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unigen_tpu.generation import t2i_generate as j_t2i
from unigen_tpu.models import unigen as JU
from unigen_tpu.ops import masks as JM
from unigen_tpu_torch import weights as W
from unigen_tpu_torch.generation import t2i_generate as t_t2i
from unigen_tpu_torch.models import unigen as TU
from unigen_tpu_torch.ops import masks as TM

PAD, SOI, EOI = 0, 1, 2
STEPS = 4   # ratios 1/4..1: n * cosine(ratio) stays clear of integers, so the
            # mask_len floor is the same in both frameworks' fp32 cosines


def _models(**kw):
    jcfg = JU.UniGenConfig.tiny(**kw)
    tree = jax.tree.map(np.asarray, JU.init(jax.random.key(0), jcfg))
    return (jcfg, jax.tree.map(jnp.asarray, tree), TU.UniGenConfig.tiny(**kw),
            W.unigen_from_jax(tree, TU.UniGenConfig.tiny(**kw)))


@pytest.fixture(scope="module")
def models():
    return _models()


def _prompts(cfg, b=2, seed=11):
    rng = np.random.default_rng(seed)
    n = cfg.num_vq_tokens
    text = rng.integers(3, 100, size=(b, 6))
    ids = np.concatenate([np.zeros((b, 2), np.int64), text, np.full((b, 1), SOI),
                          np.full((b, n), cfg.mask_token_id), np.full((b, 1), EOI)], axis=1)
    ids[1, 2] = PAD                                     # ragged left padding
    uncond = np.roll(ids, 1, axis=0)
    uncond[:, 2:6] = PAD                                # mostly-empty uncond prompts
    return ids, uncond


def _noise(cfg, b, seed=5):
    rng = np.random.default_rng(seed)
    return (rng.random((STEPS, b, cfg.num_vq_tokens, cfg.codebook_size), dtype=np.float32),
            rng.random((STEPS, b, cfg.num_vq_tokens), dtype=np.float32))


def _run_both(models, cached, combine, guidance=2.0):
    jcfg, jparams, tcfg, tparams = models
    ids, uncond = _prompts(jcfg)
    u_s, u_m = _noise(jcfg, ids.shape[0])
    mask = JM.create_attention_mask_predict_next(
        jnp.asarray(np.concatenate([ids, uncond])), PAD, SOI, EOI, rm_pad_in_image=True)
    ref = j_t2i(jparams, jcfg, jax.random.key(0), jnp.asarray(ids), mask,
                uncond_input_ids=jnp.asarray(uncond), guidance_scale=guidance,
                timesteps=STEPS, temperature=1.0, reuse_prefix_cache=cached, pad_id=PAD,
                noise=(jnp.asarray(u_s), jnp.asarray(u_m)), cfg_combine=combine)
    tmask = TM.create_attention_mask_predict_next(
        torch.from_numpy(np.concatenate([ids, uncond])), PAD, SOI, EOI, rm_pad_in_image=True)
    got = t_t2i(tparams, tcfg, None, torch.from_numpy(ids), tmask,
                uncond_input_ids=torch.from_numpy(uncond), guidance_scale=guidance,
                timesteps=STEPS, temperature=1.0, reuse_prefix_cache=cached, pad_id=PAD,
                noise=(torch.from_numpy(u_s), torch.from_numpy(u_m)), cfg_combine=combine)
    return np.asarray(ref), got.numpy()


@pytest.mark.parametrize("cached", [True, False], ids=["prefix_cached", "full"])
@pytest.mark.parametrize("combine", ["hidden", "logits"])
def test_t2i_tokens_exact_vs_jax(models, cached, combine):
    ref, got = _run_both(models, cached, combine)
    assert got.shape == ref.shape == (2, models[0].num_vq_tokens)
    np.testing.assert_array_equal(got, ref)


def test_t2i_tokens_exact_without_cfg(models):
    ref, got = _run_both(models, True, "hidden", guidance=0.0)
    np.testing.assert_array_equal(got, ref)


def test_t2i_gen_projector_tokens_exact():
    """The gen-projector variant: (codebook+1)-entry embedding, MLP and img_head."""
    ref, got = _run_both(_models(gen_proj_depth=2), True, "hidden")
    np.testing.assert_array_equal(got, ref)


def test_t2i_generator_path_in_codebook_and_deterministic(models):
    _, _, tcfg, tparams = models
    ids, uncond = _prompts(tcfg)

    def run(seed):
        return t_t2i(tparams, tcfg, torch.Generator().manual_seed(seed), torch.from_numpy(ids),
                     None, uncond_input_ids=torch.from_numpy(uncond), guidance_scale=3.0,
                     timesteps=5, pad_id=PAD)
    a, b, c = run(7), run(7), run(8)
    assert ((a >= 0) & (a < tcfg.codebook_size)).all()
    assert torch.equal(a, b) and not torch.equal(a, c)
