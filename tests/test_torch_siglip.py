"""The port's SigLIP tower and MM projector against the JAX package (CPU, fp32).

Weights are the JAX init (biases and norm scales perturbed so that they
matter), carried across by ``weights.siglip_from_jax`` / ``unigen_from_jax``.
Tolerance 1e-5: only the order of fp32 sums differs.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unigen_tpu.models import siglip as JS
from unigen_tpu.models import unigen as JU
from unigen_tpu_torch import weights as W
from unigen_tpu_torch.models import siglip as TS
from unigen_tpu_torch.models import unigen as TU
from unigen_tpu_torch.ops import _cuda
from unigen_tpu_torch.ops import flash_attention as FA

from test_torch_qwen2 import _perturb


def _tower(**kw):
    jcfg, tcfg = JS.SiglipConfig.tiny(**kw), TS.SiglipConfig.tiny(**kw)
    tree = _perturb(jax.tree.map(np.asarray, JS.init(jax.random.key(2), jcfg)),
                    np.random.default_rng(1))
    return jcfg, jax.tree.map(jnp.asarray, tree), tcfg, W.siglip_from_jax(tree, tcfg)


@pytest.mark.parametrize("kw", [{}, {"image_size": 42, "num_attention_heads": 2}])
def test_tiny_tower_matches_jax(kw):
    jcfg, jparams, tcfg, tparams = _tower(**kw)
    px = np.random.default_rng(3).uniform(-1, 1, size=(2, jcfg.image_size, jcfg.image_size, 3)
                                          ).astype(np.float32)
    want = np.asarray(JS.forward(jparams, jcfg, jnp.asarray(px)))
    got = TS.forward(tparams, tcfg, torch.from_numpy(px))
    assert got.shape == (2, jcfg.num_patches, jcfg.hidden_size)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("dh", [8, 72])
def test_bidir_attention_matches_jax_flash_path(dh):
    """JAX's padded Pallas path (interpret mode) against the port's padded
    plain path, with the real dh^-1/2 scale."""
    rng = np.random.default_rng(4)
    q, k, v = (rng.normal(size=(2, 13, 2, dh)).astype(np.float32) for _ in range(3))
    want = np.asarray(JS._bidir_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                          dh ** -0.5, force_flash=True))
    got = TS._bidir_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                              dh ** -0.5)
    assert got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_kernel_head_dims_match_the_cuda_source():
    """The head dims SigLIP pads to are the ones csrc/attention.cu builds."""
    src = (_cuda.CSRC / "attention.cu").read_text()
    switches = src.split("switch (Dh)")[1:]
    assert len(switches) == 2                    # the unsplit launch and the split one
    for cases in switches:
        cases = cases[:cases.index("default:")]
        assert tuple(int(d) for d in re.findall(r"case (\d+):", cases)) == FA.KERNEL_HEAD_DIMS
    assert [FA.kernel_head_dim(d) for d in (8, 72, 128)] == [16, 80, 128]


def test_layer_norm_matches_jax():
    rng = np.random.default_rng(5)
    x = (rng.normal(size=(3, 5, 40)) * 4 + 2).astype(np.float32)
    p = {"scale": rng.normal(size=(40,)).astype(np.float32),
         "bias": rng.normal(size=(40,)).astype(np.float32)}
    want = np.asarray(JS.layer_norm({k: jnp.asarray(a) for k, a in p.items()},
                                    jnp.asarray(x), 1e-6))
    got = TS.layer_norm({k: torch.from_numpy(a) for k, a in p.items()},
                        torch.from_numpy(x), 1e-6)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_mm_project_matches_jax():
    """The projector's exact GELU (SigLIP's MLP uses the tanh one)."""
    jcfg = JU.UniGenConfig.tiny(w_und_encoder=True, mm_input_dim=32)
    tcfg = TU.UniGenConfig.tiny(w_und_encoder=True, mm_input_dim=32)
    tree = _perturb(jax.tree.map(np.asarray, JU.init(jax.random.key(6), jcfg)),
                    np.random.default_rng(6))
    tparams = W.unigen_from_jax(tree, tcfg)
    assert [tuple(p["w"].shape) for p in tparams["mm_projector"]] == [(64, 32), (64, 64)]
    feats = np.random.default_rng(7).normal(size=(2, 4, 32)).astype(np.float32) * 3
    want = np.asarray(JU.mm_project(jax.tree.map(jnp.asarray, tree), jnp.asarray(feats)))
    got = TU.mm_project(tparams, torch.from_numpy(feats))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_init_matches_jax_tree_layout():
    """The port's random init has the layout weights.py gives a JAX tree."""
    jcfg, _, tcfg, bridged = _tower()
    fresh = W.init_siglip(tcfg, torch.Generator().manual_seed(0), "cpu")
    shapes = lambda p: jax.tree.map(lambda a: tuple(a.shape), p)  # noqa: E731
    assert shapes(bridged) == shapes(fresh)
    ucfg = TU.UniGenConfig.tiny(w_und_encoder=True, mm_input_dim=32)
    jtree = jax.tree.map(np.asarray, JU.init(jax.random.key(1), JU.UniGenConfig.tiny(
        w_und_encoder=True, mm_input_dim=32)))
    assert shapes(W.unigen_from_jax(jtree, ucfg)) == shapes(
        W.init_unigen(ucfg, torch.Generator().manual_seed(0), "cpu"))


def test_so400m_shapes():
    cfg = TS.SiglipConfig.so400m()
    assert (cfg.num_patches, cfg.num_layers_used, cfg.hidden_size // cfg.num_attention_heads) \
        == (729, 26, 72)
