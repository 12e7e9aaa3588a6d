"""The port's MAGViTv2 decoder against JAX ``magvit.decode_code``, fp32 on the CPU."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unigen_tpu.models import magvit as JMV
from unigen_tpu_torch import weights as W
from unigen_tpu_torch.models import magvit as TMV


def _perturb_norms(tree, rng):
    """Non-trivial GroupNorm affines and conv biases, the same in both frameworks."""
    def fix(path, a):
        a = np.array(a)
        name = jax.tree_util.keystr(path)
        if name.endswith("['bias']"):
            return (a + 0.05 * rng.normal(size=a.shape)).astype(a.dtype)
        if name.endswith("['scale']"):
            return (a + 0.2 * rng.normal(size=a.shape)).astype(a.dtype)
        return a
    return jax.tree_util.tree_map_with_path(fix, tree)


@pytest.mark.parametrize("kw", [dict(resolution=8, z_channels=5),
                                dict(resolution=16, z_channels=4, ch=32,
                                     dec_num_res_blocks=(2, 1))])
def test_decode_code_pixels_match(kw):
    jcfg = JMV.MagvitConfig.tiny(**kw)
    tcfg = TMV.MagvitConfig.tiny(**kw)
    tree = _perturb_norms(jax.tree.map(np.asarray,
                                      jax.jit(lambda k: JMV.init(k, jcfg))(jax.random.key(0))),
                          np.random.default_rng(0))
    side = jcfg.resolution // 2 ** (len(jcfg.dec_ch_mult) - 1)
    codes = np.random.default_rng(1).integers(0, jcfg.codebook_size, size=(2, side * side))
    ref = np.asarray(jax.jit(JMV.decode_code, static_argnums=1)(
        jax.tree.map(jnp.asarray, tree), jcfg, jnp.asarray(codes)))
    got = TMV.decode_code(W.magvit_from_jax(tree, tcfg), tcfg, torch.from_numpy(codes)).numpy()
    assert got.shape == (2, jcfg.resolution, jcfg.resolution, 3)
    # fp32 through ~10 convolutions and GroupNorms: only the order of sums differs
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4)


def test_lfq_codebook_entry_matches():
    codes = np.random.default_rng(2).integers(0, 2 ** 13, size=(3, 256))
    ref = np.asarray(JMV.lfq_codebook_entry(jnp.asarray(codes), 13))
    got = TMV.lfq_codebook_entry(torch.from_numpy(codes), 13).numpy()
    np.testing.assert_array_equal(got, ref)


def test_init_matches_jax_tree_layout():
    """init_magvit builds the JAX decoder's architecture, at the flagship widths too."""
    for jcfg, tcfg in ((JMV.MagvitConfig.tiny(), TMV.MagvitConfig.tiny()),
                       (JMV.MagvitConfig(), TMV.MagvitConfig())):
        shapes = jax.eval_shape(lambda k: JMV.init(k, jcfg), jax.random.key(0))["decoder"]
        ref = jax.tree.map(lambda a: tuple(a.shape), shapes)
        fresh = W.init_magvit(tcfg, torch.Generator().manual_seed(0), "meta")["decoder"]
        assert jax.tree.map(lambda a: tuple(a.shape), fresh) == ref
