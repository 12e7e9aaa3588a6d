"""The port's SigLIP2-NaFlex tower against the JAX package (CPU, fp32).

Weights are the JAX init with perturbed biases and norm scales, carried
across by ``weights.siglip2_from_jax``. The tower is compared on every row,
pad rows included (both mask keys only), at the SigLIP tests' 1e-5; the
position-embedding resize at JAX's own test tolerance (atol 2e-5, rtol
1e-4), since the port resizes with ``F.interpolate`` where JAX uses
``jax.image.resize``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unigen_tpu.models import siglip2 as JS2
from unigen_tpu.ops.attention import dot_product_attention
from unigen_tpu_torch import launch as TL
from unigen_tpu_torch import weights as W
from unigen_tpu_torch.models import builder as TB
from unigen_tpu_torch.models import siglip2 as TS2
from unigen_tpu_torch.ops import chunk_attention as CA
from unigen_tpu_torch.utils.configuration import initialize_config

from test_torch_qwen2 import _perturb

# rows of 6, 16 and 1 valid patches (2 x 3, 4 x 4, 1 x 1) padded to 16
SHAPES = np.array([[2, 3], [4, 4], [1, 1]])


def _tower(**kw):
    jcfg, tcfg = JS2.Siglip2Config.tiny(**kw), TS2.Siglip2Config.tiny(**kw)
    tree = _perturb(jax.tree.map(np.asarray, JS2.init(jax.random.key(2), jcfg)),
                    np.random.default_rng(1))
    return jcfg, jax.tree.map(jnp.asarray, tree), tcfg, W.siglip2_from_jax(tree, tcfg), tree


def _ragged_inputs(cfg, shapes=SHAPES, seed=3):
    n = cfg.num_patches
    rng = np.random.default_rng(seed)
    pix = rng.uniform(-1, 1, size=(len(shapes), n, cfg.patch_dim)).astype(np.float32)
    mask = np.zeros((len(shapes), n), np.int32)
    for i, (h, w) in enumerate(shapes):
        mask[i, :h * w] = 1
        pix[i, h * w:] = 0.0
    return pix, mask


def test_patchify_matches_jax():
    rng = np.random.default_rng(0)
    for hw in ((12, 8), (13, 9), (4, 4)):
        img = rng.normal(size=hw + (3,)).astype(np.float32)
        got, want = TS2.patchify(img, 4), JS2.patchify(img, 4)
        assert got[1] == want[1]
        np.testing.assert_array_equal(got[0], want[0])
    patches, (h, w) = TS2.patchify(np.arange(8 * 8 * 3, dtype=np.float32).reshape(8, 8, 3), 4)
    assert (h, w) == (2, 2) and patches.shape == (4, 48)


def test_resize_positional_embeddings_matches_jax():
    pos = np.random.default_rng(0).normal(size=(16, 32)).astype(np.float32)   # a 4 x 4 grid
    shapes = np.array([[2, 3], [4, 4], [1, 5], [6, 2], [2, 3]])
    want = JS2.resize_positional_embeddings(pos, shapes, max_length=16)
    got = TS2.resize_positional_embeddings(torch.from_numpy(pos), shapes, 16)
    assert got.shape == (5, 16, 32) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=1e-4)
    for i, (h, w) in enumerate(shapes):        # pads repeat entry 0
        assert torch.equal(got[i, h * w:], got[i, :1].expand(16 - h * w, 32))


@pytest.mark.parametrize("dh", [8, 72])
def test_key_masked_attention_matches_jax(dh):
    """Kernel 1's plain version with the head dim padded to the kernel's
    against JAX's key-masked attention (``mask = keep[:, None, None, :]``),
    pad query rows included."""
    rng = np.random.default_rng(4)
    q, k, v = (rng.normal(size=(3, 16, 2, dh)).astype(np.float32) for _ in range(3))
    _, mask = _ragged_inputs(TS2.Siglip2Config.tiny(), seed=4)
    keep = mask.astype(bool)
    want = np.asarray(dot_product_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                            mask=jnp.asarray(keep)[:, None, None, :]))
    got = TS2._key_masked_attention(torch.from_numpy(keep))(
        *(torch.from_numpy(t) for t in (q, k, v)), dh ** -0.5)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    # the padded head dim changes nothing beside the unpadded plain version
    plain = CA.chunk_attention_plain(*(torch.from_numpy(t) for t in (q, k, v)),
                                     torch.from_numpy(keep))
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("kw", [{}, {"num_attention_heads": 2, "hidden_size": 48}],
                         ids=["tiny", "two_heads"])
def test_tower_matches_jax(kw):
    """``forward`` against JAX's on ragged rows, every position (pads too)."""
    jcfg, jparams, tcfg, tparams, _ = _tower(**kw)
    pix, mask = _ragged_inputs(jcfg)
    want = np.asarray(JS2.forward(jparams, jcfg, jnp.asarray(pix), jnp.asarray(mask), SHAPES))
    got = TS2.forward(tparams, tcfg, torch.from_numpy(pix), torch.from_numpy(mask), SHAPES)
    assert got.shape == (3, jcfg.num_patches, jcfg.hidden_size)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_forward_with_pos_matches_jax():
    """The pre-resized entry: equal to ``forward`` and to JAX's
    ``forward_with_pos`` on the same position embeddings."""
    jcfg, jparams, tcfg, tparams, tree = _tower()
    pix, mask = _ragged_inputs(jcfg, seed=5)
    pos = TS2.resize_positional_embeddings(tparams["pos_embed"], SHAPES, jcfg.num_patches)
    got = TS2.forward_with_pos(tparams, tcfg, torch.from_numpy(pix), torch.from_numpy(mask), pos)
    assert torch.equal(got, TS2.forward(tparams, tcfg, torch.from_numpy(pix),
                                        torch.from_numpy(mask), SHAPES))
    want = np.asarray(JS2.forward_with_pos(jparams, jcfg, jnp.asarray(pix), jnp.asarray(mask),
                                           jnp.asarray(pos.numpy())))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_weight_round_trip_and_init():
    """``siglip2_to_jax`` inverts ``siglip2_from_jax`` exactly; ``init_siglip2``
    draws JAX's shapes, finite, with the configured layers."""
    _, _, tcfg, tparams, tree = _tower()
    back = W.siglip2_to_jax(tparams, tcfg)
    flat_t = jax.tree_util.tree_flatten_with_path(back)[0]
    flat_j = dict(jax.tree_util.tree_flatten_with_path(tree)[0])
    assert len(flat_t) == len(flat_j)
    for path, leaf in flat_t:
        np.testing.assert_array_equal(leaf.numpy(), flat_j[path], err_msg=str(path))
    gen = torch.Generator().manual_seed(0)
    init = W.init_siglip2(tcfg, gen, "cpu")
    jshapes = jax.tree.map(lambda a: a.shape, tree)
    assert jax.tree.map(lambda t: tuple(t.shape), W.siglip2_to_jax(init, tcfg)) == \
        jax.tree.map(tuple, jshapes, is_leaf=lambda x: isinstance(x, tuple))
    assert len(init["layers"]) == tcfg.num_layers_used == 2
    assert all(torch.isfinite(t).all() for t in jax.tree.leaves(init))


def test_builder_dispatches_naflex(tmp_path):
    """The NaFlex name gives the port's module and the so400m-patch16 shape;
    the launch builds it from a config, skipping a size the config lacks
    (``image_size``) as JAX does, and runs it."""
    mod, cfg = TB.get_vision_tower_config("siglip2-so400m-patch16-naflex")
    assert mod is TS2 and isinstance(cfg, TS2.Siglip2Config)
    assert (cfg.num_patches, cfg.patch_size, cfg.hidden_size, cfg.intermediate_size,
            cfg.num_attention_heads, cfg.num_layers_used) == (256, 16, 1152, 4304, 16, 26)
    assert TB.get_vision_tower_config("google/siglip-so400m-patch14-384")[0] is not TS2
    path = tmp_path / "c.yaml"
    path.write_text("model:\n  vision_tower:\n    name: siglip2-so400m-patch16-naflex\n"
                    "    hidden_size: 32\n    intermediate_size: 64\n    num_hidden_layers: 3\n"
                    "    num_attention_heads: 4\n    patch_size: 4\n    image_size: 999\n")
    config = initialize_config(str(path), [])
    vcfg = TL.vision_tower_config(config)
    assert isinstance(vcfg, TS2.Siglip2Config) and not hasattr(vcfg, "image_size")
    assert (vcfg.hidden_size, vcfg.patch_size, vcfg.num_layers_used) == (32, 4, 2)
    params, vcfg = TL.build_vision_tower(config, device="cpu")
    pix, mask = _ragged_inputs(vcfg)            # 256 slots: the flagship's patch budget
    out = TS2.forward(params, vcfg, torch.from_numpy(pix), torch.from_numpy(mask), SHAPES)
    assert out.shape == (3, 256, 32) and torch.isfinite(out).all()
