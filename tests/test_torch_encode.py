"""The port's MAGViTv2 encoder and LFQ quantizer against JAX ``models/magvit.py``,
fp32 on the CPU: latents within 1e-4, codes exact (a bit may differ only
where its latent lies within 1e-4 of zero), LFQ bit packing and the
straight-through signs exact, the LFQ losses within 1e-6, and the random
init's trees (the decoder of a seed unchanged by the encoder drawn after it).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unigen_tpu.models import magvit as JMV
from unigen_tpu_torch import weights as W
from unigen_tpu_torch.models import magvit as TMV
from unigen_tpu_torch.ops import fused_conv as FC

from test_torch_magvit import _perturb_norms

CONFIGS = [dict(resolution=8, z_channels=5),
           # two res-blocks at the first level, attention at the 8 x 8 level
           dict(resolution=16, z_channels=4, ch=32, enc_num_res_blocks=(2, 1),
                attn_resolutions=(8,))]


def _tree(kw, seed=0):
    jcfg = JMV.MagvitConfig.tiny(**kw)
    tree = _perturb_norms(jax.tree.map(np.asarray,
                                      jax.jit(lambda k: JMV.init(k, jcfg))(jax.random.key(seed))),
                          np.random.default_rng(seed))
    return jcfg, TMV.MagvitConfig.tiny(**kw), tree


def _pixels(res, b=2, seed=1):
    return np.random.default_rng(seed).uniform(-1, 1, size=(b, res, res, 3)).astype(np.float32)


@pytest.mark.parametrize("kw", CONFIGS)
def test_encoder_latents_and_codes_match(kw):
    jcfg, tcfg, tree = _tree(kw)
    px = _pixels(jcfg.resolution)
    jparams = jax.tree.map(jnp.asarray, tree)
    ref_z = np.asarray(jax.jit(JMV.encoder_forward, static_argnums=1)(
        jparams["encoder"], jcfg, jnp.asarray(px)))
    ref_codes = np.asarray(jax.jit(JMV.get_code, static_argnums=1)(jparams, jcfg,
                                                                   jnp.asarray(px)))
    tparams = W.magvit_from_jax(tree, tcfg)
    got_z = TMV.encoder_forward(tparams["encoder"], tcfg, torch.from_numpy(px)).numpy()
    side = jcfg.resolution // 2 ** (len(jcfg.enc_ch_mult) - 1)
    assert got_z.shape == (2, side, side, jcfg.z_channels)
    # fp32 through the convolutions and GroupNorms: only the order of sums differs
    np.testing.assert_allclose(got_z, ref_z, atol=1e-4, rtol=1e-4)
    got_codes = TMV.get_code(tparams, tcfg, torch.from_numpy(px))
    assert got_codes.dtype == torch.int32 and got_codes.shape == ref_codes.shape
    # a differing code may only come from a bit whose latent is a near-tie at 0
    shifts = np.arange(jcfg.z_channels - 1, -1, -1)
    flipped = ((got_codes.numpy()[..., None] >> shifts) & 1) != ((ref_codes[..., None] >> shifts) & 1)
    near_zero = np.abs(ref_z.reshape(2, -1, jcfg.z_channels)) < 1e-4
    assert not (flipped & ~near_zero).any()
    _, idx = TMV.encode(tparams, tcfg, torch.from_numpy(px))
    assert torch.equal(idx, got_codes)


def test_lfq_quantize_and_indices_exact():
    rng = np.random.default_rng(3)
    z = rng.normal(size=(2, 4, 4, 13)).astype(np.float32)
    z[0, 0, 0, :4] = [0.0, -0.0, 1e-30, -1e-30]
    ref_q = np.asarray(JMV.lfq_quantize(jnp.asarray(z)))
    got_q = TMV.lfq_quantize(torch.from_numpy(z)).numpy()
    np.testing.assert_array_equal(got_q, ref_q)
    np.testing.assert_array_equal(TMV.lfq_indices(torch.from_numpy(got_q), 13).numpy(),
                                  np.asarray(JMV.lfq_indices(jnp.asarray(ref_q), 13)))
    # the codebook entry of the indices gives the signs back
    idx = TMV.lfq_indices(torch.from_numpy(got_q), 13).reshape(2, -1)
    np.testing.assert_array_equal(TMV.lfq_codebook_entry(idx, 13).numpy(), np.sign(got_q))


def test_lfq_quantize_is_straight_through():
    z = torch.tensor([-0.7, 0.0, 0.2, 3.0], requires_grad=True)
    q = TMV.lfq_quantize(z)
    q.sum().backward()
    assert torch.equal(q.detach(), torch.tensor([-1.0, -1.0, 1.0, 1.0]))
    assert torch.equal(z.grad, torch.ones(4))


@pytest.mark.parametrize("beta", [0.25, 1.0])
def test_lfq_losses_match(beta):
    z = np.random.default_rng(4).normal(size=(2, 4, 4, 13)).astype(np.float32) * 1.5
    ref = JMV.lfq_losses(jnp.asarray(z), beta=beta)
    got = TMV.lfq_losses(torch.from_numpy(z), beta=beta)
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(got[k].item(), float(ref[k]), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("shape", [(2, 8, 8, 16), (1, 7, 5, 8)])
def test_downsample_matches(shape):
    rng = np.random.default_rng(5)
    x = rng.normal(size=shape).astype(np.float32)
    c = shape[-1]
    p = {"conv": {"kernel": (rng.normal(size=(3, 3, c, c)) * 0.2).astype(np.float32),
                  "bias": rng.normal(size=(c,)).astype(np.float32)}}
    ref = np.asarray(JMV.downsample(jax.tree.map(jnp.asarray, p), jnp.asarray(x)))
    got = TMV.downsample(jax.tree.map(torch.from_numpy, p), torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (shape[0], shape[1] // 2, shape[2] // 2, c)
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)


def test_conv2d_rejects_unknown_padding():
    p = {"kernel": torch.zeros(3, 3, 2, 2), "bias": torch.zeros(2)}
    with pytest.raises(ValueError, match="padding"):
        FC.conv2d(p, torch.zeros(1, 4, 4, 2), padding="FULL")


def test_init_matches_jax_encoder_layout():
    """init_magvit builds the JAX encoder's architecture, at the flagship widths too."""
    for jcfg, tcfg in ((JMV.MagvitConfig.tiny(), TMV.MagvitConfig.tiny()),
                       (JMV.MagvitConfig(), TMV.MagvitConfig())):
        shapes = jax.eval_shape(lambda k: JMV.init(k, jcfg), jax.random.key(0))["encoder"]
        ref = jax.tree.map(lambda a: tuple(a.shape), shapes)
        fresh = W.init_magvit(tcfg, torch.Generator().manual_seed(0), "meta")["encoder"]
        assert jax.tree.map(lambda a: tuple(a.shape), fresh) == ref


def test_init_decoder_unchanged_by_encoder():
    """The decoder is drawn first: its leaves at seed 0 are those of the
    decoder-only init before the encoder came (values recorded from it), and
    an encoder of another shape leaves them as they are."""
    cfg = TMV.MagvitConfig.tiny(resolution=8, z_channels=5)
    dec = W.init_magvit(cfg, torch.Generator().manual_seed(0), "cpu")["decoder"]
    assert dec["post_quant_conv"]["kernel"].flatten()[0].item() == pytest.approx(
        -0.5034908652305603, abs=1e-7)
    for leaf, total in ((dec["conv_in"]["kernel"], 1.1465648518205853),
                        (dec["up"][1]["upsample"]["conv"]["kernel"], 7.122345829104688),
                        (dec["conv_out"]["kernel"], 0.10599695424025413)):
        assert leaf.double().sum().item() == pytest.approx(total, abs=1e-5)
    other = TMV.MagvitConfig.tiny(resolution=8, z_channels=5, enc_num_res_blocks=(3, 2))
    dec2 = W.init_magvit(other, torch.Generator().manual_seed(0), "cpu")["decoder"]
    assert _trees_equal(dec, dec2)


def _trees_equal(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_trees_equal(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(_trees_equal(x, y) for x, y in zip(a, b))
    return torch.equal(a, b)


def test_magvit_from_jax_carries_both_halves():
    jcfg, tcfg, tree = _tree(CONFIGS[0])
    got = W.magvit_from_jax(tree, tcfg)
    assert set(got) == {"encoder", "decoder"}
    np.testing.assert_array_equal(got["encoder"]["quant_conv"]["kernel"].numpy(),
                                  tree["encoder"]["quant_conv"]["kernel"])
