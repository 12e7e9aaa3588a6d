"""The port's ops (unigen_tpu_torch.ops) against the JAX package's, on the CPU.

Inputs come from numpy seeds and go to both frameworks. The JAX Pallas
kernels run as the JAX tests run them off-TPU (interpret mode); the port's
wrappers take their plain versions because the tensors lie on the CPU.
Kernel-against-plain tests are in test_torch_kernels.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unigen_tpu.ops import masks as JM
from unigen_tpu.ops import sampling as JS
from unigen_tpu.ops.attention import dot_product_attention as j_dpa
from unigen_tpu.ops.chunk_attention import chunk_attention as j_chunk
from unigen_tpu.ops.flash_attention import flash_attention as j_flash
from unigen_tpu.ops.flash_attention import pack_meta as j_pack_meta
from unigen_tpu.ops import fused_conv as JFC
from unigen_tpu_torch.ops import masks as TM
from unigen_tpu_torch.ops import sampling as TS
from unigen_tpu_torch.ops.attention import dot_product_attention as t_dpa
from unigen_tpu_torch.ops.chunk_attention import chunk_attention, chunk_attention_plain
from unigen_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain
from unigen_tpu_torch.ops import fused_conv as TFC
from unigen_tpu_torch.weights import to_tensor

PAD, SOI, EOI = 900, 901, 902


def t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------

def test_safe_log_matches():
    x = np.array([0.0, 1e-30, 1e-5, 0.5, 1.0], np.float32)
    np.testing.assert_allclose(TS.safe_log(t(x)).numpy(), np.asarray(JS.safe_log(jnp.asarray(x))),
                               rtol=1e-6)


@pytest.mark.parametrize("temperature", [0.0, 0.7, 4.5])
def test_mask_by_random_topk_shared_noise(temperature):
    """Same uniforms, same probs -> the same re-masked positions."""
    rng = np.random.default_rng(0)
    b, n = 3, 40
    probs = rng.random((b, n), dtype=np.float32)
    probs[0, :5] = np.finfo(np.float32).max          # known tokens carry finfo.max
    mask_len = rng.integers(1, n - 1, size=(b, 1)).astype(np.float32)
    u = rng.random((b, n), dtype=np.float32)
    got = TS.mask_by_random_topk(None, t(mask_len), t(probs), temperature, noise=t(u))
    ref = JS.mask_by_random_topk(None, jnp.asarray(mask_len), jnp.asarray(probs),
                                 temperature, noise=jnp.asarray(u))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("method", ["cosine", "linear", "pow2.5", "sigmoid"])
def test_mask_schedules_match(method):
    """fp32 schedules agree to a few ulps (libm vs XLA transcendentals)."""
    tt = np.linspace(0.0, 1.0, 33, dtype=np.float32)
    got = TS.get_mask_schedule(method)(t(tt)).numpy()
    ref = np.asarray(JS.get_mask_schedule(method)(jnp.asarray(tt)))
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


def test_unknown_schedule_raises():
    with pytest.raises(ValueError):
        TS.get_mask_schedule("nope")


def test_gumbel_noise_from_generator():
    g1 = torch.Generator().manual_seed(3)
    g2 = torch.Generator().manual_seed(3)
    a = TS.gumbel_noise(g1, (4, 7), "cpu")
    b = TS.gumbel_noise(g2, (4, 7), "cpu")
    assert torch.isfinite(a).all() and torch.equal(a, b)


# ---------------------------------------------------------------------------
# masks
# ---------------------------------------------------------------------------

def _t2i_ids():
    return np.array([[PAD, PAD, 5, 6, SOI] + [10] * 9 + [EOI, 7],
                     [3, 4, 5, 6, SOI] + [11] * 9 + [EOI, 8],
                     [PAD, PAD, PAD, PAD, SOI] + [12] * 9 + [EOI, PAD]])


@pytest.mark.parametrize("rm_pad", [False, True])
def test_predict_next_mask_matches(rm_pad):
    ids = _t2i_ids()
    got = TM.create_attention_mask_predict_next(t(ids), PAD, SOI, EOI, rm_pad_in_image=rm_pad)
    ref = JM.create_attention_mask_predict_next(jnp.asarray(ids), PAD, SOI, EOI,
                                                rm_pad_in_image=rm_pad)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_meta_visibility_and_pack_match():
    ids = _t2i_ids()
    for tm, jm in ((TM.t2i_attn_meta(t(ids), PAD, SOI, EOI),
                    JM.t2i_attn_meta(jnp.asarray(ids), PAD, SOI, EOI)),
                   (TM.lm_attn_meta(t(ids), PAD), JM.lm_attn_meta(jnp.asarray(ids), PAD))):
        np.testing.assert_array_equal(tm.visibility().numpy(), np.asarray(jm.visibility()))
        np.testing.assert_array_equal(TM.pack_meta(tm).numpy(), np.asarray(j_pack_meta(jm)))
    seg = np.array([[0] * 8 + [1] * 8, [0] * 16, [2] * 16], np.int32)
    tm = TM.t2i_attn_meta(t(ids), PAD, SOI, EOI)._replace(seg=t(seg))
    jm = JM.t2i_attn_meta(jnp.asarray(ids), PAD, SOI, EOI)._replace(seg=jnp.asarray(seg))
    bits = TM.pack_meta(tm)
    np.testing.assert_array_equal(bits.numpy(), np.asarray(j_pack_meta(jm)))
    np.testing.assert_array_equal(TM.unpack_meta(bits).visibility().numpy(),
                                  np.asarray(jm.visibility()))


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def _qkv(b, lq, s, h, kvh, dh, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, lq, h, dh)).astype(np.float32),
            rng.normal(size=(b, s, kvh, dh)).astype(np.float32),
            rng.normal(size=(b, s, kvh, dh)).astype(np.float32))


def test_dot_product_attention_matches():
    q, k, v = _qkv(2, 16, 16, 4, 2, 8, 0)
    mask = np.asarray(JM.t2i_attn_meta(jnp.asarray(_t2i_ids()[:2]), PAD, SOI, EOI).visibility())
    got = t_dpa(t(q), t(k), t(v), mask=t(mask)).numpy()
    ref = np.asarray(j_dpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mask=jnp.asarray(mask)))
    # fp32 on both sides: only the order of the sums differs
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)


def _kvalid(b, s, seed):
    rng = np.random.default_rng(seed)
    kv = rng.random((b, s)) > 0.3
    kv[:, -5:] = True                                   # the chunk slots are always visible
    return kv


@pytest.mark.parametrize("shape", [(2, 10, 23, 4, 2, 16), (3, 7, 40, 6, 1, 8),
                                   (1, 12, 17, 4, 4, 32)])
def test_chunk_attention_plain_matches_jax_kernel(shape):
    b, lq, s, h, kvh, dh = shape
    q, k, v = _qkv(b, lq, s, h, kvh, dh, 1)
    kv = _kvalid(b, s, 2)
    got = chunk_attention(t(q), t(k), t(v), t(kv)).numpy()   # CPU tensors: plain version
    ref = np.asarray(j_chunk(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(kv)))
    # the JAX chunk test's tolerance (tests/test_chunk_attention.py): fp32 sums
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=2e-5)


def test_chunk_attention_masked_keys_inert_and_gqa():
    b, lq, s, h, kvh, dh = 2, 9, 21, 6, 2, 16
    q, k, v = _qkv(b, lq, s, h, kvh, dh, 3)
    kv = _kvalid(b, s, 4)
    base = chunk_attention_plain(t(q), t(k), t(v), t(kv))
    k2, v2 = k.copy(), v.copy()
    k2[~kv] = 1e3
    v2[~kv] = -1e3
    moved = chunk_attention_plain(t(q), t(k2), t(v2), t(kv))
    np.testing.assert_allclose(moved.numpy(), base.numpy(), atol=1e-6)
    # GQA routing: query head hh reads kv head hh // (h // kvh)
    rep = h // kvh
    full = chunk_attention_plain(t(q), t(np.repeat(k, rep, 2)), t(np.repeat(v, rep, 2)), t(kv))
    np.testing.assert_allclose(full.numpy(), base.numpy(), atol=1e-6)


def _flash_case(name):
    b, l = 2, 16
    z = np.zeros((b, l), bool)
    if name == "causal":
        return JM.AttnMeta(pad=jnp.asarray(z), bidir_q=jnp.asarray(z), bidir_k=jnp.asarray(z))
    if name == "t2i_omni":
        return JM.t2i_attn_meta(jnp.asarray(_t2i_ids()[:2]), PAD, SOI, EOI)
    if name == "all_pad_row":
        pad = z.copy()
        pad[0] = True
        pad[1, :3] = True
        return JM.AttnMeta(pad=jnp.asarray(pad), bidir_q=jnp.asarray(z), bidir_k=jnp.asarray(z))
    if name == "segments":
        seg = np.array([[0] * 6 + [1] * 10, [0] * 3 + [1] * 5 + [2] * 8], np.int32)
        bq = z.copy()
        bq[:, 9:12] = True
        return JM.AttnMeta(pad=jnp.asarray(z), bidir_q=jnp.asarray(bq),
                           bidir_k=jnp.asarray(z), seg=jnp.asarray(seg))
    if name == "uneven":
        z = np.zeros((1, 12), bool)
        bq = z.copy()
        bq[:, 4:8] = True
        return JM.AttnMeta(pad=jnp.asarray(z), bidir_q=jnp.asarray(bq), bidir_k=jnp.asarray(z))
    raise KeyError(name)


@pytest.mark.parametrize("name", ["causal", "t2i_omni", "all_pad_row", "segments", "uneven"])
def test_flash_attention_plain_matches_jax_kernel(name):
    meta = _flash_case(name)
    b, l = meta.pad.shape
    q, k, v = _qkv(b, l, l, 4, 2, 8, 5)
    bits = np.asarray(j_pack_meta(meta))
    ref = np.asarray(j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(bits),
                             block_q=8, interpret=True))
    got = flash_attention(t(q), t(k), t(v), t(bits)).numpy()  # CPU tensors: plain version
    # every row, pad rows included: a fully masked row is uniform over all keys
    # in both; fp32 sums, the JAX flash test's tolerance
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)
    assert np.isfinite(got).all()


def _conv_inputs(h, w, c, cout, seed, gn=True):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, h, w, c)).astype(np.float32)
    conv_p = {"kernel": (rng.normal(size=(3, 3, c, cout)) * 0.05).astype(np.float32),
              "bias": (rng.normal(size=(cout,)) * 0.1).astype(np.float32)}
    gn_p = ({"scale": (1 + 0.3 * rng.normal(size=(c,))).astype(np.float32),
             "bias": (0.1 * rng.normal(size=(c,))).astype(np.float32)} if gn else None)
    return x, conv_p, gn_p


def _jtree(p):
    return None if p is None else {k: jnp.asarray(v) for k, v in p.items()}


def _ttree(p):
    return None if p is None else {k: t(v) for k, v in p.items()}


@pytest.mark.parametrize("h,w,c,cout,gn", [(8, 8, 16, 16, True), (8, 16, 32, 16, True),
                                           (8, 8, 16, 32, False), (16, 8, 64, 64, True)])
def test_fused_conv_plain_matches_jax_kernel(h, w, c, cout, gn):
    x, conv_p, gn_p = _conv_inputs(h, w, c, cout, 7, gn)
    ref = np.asarray(JFC.conv3x3_gn_swish(_jtree(conv_p), _jtree(gn_p), jnp.asarray(x)))
    got = TFC.conv3x3_gn_swish(_ttree(conv_p), _ttree(gn_p), t(x)).numpy()
    # the JAX fused-conv test's tolerance (tests/test_fused_conv.py): fp32 sums
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4)


def test_gn_affine_matches_jax():
    x, _, gn_p = _conv_inputs(8, 8, 64, 16, 8)
    ref = np.asarray(JFC._gn_affine(_jtree(gn_p), jnp.asarray(x), 32, 1e-6))
    got = TFC.gn_affine(_ttree(gn_p), t(x), 32, 1e-6).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)


def test_bf16_leaves_convert_exactly():
    a = jnp.asarray(np.random.default_rng(9).normal(size=(5, 3)), jnp.bfloat16)
    got = to_tensor(np.asarray(a))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(a.astype(jnp.float32)))


def test_wrappers_take_plain_versions_on_cpu_without_counting():
    q, k, v = (t(a) for a in _qkv(1, 4, 8, 4, 2, 16, 6))
    kv = t(np.ones((1, 8), bool))
    bits = TM.pack_meta(TM.lm_attn_meta(t(np.ones((1, 4), np.int64)), 0))
    x, conv_p, gn_p = _conv_inputs(4, 4, 16, 16, 7)
    before = (chunk_attention.launches, flash_attention.launches,
              TFC.conv3x3_gn_swish.launches)
    torch.testing.assert_close(chunk_attention(q, k, v, kv), chunk_attention_plain(q, k, v, kv))
    torch.testing.assert_close(flash_attention(q, k[:, :4], v[:, :4], bits),
                               flash_attention_plain(q, k[:, :4], v[:, :4], bits))
    torch.testing.assert_close(TFC.conv3x3_gn_swish(_ttree(conv_p), _ttree(gn_p), t(x)),
                               TFC.conv3x3_gn_swish_plain(_ttree(conv_p), _ttree(gn_p), t(x)))
    assert (chunk_attention.launches, flash_attention.launches,
            TFC.conv3x3_gn_swish.launches) == before
