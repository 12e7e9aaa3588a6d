"""The port's W4A8 path (``ops.quantization``, ``ops.int4``, the quantized
Qwen2 routing) against the JAX package, on the CPU in fp32.

* ``pack_int4`` and ``quantize_activations`` are bit-identical;
* ``w4a8_matmul_plain`` agrees with JAX's Pallas kernel run in interpret
  mode within 1e-6 of the output's largest magnitude: both sum each group
  exactly in integers, but XLA:CPU does not round the fp32 scale fold
  ``acc + part * scale`` one operation at a time in group order (measured:
  about 8% of the outputs differ in the last bit or two, emulating a fused
  multiply-add does not remove it), so only the fold's rounding differs, at
  most about one ulp per group;
* a tree that JAX packed loads unchanged through ``weights.py`` and equals
  the port's own packing of the same float weights;
* the tiny backbone packed by JAX (group 32) gives JAX's hidden states within
  1e-5 at the prefill and at one cached decode step, token by token, and the
  W4A8 head gives JAX's logits with and without ``vocab_slice``. fp32 sums
  run in another order in the two frameworks, so an activation that lands
  within ~1e-6 of an int8 rounding boundary can take the other int8 value
  and move its whole token (measured: one token of 27 at the prefill below,
  by 7e-3). ``_match_but_flips`` holds every other token to 1e-5 and the
  flipped one to a cosine of 0.999 with JAX's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unigen_tpu.models import qwen2 as JQ
from unigen_tpu.models import unigen as JU
from unigen_tpu.ops import int4 as J4
from unigen_tpu.ops.quantization import quantize_activations as j_quantize_activations
from unigen_tpu_torch import weights as W
from unigen_tpu_torch.models import qwen2 as TQ
from unigen_tpu_torch.models import unigen as TU
from unigen_tpu_torch.ops import int4 as T4
from unigen_tpu_torch.ops import masks as TM
from unigen_tpu_torch.ops.quantization import quantize_activations

from test_torch_qwen2 import _perturb

SHAPES = [(5, 128, 96, 32), (32, 512, 512, 256), (1, 256, 1000, 64), (3, 64, 100, 16)]


def _w(k, n, seed):
    return np.random.default_rng(seed).normal(size=(k, n)).astype(np.float32)


@pytest.mark.parametrize("t,k,n,group", SHAPES)
def test_pack_int4_bit_identical(t, k, n, group):
    w = _w(k, n, 0)
    jp, js = J4.pack_int4(jnp.asarray(w), group)
    tp, ts = T4.pack_int4(torch.from_numpy(w), group)
    assert tp.dtype == torch.int8 and tp.shape == (k // 2, -(-n // 512) * 512)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("t,k,n,group", SHAPES)
def test_w4a8_plain_matches_jax_kernel(t, k, n, group):
    packed, scale = J4.pack_int4(jnp.asarray(_w(k, n, 1)), group)
    x8 = np.random.default_rng(2).integers(-127, 128, size=(t, k)).astype(np.int8)
    want = np.asarray(J4.w4a8_matmul(jnp.asarray(x8), packed, scale, group=group,
                                     interpret=True))
    got = T4.w4a8_matmul(torch.from_numpy(x8), torch.from_numpy(np.array(packed)),
                         torch.from_numpy(np.array(scale)), group=group)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6 * np.abs(want).max(), rtol=0)


@pytest.mark.parametrize("shape", [(4, 7, 64), (2, 300)])
def test_quantize_activations_bit_identical(shape):
    x = np.random.default_rng(3).normal(size=shape).astype(np.float32) * 3
    x[0, ...] = 0.0                                    # an all-zero token: scale floor
    jx, js = j_quantize_activations(jnp.asarray(x))
    tx, ts = quantize_activations(torch.from_numpy(x))
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_dense_int4_matches_jax():
    rng = np.random.default_rng(4)
    p = {"kernel": rng.normal(size=(128, 96)).astype(np.float32) * 0.05,
         "bias": rng.normal(size=(96,)).astype(np.float32) * 0.01}
    x = rng.normal(size=(3, 7, 128)).astype(np.float32)
    want = np.asarray(J4.dense_int4(J4.quantize_dense_int4(
        {k: jnp.asarray(v) for k, v in p.items()}, group=64), jnp.asarray(x)))
    tp = T4.quantize_dense_int4({k: torch.from_numpy(v) for k, v in p.items()}, group=64)
    got = T4.dense_int4(tp, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-6)
    # a layer without a bias gets a zero fp32 bias of the unpadded width
    nb = T4.quantize_dense_int4({"kernel": torch.from_numpy(p["kernel"])}, group=64)
    assert nb["bias"].dtype == torch.float32 and nb["bias"].shape == (96,)
    assert not nb["bias"].any()


def _match_but_flips(got, want, max_flipped):
    """Tokens (rows over the last axis) agree within 1e-5, except at most
    ``max_flipped`` tokens moved by an int8 rounding flip, which stay close."""
    got, want = got.reshape(-1, got.shape[-1]), want.reshape(-1, want.shape[-1])
    ok = np.isclose(got, want, atol=1e-5, rtol=1e-5).all(axis=-1)
    assert (~ok).sum() <= max_flipped, f"{(~ok).sum()} tokens differ"
    for g, w in zip(got[~ok], want[~ok]):
        assert (g * w).sum() / (np.linalg.norm(g) * np.linalg.norm(w)) > 0.999


@pytest.fixture(scope="module")
def model():
    jcfg = JU.UniGenConfig.tiny()
    tree = _perturb(jax.tree.map(np.asarray, JU.init(jax.random.key(0), jcfg)),
                    np.random.default_rng(0))
    jq = J4.quantize_unigen_params_int4(jax.tree.map(jnp.asarray, tree), jcfg, group=32)
    tcfg = TU.UniGenConfig.tiny()
    tq = W.unigen_from_jax(jax.tree.map(np.asarray, jq), tcfg)
    return jcfg, jq, tcfg, tq, W.unigen_from_jax(tree, tcfg)


def test_jax_packed_tree_loads_unchanged(model):
    jcfg, jq, tcfg, tq, tfloat = model
    jl = jq["llm"]["layers"]
    for i, lp in enumerate(tq["llm"]["layers"]):
        assert "q_w" not in lp and "down_w" not in lp
        for name, group in (("q", "attn"), ("o", "attn"), ("up", "mlp"), ("down", "mlp")):
            for leaf in ("kernel_int4", "scale4", "bias"):
                np.testing.assert_array_equal(lp[name][leaf].numpy(),
                                              np.asarray(jl[group][name][leaf])[i])
    # the port's packing of the same float weights is the same tree, bit for bit
    ours = T4.quantize_unigen_params_int4(tfloat, tcfg, group=32)
    for a, b in zip(ours["llm"]["layers"], tq["llm"]["layers"]):
        for name in ("q", "k", "v", "o", "gate", "up", "down"):
            for leaf in ("kernel_int4", "scale4", "bias"):
                assert torch.equal(a[name][leaf], b[name][leaf]), (name, leaf)
    for leaf in ("kernel_int4", "scale4", "bias"):
        assert torch.equal(ours["llm"]["lm_head_q"][leaf], tq["llm"]["lm_head_q"][leaf])


def test_w4a8_backbone_prefill_and_decode_step_match_jax(model):
    jcfg, jq, tcfg, tq, _ = model
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
    _match_but_flips(th.numpy(), np.asarray(jh), max_flipped=1)

    tok = np.array([[7], [8], [9]])
    valid = np.arange(total)[None].repeat(rb, 0) <= lp
    jh2, _ = JQ.forward(jq["llm"], jcfg.llm, input_ids=jnp.asarray(tok),
                        mask=jnp.asarray(valid[:, None, None, :]),
                        positions=jnp.full((rb, 1), lp), cache=jc)
    th2, _ = TQ.forward(tq["llm"], tcfg.llm, input_ids=torch.from_numpy(tok),
                        positions=torch.full((rb, 1), lp), cache=tc,
                        kv_rowmask=torch.from_numpy(valid))
    _match_but_flips(th2.numpy(), np.asarray(jh2), max_flipped=1)


@pytest.mark.parametrize("vocab_slice", [None, (128, 160)])
def test_w4a8_head_logits_match_jax(model, vocab_slice):
    jcfg, jq, tcfg, tq, _ = model
    h = np.random.default_rng(6).normal(size=(2, 3, tcfg.llm.hidden_size)).astype(np.float32)
    want = np.asarray(JQ.logits(jq["llm"], jcfg.llm, jnp.asarray(h), vocab_slice=vocab_slice))
    got = TQ.logits(tq["llm"], tcfg.llm, torch.from_numpy(h), vocab_slice=vocab_slice)
    width = tcfg.vocab_size if vocab_slice is None else vocab_slice[1] - vocab_slice[0]
    assert got.shape == (2, 3, width)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-6)


def test_float_head_logits_match_jax(model):
    jcfg, _, tcfg, _, tfloat = model
    jtree = JU.init(jax.random.key(0), jcfg)
    tfloat = W.unigen_from_jax(jax.tree.map(np.asarray, jtree), tcfg)
    h = np.random.default_rng(7).normal(size=(2, tcfg.llm.hidden_size)).astype(np.float32)
    for sl in (None, (128, 160)):
        np.testing.assert_allclose(
            TQ.logits(tfloat["llm"], tcfg.llm, torch.from_numpy(h), vocab_slice=sl).numpy(),
            np.asarray(JQ.logits(jtree["llm"], jcfg.llm, jnp.asarray(h), vocab_slice=sl)),
            atol=1e-5, rtol=1e-5)


def test_unported_quantized_leaves_raise(model):
    """int8 layers are ported (tests/test_torch_int8.py); a quantized layer
    with LoRA adapters is not, and raises."""
    _, _, tcfg, tq, _ = model
    bad = dict(tq["llm"])
    bad["layers"] = [dict(lp) for lp in tq["llm"]["layers"]]
    bad["layers"][0]["o"] = dict(bad["layers"][0]["o"], lora_a=torch.zeros(1),
                                 lora_b=torch.zeros(1), lora_scale=torch.ones(()))
    with pytest.raises(NotImplementedError):
        TQ.forward(bad, tcfg.llm, input_ids=torch.ones((1, 3), dtype=torch.long),
                   mask=torch.ones((1, 1, 3, 3), dtype=torch.bool))
