"""The port's LoRA / QLoRA against the JAX package's, on the CPU in fp32.

tests/test_lora.py on the port, each also held against JAX: the adapters
carried both ways (the port's per-layer leaves <-> JAX's stacked ones),
zero-init identity, the runtime path against the merged weights, strip,
subset targets and their parameter count, the QLoRA int8 and int4 forwards
(the quantized base rides the forward; its backward raises), the
adapter-only update and weight decay, the optimizer masks on the adapters,
the cached decode, and a remat step's adapter gradients.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from test_torch_int4 import _match_but_flips
from test_torch_training import _perturb, _tree_from_leaves
from unigen_tpu.models import qwen2 as JQ
from unigen_tpu.models import unigen as JU
from unigen_tpu.ops import int4 as JI4
from unigen_tpu.ops import quantization as JQZ
from unigen_tpu.training import lora as JL
from unigen_tpu.training import optimizer as JO
from unigen_tpu_torch import weights as W
from unigen_tpu_torch.models import qwen2 as TQ
from unigen_tpu_torch.models import unigen as TU
from unigen_tpu_torch.ops import int4 as TI4
from unigen_tpu_torch.ops import quantization as TQZ
from unigen_tpu_torch.training import lora as TL
from unigen_tpu_torch.training import lr_schedules as TLRS
from unigen_tpu_torch.training import optimizer as TO
from unigen_tpu_torch.training.sft import _leaf_grads


def _randomize_b(tree, key, scale=0.05):
    """JAX's helper: nonzero lora_b so that the adapters act."""
    def walk(t, key):
        if not isinstance(t, dict):
            return t
        out = {}
        for k, v in t.items():
            key, sub = jax.random.split(key)
            out[k] = (jax.random.normal(sub, v.shape, jnp.float32).astype(v.dtype) * scale
                      if k == "lora_b" else walk(v, sub))
        return out
    return walk(tree, key)


@pytest.fixture(scope="module")
def base():
    jcfg = JU.UniGenConfig.tiny()
    tree = _perturb(jax.tree.map(np.asarray, JU.init(jax.random.key(0), jcfg)),
                    np.random.default_rng(0))
    ids = np.random.default_rng(0).integers(0, 150, size=(2, 10))
    return jcfg, TU.UniGenConfig.tiny(), jax.tree.map(jnp.asarray, tree["llm"]), ids


def _port(jllm, tcfg):
    """A JAX Qwen2 tree (adapters included) in the port's layout."""
    return W.unigen_from_jax({"llm": jax.tree.map(np.asarray, jllm)}, tcfg)["llm"]


def _jlogits_traced(params, cfg, ids):
    hidden, _ = JQ.forward(params, cfg, input_ids=jnp.asarray(ids))
    return JQ.logits(params, cfg, hidden)


def _jlogits(params, cfg, ids):
    return np.asarray(_jlogits_traced(params, cfg, ids))


def _tlogits(params, cfg, ids):
    hidden, _ = TQ.forward(params, cfg, input_ids=torch.as_tensor(ids))
    return TQ.logits(params, cfg, hidden)


def test_adapters_carried_and_runtime_matches_jax(base):
    """JAX's adapted tree -> the port (per-layer leaves) -> back, bit for
    bit; the runtime forward against JAX's (1e-5) and against the merged
    weights (1e-4, tests/test_lora.py); the port's merge equals JAX's."""
    jcfg, tcfg, jllm, ids = base
    jad = _randomize_b(JL.add_lora(jllm, jax.random.key(1), rank=4, alpha=8.0,
                                   dtype=jnp.float32), jax.random.key(2))
    tad = _port(jad, tcfg)
    lp = tad["layers"][1]
    assert lp["q_lora_a"].shape == (64, 4) and lp["down_lora_b"].shape == (4, 64)
    assert float(lp["v_lora_scale"]) == 2.0 and lp["v_lora_scale"].dtype == torch.float32
    back = W.unigen_to_jax({"llm": tad}, tcfg)["llm"]["layers"]
    for group, name in (("attn", "q"), ("mlp", "down")):
        for k in ("lora_a", "lora_b", "lora_scale"):
            np.testing.assert_array_equal(back[group][name][k].numpy(),
                                          np.asarray(jad["layers"][group][name][k]))
    got = _tlogits(tad, tcfg.llm, ids).detach().numpy()
    np.testing.assert_allclose(got, _jlogits(jad, jcfg.llm, ids), atol=1e-5, rtol=1e-5)
    merged = TL.merge_lora(tad)
    assert not any(TL.is_lora_leaf(k) for lp in merged["layers"] for k in lp)
    np.testing.assert_allclose(_tlogits(merged, tcfg.llm, ids).numpy(), got, atol=1e-4,
                               rtol=1e-4)
    jm = _port(JL.merge_lora(jad), tcfg)
    for a, b in zip(merged["layers"], jm["layers"]):
        for k in a:
            torch.testing.assert_close(a[k], b[k], atol=1e-7, rtol=1e-6)
    assert not np.allclose(got, _tlogits(_port(jllm, tcfg), tcfg.llm, ids).numpy(), atol=1e-3)


def test_zero_init_identity_strip_and_subset(base):
    """The port's own ``add_lora``: the base's logits at init (1e-6), the
    input tree unchanged, strip back to the base tree; a q/v subset and its
    parameter count equal JAX's."""
    jcfg, tcfg, jllm, ids = base
    tbase = _port(jllm, tcfg)
    gen = torch.Generator().manual_seed(1)
    ad = TL.add_lora(tbase, gen, rank=4, dtype=torch.float32)
    np.testing.assert_allclose(_tlogits(ad, tcfg.llm, ids).numpy(),
                               _tlogits(tbase, tcfg.llm, ids).numpy(), atol=1e-6, rtol=1e-6)
    assert "q_lora_a" not in tbase["layers"][0]
    stripped = TL.strip_lora(ad)
    assert [sorted(lp) for lp in stripped["layers"]] == [sorted(lp) for lp in tbase["layers"]]
    sub = TL.add_lora(tbase, gen, rank=2, targets=("attn/q", "attn/v"), dtype=torch.float32)
    assert "q_lora_a" in sub["layers"][0] and "k_lora_a" not in sub["layers"][0]
    jsub = JL.add_lora(jllm, jax.random.key(1), rank=2, targets=("attn/q", "attn/v"),
                       dtype=jnp.float32)
    assert TL.lora_param_count(sub) == JL.lora_param_count(jsub) == 2 * (64 * 2 + 2 * 64
                                                                         + 64 * 2 + 2 * 32 + 2)
    with pytest.raises(ValueError, match="unknown LoRA target"):
        TL.add_lora(tbase, gen, rank=2, targets=("attn/qkv",))


@pytest.mark.parametrize("quant", ["int8", "int4"])
def test_qlora_forward_matches_jax_and_backward_raises(base, quant):
    """QLoRA over a W8A8 or W4A8 base (both orders: quantize then add, add
    then quantize): zero adapters give the quantized base (1e-6), nonzero
    ones JAX's QLoRA logits (1e-5 but one int8 rounding flip); a backward
    through the quantized base raises, naming the ROADMAP item; merging
    refuses."""
    jcfg, tcfg, jllm, ids = base
    jq = (JQZ.quantize_qwen2_params if quant == "int8"
          else lambda p: JI4.quantize_qwen2_params_int4(p, group=32))
    tq = (TQZ.quantize_qwen2_params if quant == "int8"
          else lambda p: TI4.quantize_qwen2_params_int4(p, group=32))
    tbase = _port(jllm, tcfg)
    q_base = tq(tbase)
    base_out = _tlogits(q_base, tcfg.llm, ids).numpy()
    gen = torch.Generator().manual_seed(1)
    for tree in (TL.add_lora(q_base, gen, rank=4, dtype=torch.float32),
                 tq(TL.add_lora(tbase, gen, rank=4, dtype=torch.float32))):
        np.testing.assert_allclose(_tlogits(tree, tcfg.llm, ids).numpy(), base_out, atol=1e-6)
    # add then quantize: JAX's add_lora reads no int4 node
    jad = _randomize_b(jq(JL.add_lora(jllm, jax.random.key(1), rank=4, dtype=jnp.float32)),
                       jax.random.key(2))
    tad = _port(jad, tcfg)
    got = _tlogits(tad, tcfg.llm, ids).numpy()
    _match_but_flips(got, _jlogits(jad, jcfg.llm, ids), max_flipped=1)
    assert not np.allclose(got, base_out, atol=1e-3)
    adapters = [t.requires_grad_(True) for lp in tad["layers"] for k, t in lp.items()
                if k.endswith(("_lora_a", "_lora_b"))]
    loss = _tlogits(tad, tcfg.llm, ids).sum()
    with pytest.raises(NotImplementedError, match="Queue 1 item 17"):
        loss.backward()
    assert adapters
    with pytest.raises(ValueError, match="quantized"):
        TL.merge_lora(tad)


@pytest.mark.parametrize("quant", ["int8", "int4"])
def test_qlora_jax_grad_raises_too(base, quant):
    """The port's refused QLoRA backward is parity: JAX's steps take
    ``jax.value_and_grad`` over the whole tree (training/sft.py, dpo.py,
    train_step.py), and on the same QLoRA tree that raises too, on the
    quantized base's integer leaves."""
    jcfg, _, jllm, ids = base
    jq = (JQZ.quantize_qwen2_params if quant == "int8"
          else lambda p: JI4.quantize_qwen2_params_int4(p, group=32))
    jad = _randomize_b(jq(JL.add_lora(jllm, jax.random.key(1), rank=4, dtype=jnp.float32)),
                       jax.random.key(2))
    with pytest.raises(TypeError, match="int8"):
        jax.grad(lambda p: _jlogits_traced(p, jcfg.llm, ids).sum())(jad)


def _ce(params, cfg, ids):
    logits = _tlogits(params, cfg, ids)
    labels = torch.roll(torch.as_tensor(ids), -1, dims=1)
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]), labels.reshape(-1))


def _trainable_port(tad, tx):
    tree = W.map_tree(tad, lambda t: t.detach().clone())
    for (_, t), train in zip(TO.named_leaves(tree), tx.trainable):
        t.requires_grad_(train)
    return tree


def test_adapter_only_update_and_masks_match_jax(base):
    """tests/test_lora.py::test_training_updates_only_adapters: with
    ``lora_tunable_parts`` only a and b train (JAX's trainable and decay
    masks, leaf for leaf), a frozen leaf gets no gradient and does not move,
    b moves; the adapters' gradients equal JAX's (1e-4 of the largest)."""
    jcfg, tcfg, jllm, ids = base
    jad = JL.add_lora(jllm, jax.random.key(1), rank=4, dtype=jnp.float32)
    tad = {"llm": _port(jad, tcfg)}
    tx = TO.make_optimizer(tad, 1e-2, TLRS.get_scheduler("constant"), weight_decay=0.0,
                           tunable_parts=TL.lora_tunable_parts())
    jtree = {"llm": jad}
    jt, jd = JO.trainable_mask(jtree, JL.lora_tunable_parts()), JO.decay_mask(jtree)
    for path, train in TO.trainable_mask(tad, TL.lora_tunable_parts()).items():
        node_t, node_d = jt, jd
        for part in W.jax_leaf_path(path).split("/"):
            node_t, node_d = node_t[part], node_d[part]
        assert train is node_t and TO.decay_mask(tad)[path] is node_d, path
        assert train == path.endswith(("_lora_a", "_lora_b")), path
    p = _trainable_port(tad, tx)
    _ce(p["llm"], tcfg.llm, ids).backward()
    grads = _leaf_grads(p)
    labels = jnp.roll(jnp.asarray(ids), -1, axis=1)
    jg = jax.grad(lambda q: optax.softmax_cross_entropy_with_integer_labels(
        _jlogits_traced(q, jcfg.llm, ids), labels).mean())(jad)
    back = W.unigen_to_jax(_tree_from_leaves(
        tad, [torch.zeros(0) if g is None else g for g in grads]), tcfg)["llm"]["layers"]
    for group, name in (("attn", "q"), ("mlp", "up")):
        for k in ("lora_a", "lora_b"):
            a = np.asarray(jg["layers"][group][name][k])
            np.testing.assert_allclose(back[group][name][k].numpy(), a, rtol=0,
                                       atol=1e-4 * max(np.abs(a).max(), 1e-9))
    before = [t.detach().clone() for _, t in TO.named_leaves(p)]
    leaves = [t for _, t in TO.named_leaves(p)]
    tx.update(grads, tx.init(leaves), leaves)
    for (path, t), old in zip(TO.named_leaves(p), before):
        moved = not torch.equal(t.detach(), old)
        assert moved == path.endswith("_lora_b"), path   # a's gradient is zero at b = 0


def test_weight_decay_does_not_touch_adapters(base):
    """tests/test_lora.py::test_weight_decay_does_not_touch_adapters on the
    port: 3 steps at weight decay 0.1 keep the scale, a healthy and the base."""
    _, tcfg, jllm, ids = base
    tad = {"llm": TL.add_lora(_port(jllm, tcfg), torch.Generator().manual_seed(1), rank=4,
                              alpha=8.0, dtype=torch.float32)}
    tx = TO.make_optimizer(tad, 1e-2, TLRS.get_scheduler("constant"), weight_decay=0.1,
                           tunable_parts=TL.lora_tunable_parts())
    p = _trainable_port(tad, tx)
    leaves = [t for _, t in TO.named_leaves(p)]
    state = tx.init(leaves)
    for _ in range(3):
        _ce(p["llm"], tcfg.llm, ids).backward()
        state = tx.update(_leaf_grads(p), state, leaves)
    q, q0 = p["llm"]["layers"][0], tad["llm"]["layers"][0]
    assert torch.equal(q["q_lora_scale"], q0["q_lora_scale"]) and float(q0["q_lora_scale"]) == 2.0
    assert q["q_lora_a"].norm() > 0.9 * q0["q_lora_a"].norm()
    assert torch.equal(q["q_w"].detach(), q0["q_w"])
    assert not torch.equal(q["q_lora_b"].detach(), q0["q_lora_b"])


def test_lora_cached_decode_matches_merged(base):
    """tests/test_lora.py::test_lora_with_kv_cache_decode: a cached prefill
    and one decode step with adapters equal the merged uncached forward (1e-4)."""
    _, tcfg, jllm, ids = base
    tad = _port(_randomize_b(JL.add_lora(jllm, jax.random.key(1), rank=4, dtype=jnp.float32),
                             jax.random.key(2)), tcfg)
    merged = TL.merge_lora(tad)
    tids = torch.as_tensor(ids)
    cache = TQ.init_kv_cache(tcfg.llm, 2, 16, torch.device("cpu"))
    with torch.no_grad():
        _, cache = TQ.forward(tad, tcfg.llm, input_ids=tids[:, :6], cache=cache)
        step, _ = TQ.forward(tad, tcfg.llm, input_ids=tids[:, 6:7], cache=cache)
        full, _ = TQ.forward(merged, tcfg.llm, input_ids=tids[:, :7])
    np.testing.assert_allclose(step[:, 0].numpy(), full[:, 6].numpy(), atol=1e-4, rtol=1e-4)


def test_lora_remat_gradients_match(base):
    """The adapters' gradients through ``remat=True`` (each layer under
    ``torch.utils.checkpoint``, the adapters inside its layer dict) equal
    those without remat; the frozen base gets none."""
    _, tcfg, jllm, ids = base
    tad = _port(_randomize_b(JL.add_lora(jllm, jax.random.key(1), rank=4, dtype=jnp.float32),
                             jax.random.key(2)), tcfg)
    grads = []
    for remat in (False, True):
        p = W.map_tree(tad, lambda t: t.detach().clone())
        for lp in p["layers"]:
            for k, t in lp.items():
                t.requires_grad_(k.endswith(("_lora_a", "_lora_b")))
        hidden, _ = TQ.forward(p, tcfg.llm, input_ids=torch.as_tensor(ids), remat=remat)
        TQ.logits(p, tcfg.llm, hidden).square().mean().backward()
        grads.append(_leaf_grads({"llm": p}))
    for a, b in zip(*grads):
        assert (a is None) == (b is None)
        if a is not None:
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-9)
    assert sum(g is not None for g in grads[0]) == 2 * 7 * tcfg.llm.num_hidden_layers
