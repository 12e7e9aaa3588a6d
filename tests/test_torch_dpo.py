"""The port's DPO against the JAX package's, on the CPU in fp32.

``get_batch_logps`` in both gen modes, the chunked log-probs from the
hidden states, the whole step against JAX's (its dense masks, under JAX's
``k_c, k_r`` masking draws), the precomputed reference against the online
one, the chunked against the dense log-probs, and the preference learned
over a few steps (tests/test_dpo.py on the port).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_training import _jax_draws, _leaf_errors, _perturb
from unigen_tpu.models import magvit as JMV
from unigen_tpu.models import unigen as JU
from unigen_tpu.training import dpo as JDPO
from unigen_tpu.training import lr_schedules as JLRS
from unigen_tpu.training import optimizer as JO
from unigen_tpu.training import train_step as JT
from unigen_tpu_torch import weights as W
from unigen_tpu_torch.models import magvit as TMV
from unigen_tpu_torch.models import unigen as TU
from unigen_tpu_torch.training import dpo as TDPO
from unigen_tpu_torch.training import lr_schedules as TLRS
from unigen_tpu_torch.training import optimizer as TO
from unigen_tpu_torch.training.sft import init_sft_state

METRICS = ("loss", "reward_accuracy", "policy_chosen_logps", "policy_rejected_logps",
           "chosen_masking_rate", "rejected_masking_rate", "grad_norm")


@pytest.mark.parametrize("mode", ["mask", "ar"])
@pytest.mark.parametrize("average", [False, True])
def test_get_batch_logps_matches_jax(mode, average):
    rng = np.random.default_rng(0)
    b, l, v, n = 3, 24, 40, 16
    logits = rng.normal(size=(b, l, v)).astype(np.float32)
    labels = rng.integers(0, v, size=(b, l))
    labels[:, -n - 1:-1][rng.random((b, n)) < 0.5] = -100
    kw = dict(num_vq_tokens=n, t2i_gen_mode=mode, average_log_prob=average)
    want = np.asarray(JDPO.get_batch_logps(jnp.asarray(logits), jnp.asarray(labels), **kw))
    got = TDPO.get_batch_logps(torch.as_tensor(logits), torch.as_tensor(labels), **kw)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_logps_from_hidden_match_dense_and_jax():
    rng = np.random.default_rng(1)
    b, l, d, v = 3, 20, 8, 33
    h = rng.normal(size=(b, l, d)).astype(np.float32)
    w = rng.normal(size=(v, d)).astype(np.float32)
    labels = rng.integers(0, v, size=(b, l))
    labels[rng.random((b, l)) < 0.3] = -100
    for average in (False, True):
        got = TDPO.get_batch_logps_from_hidden(torch.as_tensor(h), torch.as_tensor(w),
                                               torch.as_tensor(labels), chunk=6,
                                               average_log_prob=average)
        want = np.asarray(JDPO.get_batch_logps_from_hidden(
            jnp.asarray(h), jnp.asarray(w.T), jnp.asarray(labels), chunk=6,
            average_log_prob=average))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
        # the dense form over the same positions: a [b, l + 1] sequence whose
        # block [-(l + 1):-1] is h
        logits = torch.cat([torch.as_tensor(h) @ torch.as_tensor(w).T,
                            torch.zeros((b, 1, v))], dim=1)
        lab = torch.cat([torch.as_tensor(labels), torch.zeros((b, 1), dtype=torch.int64)], 1)
        dense = TDPO.get_batch_logps(logits, lab, num_vq_tokens=l, average_log_prob=average)
        torch.testing.assert_close(got, dense, rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def setup():
    """tests/test_dpo.py's fixture: tiny UniGen, 2 pairs of 8 px images, a
    28-token template; perturbed biases and norm scales."""
    jcfg, tcfg = JU.UniGenConfig.tiny(), TU.UniGenConfig.tiny()
    tree = _perturb(jax.tree.map(np.asarray, JU.init(jax.random.key(0), jcfg)),
                    np.random.default_rng(0))
    jvq, tvq = (m.MagvitConfig.tiny(resolution=8, z_channels=5) for m in (JMV, TMV))
    vq_tree = jax.tree.map(np.asarray, JMV.init(jax.random.key(1), jvq))
    n, length, b = jcfg.num_vq_tokens, 28, 2
    rng = np.random.default_rng(0)
    template = rng.integers(3, 100, size=(b, length))
    template[:, -n - 2] = 1
    template[:, -n - 1:-1] = 0
    template[:, -1] = 2
    template[1, :3] = 0                               # left pads in one row
    batch = {"template": template, "labels": np.full((b, length), -100),
             "chosen_pixels": rng.normal(size=(b, 8, 8, 3)).astype(np.float32),
             "rejected_pixels": rng.normal(size=(b, 8, 8, 3)).astype(np.float32)}
    j = dict(cfg=jcfg, params=jax.tree.map(jnp.asarray, tree), vq_cfg=jvq,
             vq=jax.tree.map(jnp.asarray, vq_tree), batch={k: jnp.asarray(v)
                                                          for k, v in batch.items()})
    t = dict(cfg=tcfg, params=W.unigen_from_jax(tree, tcfg), vq_cfg=tvq,
             vq=W.magvit_from_jax(vq_tree, tvq), batch={k: torch.as_tensor(v)
                                                       for k, v in batch.items()})
    return j, t


def _pair_draws(key, b, n):
    k_c, k_r = jax.random.split(key)
    return _jax_draws(k_c, b, n), _jax_draws(k_r, b, n)


def _port_step(t, **kw):
    tx = TO.make_optimizer(t["params"], 5e-4, TLRS.get_scheduler("constant"), max_grad_norm=1.0)
    return tx, TDPO.make_dpo_step(t["cfg"], t["vq_cfg"], tx, TDPO.DPOConfig(beta=0.1, **kw))


@pytest.mark.parametrize("mode", ["mask", "ar"])
def test_dpo_step_matches_jax(setup, mode):
    """One step: the metrics against JAX's (its dense masks; rtol 1e-4, the
    masking rates exact), the updated parameters within 1e-4 of each leaf's
    largest magnitude, with the online reference."""
    j, t = setup
    key = jax.random.key(7)
    jtx = JO.make_optimizer(j["params"], 5e-4, JLRS.get_scheduler("constant"),
                            max_grad_norm=1.0)
    jstep = jax.jit(JDPO.make_dpo_step(j["cfg"], j["vq_cfg"], jtx, JDPO.DPOConfig(
        beta=0.1, t2i_gen_mode=mode, average_log_prob=True)))
    jstate, jm = jstep(JT.init_train_state(j["params"], jtx), j["params"], j["vq"], j["batch"],
                       key)
    tx, step = _port_step(t, t2i_gen_mode=mode, average_log_prob=True)
    state, m = step(init_sft_state(t["params"], tx), t["params"], t["vq"], t["batch"],
                    _pair_draws(key, 2, t["cfg"].num_vq_tokens))
    for k in METRICS:
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-4, atol=1e-6, err_msg=k)
    errs = _leaf_errors(jstate.params, W.unigen_to_jax(state.params, t["cfg"]))
    assert max(errs.values()) < 1e-4, {k: v for k, v in errs.items() if v >= 1e-4}


@pytest.mark.parametrize("mode", ["mask", "ar"])
def test_chunked_logps_match_dense(setup, mode):
    """tests/test_dpo.py::test_dpo_memory_efficient_logps_match_dense on the
    port (rtol 2e-5)."""
    _, t = setup
    draws = _pair_draws(jax.random.key(7), 2, t["cfg"].num_vq_tokens)
    out = {}
    for eff in (True, False):
        tx, step = _port_step(t, t2i_gen_mode=mode, average_log_prob=True,
                              memory_efficient_logps=eff)
        _, m = step(init_sft_state(t["params"], tx), t["params"], t["vq"], t["batch"], draws)
        out[eff] = {k: float(v) for k, v in m.items()}
    for k in METRICS:
        np.testing.assert_allclose(out[True][k], out[False][k], rtol=2e-5, atol=1e-6, err_msg=k)


def test_precomputed_ref_matches_online(setup):
    """The precomputed reference (``make_ref_logps_fn`` ahead, the step
    without a reference model) gives the online step's metrics and
    parameters bit for bit on the CPU, and JAX's precomputed log-probs."""
    j, t = setup
    key = jax.random.key(11)
    draws = _pair_draws(key, 2, t["cfg"].num_vq_tokens)
    tx, online = _port_step(t)
    s_o, m_o = online(init_sft_state(t["params"], tx), t["params"], t["vq"], t["batch"], draws)
    dcfg = TDPO.DPOConfig(beta=0.1, precomputed_ref=True)
    refs = TDPO.make_ref_logps_fn(t["cfg"], t["vq_cfg"], dcfg)(t["params"], t["vq"],
                                                                t["batch"], draws)
    pre = TDPO.make_dpo_step(t["cfg"], t["vq_cfg"], tx, dcfg)
    s_p, m_p = pre(init_sft_state(t["params"], tx), None, t["vq"], dict(t["batch"], **refs),
                   draws)
    for k in METRICS:
        assert torch.equal(m_p[k], m_o[k]), k
    for (path, a), (_, b) in zip(TO.named_leaves(s_p.params), TO.named_leaves(s_o.params)):
        assert torch.equal(a, b), path
    jrefs = JDPO.make_ref_logps_fn(j["cfg"], j["vq_cfg"], JDPO.DPOConfig(beta=0.1))(
        j["params"], j["vq"], j["batch"], key)
    for k, v in refs.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(jrefs[k]), rtol=1e-5, atol=1e-5)


def test_dpo_learns_preference(setup):
    """tests/test_dpo.py::test_dpo_step_learns_preference: 5 steps under a
    fixed draw lower the loss, reward accuracy >= 0.5."""
    _, t = setup
    tx, step = _port_step(t)
    state = init_sft_state(t["params"], tx)
    draws = _pair_draws(jax.random.key(42), 2, t["cfg"].num_vq_tokens)
    losses = []
    for _ in range(5):
        state, m = step(state, t["params"], t["vq"], t["batch"], draws)
        losses.append(float(m["loss"]))
        assert np.isfinite(losses[-1])
    assert losses[-1] < losses[0] and float(m["reward_accuracy"]) >= 0.5
    gen_state = init_sft_state(t["params"], tx)
    gen_state, gm = step(gen_state, t["params"], t["vq"], t["batch"],
                         torch.Generator().manual_seed(0))
    assert np.isfinite(float(gm["loss"]))
