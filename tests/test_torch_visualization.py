"""The port's in-training visual checks and masked-token diagnostics
(``unigen_tpu_torch/training/{visualization,diagnostics}.py``) against the JAX
package's, on the CPU, at tiny sizes in fp32.

The oracles are tests/test_aux.py's (``masked_token_diagnostics`` and
``visualize_predictions`` + ``save_image_grid``), taken further: the
diagnostics within 1e-5 of JAX's (counts exact), ``masked_t2i_inputs`` token
for token under JAX's masking draws, the triptychs within one level of
JAX's uint8 (the pixels' fp32 rounding; the argmax tokens equal), the grid
PNG's pixels exactly those of JAX's PIL-written grid of the same triptychs,
and a ``Trainer`` with ``visualize_every=1`` writing at each step the grid
JAX's ``visualize_predictions`` makes of that step's masked ids and weights.
The port's forward runs kernel 2's plain version on the t2i bits where JAX
builds the dense mask: only pad query rows differ, none in the image block.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unigen_tpu.models import magvit as JMV
from unigen_tpu.models import unigen as JU
from unigen_tpu.training import diagnostics as JD
from unigen_tpu.training import visualization as JV
from unigen_tpu_torch import weights as W
from unigen_tpu_torch.data.decode import decode_image
from unigen_tpu_torch.models import magvit as TMV
from unigen_tpu_torch.models import unigen as TU
from unigen_tpu_torch.training import diagnostics as TD
from unigen_tpu_torch.training import visualization as TV

from test_prompting import MockTokenizer
from test_torch_training import _jax_draws

PIL = pytest.importorskip("PIL.Image")


def _jnp(tree):
    """A JAX copy of a tree of torch tensors (a copy: the step updates them in place)."""
    return jax.tree.map(lambda t: jnp.asarray(t.detach().cpu().numpy().copy()), tree)


@pytest.mark.parametrize("case", ["test_aux", "random"])
def test_masked_token_diagnostics_matches_jax(case):
    rng = np.random.default_rng(0)
    if case == "test_aux":        # tests/test_aux.py::test_masked_token_diagnostics' inputs
        logits = rng.normal(size=(4, 8, 16)).astype(np.float32)
        labels = rng.integers(0, 16, size=(4, 8))
        labels[0, :4] = -100
        mask_prob = np.asarray([0.05, 0.55, 0.55, 0.95], np.float32)
    else:                          # every bucket edge, a row with nothing masked, large logits
        logits = (8 * rng.normal(size=(6, 20, 48))).astype(np.float32)
        labels = np.where(rng.random((6, 20)) < 0.6, rng.integers(0, 48, size=(6, 20)), -100)
        labels[3] = -100
        mask_prob = np.asarray([0.0, 0.1, 0.2999, 0.3, 1.0, 0.97], np.float32)
    j = jax.jit(JD.masked_token_diagnostics, static_argnames="num_buckets")(
        jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(mask_prob), num_buckets=10)
    t = TD.masked_token_diagnostics(torch.as_tensor(logits), torch.as_tensor(labels),
                                    torch.as_tensor(mask_prob), num_buckets=10)
    assert set(t) == set(j)
    for k in j:
        assert t[k].dtype == torch.float32 and t[k].shape == (10,)
        np.testing.assert_allclose(t[k].numpy(), np.asarray(j[k]), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(t["bucket_tokens"].numpy(), np.asarray(j["bucket_tokens"]))
    if case == "test_aux":
        assert float(t["bucket_tokens"][0]) == 4.0 and float(t["bucket_tokens"][5]) == 16.0


@pytest.fixture(scope="module", autouse=True)
def jitted_jax():
    """JAX's model calls jitted for this module's tests (eager JAX compiles
    every op on first use): ``visualization.py`` looks them up on its model
    modules at each call, so the functions under test are JAX's own."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JMV, "get_code", jax.jit(JMV.get_code, static_argnums=1))
        mp.setattr(JMV, "decode_code", jax.jit(JMV.decode_code, static_argnums=1))
        mp.setattr(JU, "forward", jax.jit(JU.forward, static_argnums=1, static_argnames=(
            "batch_size_t2i", "batch_size_lm", "batch_size_mmu", "t2i_mode", "remat",
            "memory_efficient_loss", "return_hidden")))
        yield


@pytest.fixture(scope="module")
def vis():
    """The tiny UniGen and MAGViTv2 of tests/test_aux.py's triptych test (the
    text vocabulary and the row shape of test_torch_trainer's, so the
    trainer test reuses the compiled JAX calls), random from seed 1 in the
    port and copied to JAX; 2 rows of 40 tokens, left pads in one."""
    gen = torch.Generator().manual_seed(1)
    vocab = len(MockTokenizer())
    tcfg = TU.UniGenConfig.tiny(text_vocab_len=vocab)
    tvq = TMV.MagvitConfig.tiny(resolution=8, z_channels=5)
    tparams, tvq_params = W.init_unigen(tcfg, gen, "cpu"), W.init_magvit(tvq, gen, "cpu")
    jcfg = JU.UniGenConfig.tiny(text_vocab_len=vocab)
    rng = np.random.default_rng(0)
    n, b, L = jcfg.num_vq_tokens, 2, 40
    px = rng.normal(size=(b, 8, 8, 3)).astype(np.float32)
    template = rng.integers(3, 100, size=(b, L))
    template[:, -n - 2] = 1
    template[:, -n - 1:-1] = 0
    template[:, -1] = 2
    template[0, :2] = 0
    return dict(jcfg=jcfg, jparams=_jnp(W.unigen_to_jax(tparams, tcfg)), tcfg=tcfg,
                tparams=tparams, jvq=JMV.MagvitConfig.tiny(resolution=8, z_channels=5), tvq=tvq,
                jvq_params=_jnp(W.magvit_to_jax(tvq_params)), tvq_params=tvq_params, px=px,
                template=template)


def test_masked_t2i_inputs_matches_jax(vis):
    s = vis
    n = s["jcfg"].num_vq_tokens
    for seed, kw in ((0, {}), (1, dict(mask_schedule="linear", min_masking_rate=0.4))):
        key = jax.random.key(seed)
        j = JV.masked_t2i_inputs(s["jvq_params"], s["jvq"], s["jcfg"], jnp.asarray(s["template"]),
                                 jnp.asarray(s["px"]), key, **kw)
        t = TV.masked_t2i_inputs(s["tvq_params"], s["tvq"], s["tcfg"],
                                 torch.as_tensor(s["template"]), torch.as_tensor(s["px"]),
                                 _jax_draws(key, 2, n, s["tcfg"].codebook_size), **kw)
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
        assert (t[:, -n - 1:-1] == s["tcfg"].mask_token_id).any()


def _trip_close(got, want):
    """uint8 triptychs within one level (fp32 pixels rounding apart), the
    original third exact."""
    assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape
    w = want.shape[2] // 3
    np.testing.assert_array_equal(got[:, :, :w], want[:, :, :w])
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_visualize_predictions_and_grid_match_jax(tmp_path, vis):
    s = vis
    key = jax.random.key(5)
    ids = np.asarray(JV.masked_t2i_inputs(s["jvq_params"], s["jvq"], s["jcfg"],
                                          jnp.asarray(s["template"]), jnp.asarray(s["px"]), key))
    j = JV.visualize_predictions(s["jparams"], s["jcfg"], s["jvq_params"], s["jvq"],
                                 jnp.asarray(s["px"]), jnp.asarray(ids), pad_id=0, soi_id=1,
                                 eoi_id=2)
    t = TV.visualize_predictions(s["tparams"], s["tcfg"], s["tvq_params"], s["tvq"],
                                 torch.as_tensor(s["px"]), torch.as_tensor(ids), 0, 1, 2)
    assert t.shape == (2, 8, 24, 3)
    _trip_close(t, np.asarray(j))
    for cols in (None, 1):
        TV.save_image_grid(t, str(tmp_path / "port.png"), cols=cols)
        JV.save_image_grid(t, str(tmp_path / "jax.png"), cols=cols)
        want = np.asarray(PIL.open(str(tmp_path / "jax.png")).convert("RGB"))
        with open(tmp_path / "port.png", "rb") as f:
            got = decode_image(f.read())
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            np.asarray(PIL.open(str(tmp_path / "port.png")).convert("RGB")), want)
    assert got.shape == (16, 24, 3)


def test_save_image_grid_partial_row_matches_jax(tmp_path):
    """Five images on rows of four: the last row's empty cells black."""
    imgs = np.random.default_rng(3).integers(0, 256, size=(5, 6, 7, 3)).astype(np.uint8)
    TV.save_image_grid(imgs, str(tmp_path / "p.png"))
    JV.save_image_grid(imgs, str(tmp_path / "j.png"))
    with open(tmp_path / "p.png", "rb") as f:
        got = decode_image(f.read())
    np.testing.assert_array_equal(got, np.asarray(PIL.open(str(tmp_path / "j.png"))))
    assert got.shape == (12, 28, 3) and not got[6:, 7:].any()


def test_trainer_visualize_every_writes_jax_grids(tmp_path, monkeypatch):
    """A tiny Trainer with ``visualize_every=1``: at each step a grid PNG and
    a ``visualization`` log line; each grid is the one JAX's
    ``visualize_predictions`` + ``save_image_grid`` make from that step's
    masked ids, pixels and weights."""
    from test_torch_trainer import _build, _flows, _logs
    seen = []
    real = TV.visualize_predictions

    def record(params, cfg, vq_params, vq_cfg, pixels, ids, *bits, **kw):
        seen.append(dict(params=_jnp(W.unigen_to_jax(params, cfg)), vq=_jnp(vq_params),
                         cfg=cfg, vq_cfg=vq_cfg, pixels=pixels.numpy().copy(),
                         ids=ids.numpy().copy(), bits=bits))
        return real(params, cfg, vq_params, vq_cfg, pixels, ids, *bits, **kw)
    monkeypatch.setattr(TV, "visualize_predictions", record)
    trainer = _build(tmp_path, max_steps=2, visualize_every=1, save_every=0)
    trainer.train(_flows(2, 8, 5))
    logs = [e for e in _logs(tmp_path) if "visualization" in e]
    assert [e["step"] for e in logs] == [1, 2] and len(seen) == 2
    for step, rec in zip((1, 2), seen):
        path = os.path.join(tmp_path, "visualizations", f"predictions_step{step}.png")
        assert logs[step - 1]["visualization"] == path
        cfg, vq_cfg = rec["cfg"], rec["vq_cfg"]
        jcfg = JU.UniGenConfig.tiny(text_vocab_len=cfg.text_vocab_len)
        jvq = JMV.MagvitConfig.tiny(resolution=vq_cfg.resolution, z_channels=vq_cfg.z_channels)
        assert jcfg.num_vq_tokens == cfg.num_vq_tokens and jcfg.vocab_size == cfg.vocab_size
        trip = JV.visualize_predictions(rec["params"], jcfg, rec["vq"], jvq,
                                        jnp.asarray(rec["pixels"]), jnp.asarray(rec["ids"]),
                                        *rec["bits"])
        JV.save_image_grid(np.asarray(trip), str(tmp_path / "jax.png"))
        with open(path, "rb") as f:
            got = decode_image(f.read())
        want = np.asarray(PIL.open(str(tmp_path / "jax.png")).convert("RGB"))
        assert got.shape == want.shape == (8, 48, 3)
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    n = cfg.num_vq_tokens
    assert (seen[0]["ids"][:, -n - 1:-1] == cfg.mask_token_id).any()
    assert not (seen[0]["ids"] == seen[1]["ids"]).all()          # fresh draws each time
