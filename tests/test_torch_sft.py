"""The port's SFT step against the JAX package's, on the CPU in fp32.

``grid_tiles``; the LLaVA preprocessing and collation (exact); then the
whole SFT step in each dispatch mode (separate, fused to the common length,
sequence-packed with a full and with a partial packed row, the split
dispatch) against JAX's step with its dense default masks (rtol 1e-4) and
with ``use_flash_attention=True`` (1e-5), under JAX's masking draws: the
losses, the grad norm and the updated parameters. Weights are the JAX tiny
inits with perturbed biases and norm scales; the shapes are those of
tests/test_hf_import.py's SFT fixture.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_training import _jax_draws, _leaf_errors, _perturb
from unigen_tpu import launch as JL
from unigen_tpu.data import llava as JD
from unigen_tpu.data import transform as JT_
from unigen_tpu.models import magvit as JMV
from unigen_tpu.models import siglip as JSG
from unigen_tpu.models import unigen as JU
from unigen_tpu.training import lr_schedules as JLRS
from unigen_tpu.training import optimizer as JO
from unigen_tpu.training import sft as JSFT
from unigen_tpu.training import train_step as JT
from unigen_tpu_torch import launch as TL
from unigen_tpu_torch import weights as W
from unigen_tpu_torch.data import llava as TD
from unigen_tpu_torch.models import magvit as TMV
from unigen_tpu_torch.models import siglip as TSG
from unigen_tpu_torch.models import siglip2 as TS2
from unigen_tpu_torch.models import unigen as TU
from unigen_tpu_torch.ops import masks as TM
from unigen_tpu_torch.training import lr_schedules as TLRS
from unigen_tpu_torch.training import optimizer as TO
from unigen_tpu_torch.training import sft as TSFT

METRICS = ("loss", "loss_t2i", "loss_lm", "loss_mmu", "grad_norm", "avg_masking_rate")


def test_grid_tiles_matches_jax():
    """The global view (an antialiased downsample) within 1e-5 in fp32, the
    crops exact; tests/test_hf_import.py::test_grid_tiles' own checks."""
    px = np.random.default_rng(0).normal(size=(2, 24, 24, 3)).astype(np.float32)
    j = np.asarray(JSFT.grid_tiles(jnp.asarray(px), n_grid=2, tile_size=12))
    t = TSFT.grid_tiles(torch.as_tensor(px), n_grid=2, tile_size=12).numpy()
    assert t.shape == j.shape == (2, 5, 12, 12, 3)
    np.testing.assert_allclose(t[:, 0], j[:, 0], atol=1e-5)
    np.testing.assert_array_equal(t[:, 1:], j[:, 1:])
    ar = torch.arange(2 * 8 * 8 * 3, dtype=torch.float32).reshape(2, 8, 8, 3)
    tiles = TSFT.grid_tiles(ar, n_grid=2, tile_size=4)
    assert torch.equal(tiles[:, 1], ar[:, :4, :4]) and torch.equal(tiles[:, 4], ar[:, 4:, 4:])


CONVS = [
    [{"from": "human", "value": "what is this? <image>"}, {"from": "gpt", "value": "a cat"}],
    [{"from": "gpt", "value": "hi"}, {"from": "human", "value": "q"},
     {"from": "gpt", "value": "an answer that runs past the collate length " * 2}],
    [{"role": "user", "content": "two turns"}, {"role": "assistant", "content": "yes"},
     {"role": "user", "content": "<image> more"}, {"role": "assistant", "content": "no"}],
]


def test_preprocess_and_collate_match_jax():
    """``preprocess_qwen`` / ``preprocess_plain`` / ``collate_batch`` give
    JAX's ids, labels and system ids exactly (the byte tokenizer), and the
    label masking of tests/test_data.py::test_preprocess_qwen_label_masking."""
    jt, tt = JL.FallbackTokenizer(), TL.FallbackTokenizer()
    for kind in ("qwen", "plain"):
        convs = CONVS if kind == "qwen" else [c[:2] for c in CONVS[:1]]
        j, t = JD.preprocess(convs, jt, kind), TD.preprocess(convs, tt, kind)
        assert t == j, kind
    out = TD.preprocess_qwen(CONVS[:1], tt)
    ids, labs = out["input_ids"][0], out["labels"][0]
    n_user = len(tt("<|im_start|>user\nwhat is this?<|im_end|>\n")["input_ids"])
    assert all(x == TD.IGNORE_INDEX for x in labs[:n_user]) and labs[n_user:] == ids[n_user:]
    proc = TD.preprocess_qwen(CONVS, tt)
    rng = np.random.default_rng(0)
    samples = [{"input_ids": proc["input_ids"][i], "labels": proc["labels"][i],
                "input_ids_system": proc["input_ids_system"][i],
                "image": rng.normal(size=(4, 4, 3)).astype(np.float32)} for i in range(3)]
    for system in (False, True):
        j = JD.collate_batch(samples, 0, max_length=48, with_system=system)
        t = TD.collate_batch(samples, 0, max_length=48, with_system=system)
        assert sorted(j) == sorted(t)
        for k in j:
            np.testing.assert_array_equal(t[k], j[k])
    # NaFlex samples (dict images from naflex_preprocess) stack their patches,
    # masks and spatial shapes as JAX's collate does
    naflex = [dict(s, image=JT_.naflex_preprocess(
        rng.integers(0, 256, size=(8 + 8 * i, 16, 3), dtype=np.uint8), 8, 8))
        for i, s in enumerate(samples)]
    j, t = JD.collate_batch(naflex, 0, 48), TD.collate_batch(naflex, 0, 48)
    assert sorted(j) == sorted(t) == ["images", "input_ids", "labels", "pixel_attention_mask",
                                      "spatial_shapes"]
    for k in j:
        np.testing.assert_array_equal(t[k], j[k])


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------

def _t2i_rows(rng, bt, n, length=28):
    t2i = rng.integers(3, 100, size=(bt, length))
    t2i[:, -n - 2] = 1
    t2i[:, -n - 1:-1] = 0
    t2i[:, -1] = 2
    labels = np.full((bt, length), -100)
    labels[:, -n - 2] = 1          # soi / eoi labels outside the scored block
    labels[:, -1] = 2
    return t2i, labels


def _batch(case, cfg, vs_cfg):
    """tests/test_hf_import.py's SFT batches: ``separate`` (mmu 3 + 4 + 8),
    ``common`` (mmu 57 = two 28-token segments a row, a left pad in a t2i
    row), ``partial`` (3 t2i rows, no lm: a half-filled packed row)."""
    n, p = cfg.num_vq_tokens, vs_cfg.num_patches
    rng = np.random.default_rng({"separate": 0, "common": 1, "partial": 2}[case])
    bt, bl, bm = (3, 0, 2) if case == "partial" else (2, 2, 2)
    part2 = 8 if case == "separate" else 50
    mmu_len = 3 + p + part2
    t2i, t2i_labels = _t2i_rows(rng, bt, n)
    if case == "common":
        t2i[1, :2] = 0
    mmu_labels = np.full((bm, mmu_len), -100)
    mmu_labels[:, -6:] = rng.integers(3, 100, size=(bm, 6))
    batch = {"t2i_template": t2i, "t2i_labels": t2i_labels,
             "t2i_pixels": rng.normal(size=(bt, 8, 8, 3)).astype(np.float32),
             "mmu_part1": rng.integers(3, 100, size=(bm, 3)),
             "mmu_part2": rng.integers(3, 100, size=(bm, part2)),
             "mmu_labels": mmu_labels,
             "mmu_pixels": rng.normal(size=(bm, 28, 28, 3)).astype(np.float32),
             "mmu_prompt_len": np.array([mmu_len, mmu_len - 2][:bm])}
    if bl:
        batch["lm_ids"] = rng.integers(3, 100, size=(bl, 28))
        batch["lm_labels"] = rng.integers(3, 100, size=(bl, 28))
    return batch, (bt, bl, bm), (None if case == "separate" else mmu_len)


@pytest.fixture(scope="module")
def models():
    kw = dict(w_und_encoder=True, mm_input_dim=32)
    jcfg, tcfg = JU.UniGenConfig.tiny(**kw), TU.UniGenConfig.tiny(**kw)
    tree = _perturb(jax.tree.map(np.asarray, JU.init(jax.random.key(0), jcfg)),
                    np.random.default_rng(0))
    jvq, tvq = (m.MagvitConfig.tiny(resolution=8, z_channels=5) for m in (JMV, TMV))
    vq_tree = jax.tree.map(np.asarray, JMV.init(jax.random.key(1), jvq))
    jvs, tvs = (m.SiglipConfig.tiny(image_size=28, patch_size=14, hidden_size=32)
                for m in (JSG, TSG))
    vs_tree = _perturb(jax.tree.map(np.asarray, JSG.init(jax.random.key(2), jvs)),
                       np.random.default_rng(1))
    j = dict(cfg=jcfg, params=jax.tree.map(jnp.asarray, tree), vq_cfg=jvq,
             vq=jax.tree.map(jnp.asarray, vq_tree), vs_cfg=jvs, vs=jax.tree.map(jnp.asarray,
                                                                               vs_tree))
    t = dict(cfg=tcfg, params=W.unigen_from_jax(tree, tcfg), vq_cfg=tvq,
             vq=W.magvit_from_jax(vq_tree, tvq), vs_cfg=tvs, vs=W.siglip_from_jax(vs_tree, tvs))
    return j, t


OPT_KW = dict(lr_mapper={"mm_projector": 2.0}, tunable_parts=["mm_projector", "llm"],
              max_grad_norm=1.0, weight_decay=0.01)


def _jax_step(j, batch, step_kw, key, flash):
    tx = JO.make_optimizer(j["params"], 1e-3, JLRS.get_scheduler("constant"), **OPT_KW)
    tcfg = JSFT.SFTStepConfig(use_flash_attention=flash, max_grad_norm=1.0, **step_kw)
    step = jax.jit(JSFT.make_sft_train_step(j["cfg"], j["vq_cfg"], j["vs_cfg"], tx, tcfg))
    state, m = step(JT.init_train_state(j["params"], tx), j["vq"], j["vs"],
                    {k: jnp.asarray(v) for k, v in batch.items()}, key)
    return state, {k: float(v) for k, v in m.items()}


def _port(t, step_kw, remat=False):
    tx = TO.make_optimizer(t["params"], 1e-3, TLRS.get_scheduler("constant"), **OPT_KW)
    tcfg = TSFT.SFTStepConfig(max_grad_norm=1.0, remat=remat, **step_kw)
    return tx, TSFT.make_sft_train_step(t["cfg"], t["vq_cfg"], t["vs_cfg"], tx, tcfg)


SFT_CASES = {                     # batch, pack_rows, JAX's step mode
    "separate": ("separate", True),
    "split_dispatch": ("separate", True),
    "fused": ("common", False),
    "packed_full_rows": ("common", True),
    "packed_partial_row": ("partial", True),
}


_JAX_STEPS = {}


def _split_step(t, tx, step_kw, state, batch, draws):
    """The separate mode through ``make_sft_grad_fns``: two gradient calls
    and the update."""
    grad_tl, grad_mmu, apply_grads = TSFT.make_sft_grad_fns(
        t["cfg"], t["vq_cfg"], t["vs_cfg"], tx, TSFT.SFTStepConfig(max_grad_norm=1.0, **step_kw))
    g1, aux1 = grad_tl(state.params, t["vq"], batch, draws)
    g2, aux2 = grad_mmu(state.params, t["vs"], batch)
    return apply_grads(state, g1, g2, aux1, aux2)


@pytest.mark.parametrize("case", sorted(SFT_CASES))
def test_sft_step_matches_jax(models, case):
    """One step in each mode: losses and grad norm against JAX's dense step
    (rtol 1e-4) and its flash step (1e-5); the updated parameters within
    1e-4 of each leaf's largest magnitude of the flash step's (JAX's own
    flash-against-dense SFT test holds them at rtol 1e-4: Adam's first step
    turns rounding-level differences of near-zero gradients into lr-sized
    ones); the port's mode is JAX's (packed rows only where JAX packs)."""
    j, t = models
    which, pack = SFT_CASES[case]
    batch, (bt, bl, bm), common = _batch(which, j["cfg"], j["vs_cfg"])
    step_kw = dict(batch_size_t2i=bt, batch_size_lm=bl, batch_size_mmu=bm,
                   common_length=common, pack_rows=pack)
    key = jax.random.key(5)
    if (which, pack) not in _JAX_STEPS:       # the split dispatch shares the separate step's
        _JAX_STEPS[which, pack] = (_jax_step(j, batch, step_kw, key, False)[1],
                                   *_jax_step(j, batch, step_kw, key, True))
    dense, jstate, flash = _JAX_STEPS[which, pack]
    tx, step = _port(t, step_kw)
    assert step.mode == {"separate": "separate", "split_dispatch": "separate",
                         "fused": "fused"}.get(case, "packed")
    state = TSFT.init_sft_state(t["params"], tx)
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    draws = _jax_draws(key, bt, j["cfg"].num_vq_tokens)
    if case == "split_dispatch":
        state, m = _split_step(t, tx, step_kw, state, tb, draws)
    else:
        state, m = step(state, t["vq"], t["vs"], tb, draws)
    for k in METRICS:
        if k in flash:
            np.testing.assert_allclose(float(m[k]), flash[k], rtol=1e-5, atol=1e-6, err_msg=k)
            np.testing.assert_allclose(float(m[k]), dense[k], rtol=1e-4, atol=1e-5, err_msg=k)
    errs = _leaf_errors(jstate.params, W.unigen_to_jax(state.params, t["cfg"]))
    assert max(errs.values()) < 1e-4, {k: v for k, v in errs.items() if v >= 1e-4}
    assert int(state.step) == 1 and all(x.grad is None for _, x in TO.named_leaves(state.params))


def test_sft_modes_agree_and_remat(models):
    """tests/test_hf_import.py::test_sft_common_length_matches_separate on
    the port: fused and packed against separate (losses and grad norm rtol
    2e-5, parameters 1e-4); and remat gives the same step."""
    _, t = models
    batch, (bt, bl, bm), common = _batch("common", t["cfg"], t["vs_cfg"])
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    draws = _jax_draws(jax.random.key(5), bt, t["cfg"].num_vq_tokens)
    out = {}
    for name, common_length, pack, remat in (("separate", None, True, False),
                                             ("fused", common, False, False),
                                             ("packed", common, True, False),
                                             ("packed_remat", common, True, True)):
        tx, step = _port(t, dict(batch_size_t2i=bt, batch_size_lm=bl, batch_size_mmu=bm,
                                 common_length=common_length, pack_rows=pack), remat)
        state, m = step(TSFT.init_sft_state(t["params"], tx), t["vq"], t["vs"], tb, draws)
        out[name] = ({k: float(v) for k, v in m.items()}, state.params)
    base, base_params = out["separate"]
    for name in ("fused", "packed", "packed_remat"):
        for k in METRICS:
            np.testing.assert_allclose(out[name][0][k], base[k], rtol=2e-5, err_msg=(name, k))
        for (path, a), (_, b) in zip(TO.named_leaves(out[name][1]),
                                     TO.named_leaves(base_params)):
            torch.testing.assert_close(a.detach(), b.detach(), rtol=1e-4, atol=1e-7,
                                       msg=f"{name} {path}")
    assert out["packed_remat"][0] == out["packed"][0]


def test_split_dispatch_matches_step(models):
    """``make_sft_grad_fns`` gives the separate step's metrics (rtol 1e-6)
    and parameters (1e-5), as tests/test_hf_import.py::
    test_sft_split_dispatch_matches_fused holds JAX's; its gradients add up
    to the step's two backward passes into the same leaves."""
    _, t = models
    batch, (bt, bl, bm), _ = _batch("separate", t["cfg"], t["vs_cfg"])
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    draws = _jax_draws(jax.random.key(3), bt, t["cfg"].num_vq_tokens)
    step_kw = dict(batch_size_t2i=bt, batch_size_lm=bl, batch_size_mmu=bm)
    tx, step = _port(t, step_kw)
    grads, _ = step.loss_and_grads(TSFT.init_sft_state(t["params"], tx).params, t["vq"],
                                   t["vs"], tb, draws)
    fused, m_f = step(TSFT.init_sft_state(t["params"], tx), t["vq"], t["vs"], tb, draws)
    grad_tl, grad_mmu, _ = TSFT.make_sft_grad_fns(t["cfg"], t["vq_cfg"], t["vs_cfg"], tx,
                                                  TSFT.SFTStepConfig(max_grad_norm=1.0, **step_kw))
    split = TSFT.init_sft_state(t["params"], tx)
    g1, _ = grad_tl(split.params, t["vq"], tb, draws)
    g2, _ = grad_mmu(split.params, t["vs"], tb)
    for g, a, b in zip(grads, g1, g2):
        torch.testing.assert_close(g, a + b, rtol=1e-6, atol=1e-9)
    split, m_s = _split_step(t, tx, step_kw, split, tb, draws)
    for k in METRICS:
        np.testing.assert_allclose(float(m_s[k]), float(m_f[k]), rtol=1e-6, err_msg=k)
    for (path, a), (_, b) in zip(TO.named_leaves(split.params), TO.named_leaves(fused.params)):
        torch.testing.assert_close(a.detach(), b.detach(), rtol=1e-5, atol=1e-8, msg=path)


def test_mmu_only_and_frozen_parts(models):
    """The CoT-V post-SFT shape (mmu rows only: separate mode, masking rate
    0) and a step with the backbone frozen: only the projector moves, no
    backbone gradient is taken, the frozen tower is untouched."""
    _, t = models
    batch, _, _ = _batch("separate", t["cfg"], t["vs_cfg"])
    tb = {k: torch.as_tensor(v) for k, v in batch.items() if k.startswith("mmu_")}
    tx = TO.make_optimizer(t["params"], 1e-2, TLRS.get_scheduler("constant"),
                           tunable_parts=["mm_projector"])
    step = TSFT.make_sft_train_step(t["cfg"], t["vq_cfg"], t["vs_cfg"], tx, TSFT.SFTStepConfig(
        batch_size_t2i=0, batch_size_lm=0, batch_size_mmu=2, common_length=57))
    assert step.mode == "separate"
    vs_before = [x.clone() for _, x in TO.named_leaves(t["vs"])]
    state = TSFT.init_sft_state(t["params"], tx)
    grads, m = step.loss_and_grads(state.params, t["vq"], t["vs"], tb, None)
    paths = [p for p, _ in TO.named_leaves(state.params)]
    assert all((g is None) != p.startswith("mm_projector") for p, g in zip(paths, grads))
    assert float(m["avg_masking_rate"]) == 0.0 and set(m) == {"loss", "loss_mmu",
                                                             "avg_masking_rate"}
    state, m = step.apply(state, grads, m)
    for p, a, b in zip(paths, (x for _, x in TO.named_leaves(state.params)),
                       (x for _, x in TO.named_leaves(t["params"]))):
        assert torch.equal(a.detach(), b) != p.startswith("mm_projector"), p
    assert all(torch.equal(a, b) for a, b in zip(vs_before,
                                                 (x for _, x in TO.named_leaves(t["vs"]))))


def test_packed_rows_bits():
    """Packed rows carry their segment ids in bits 3 and up, filler slots
    are pads, and ``concat_meta`` gives the mmu rows (no seg) segment 0, so
    no two segments merge."""
    ids = torch.tensor([[0, 0, 5, 1, 7, 7, 2, 6, 1, 7, 7, 2, 0, 0]])
    seg = torch.tensor([[0] * 7 + [1] * 5 + [0] * 2], dtype=torch.int32)
    t2i = TM.t2i_attn_meta(ids, 0, 1, 2)._replace(seg=seg)
    mmu = TM.mmu_vit_attn_meta(1, 14, num_tokens=4, prefix_length=3,
                               prompt_len=torch.tensor([12]))
    bits = TM.pack_meta(TM.concat_meta(t2i, mmu))
    np.testing.assert_array_equal((bits[0] >> TM.SEG_SHIFT).numpy(), seg[0].numpy())
    assert (bits[1] >> TM.SEG_SHIFT).eq(0).all()
    vis = TM.unpack_meta(bits).visibility()[:, 0]
    assert not vis[0, 8:12, :7].any() and not vis[0, 2:7, 7:].any()   # segments apart
    assert vis[0, 4, 5] and vis[0, 9, 10]                              # bidirectional blocks
    assert not vis[0, :, 12:].any() and not vis[1, :, 12:].any()       # pads and prompt_len


def test_naflex_tower_raises(models):
    """The NaFlex tower takes no n_grid tiling, as in JAX (its step is held
    to JAX's in tests/test_torch_naflex.py)."""
    _, t = models
    with pytest.raises(ValueError, match="n_grid"):
        TSFT.make_sft_train_step(t["cfg"], t["vq_cfg"], TS2.Siglip2Config.tiny(), None,
                                 TSFT.SFTStepConfig(0, 0, 1, n_grid=2))
    assert TSFT.make_sft_train_step(t["cfg"], t["vq_cfg"], TS2.Siglip2Config.tiny(), None,
                                    TSFT.SFTStepConfig(0, 0, 1)).naflex
