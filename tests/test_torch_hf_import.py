"""The port's checkpoint interop (``utils/hf_import.py``, the models'
converters, ``utils/import_weights.py``) against the JAX package's.

Reference-layout state dicts are written from random port trees by
``chip_smoke.py``'s inverse mapping (``hf_unigen_state_dict``,
``hf_siglip_state_dict``, ``torch_magvit_state_dict``), as numpy for JAX
and as tensors for the port, so no ``transformers`` model is needed. The
oracles are JAX's own tests (tests/test_hf_import.py, test_qwen2.py:35,
test_siglip.py:23, test_siglip2.py:50, test_model_parity.py:633):

* ``load_state_dict``: one safetensors file, shards with an index, one
  ``.bin`` and ``.bin`` shards with an index, bit for bit JAX's;
* ``resize_embedding``: grow, shrink and equal bit for bit in fp32; in bf16
  the new rows are the fp32 mean rounded once, equal to JAX's resize of the
  fp32 upcast table cast to bf16 and within one bf16 step of the mean (JAX's
  numpy mean of a bfloat16 table accumulates in bfloat16);
* the four converters bit for bit (fp32 and bf16) against
  ``weights.*_from_jax`` of JAX's conversion, and against the tree written;
* ``import_unigen`` with a vocab resize, an untied head, the gen parts and
  ``mm_projector``, then logits at 1e-5; a missing key names itself;
* ``import_siglip``'s three prefixes;
* ``build_pipeline(config)`` on reference-layout directories (UniGen in
  shards, MAGViTv2 as ``.bin``, the tower in one file) against JAX's on the
  same directories: trees exact, t2i codes and ``understand`` tokens exact;
* ``import_weights.convert`` against ``scripts/import_weights.py``'s: every
  tensor and ``config.json`` equal, each package reading the other's output;
* one SFT entry step from a reference-layout checkpoint = from the native one.
"""
import dataclasses
import importlib.util
import json
import os
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unigen_tpu import launch as JL
from unigen_tpu.models import builder as JB
from unigen_tpu.models import magvit as JMV
from unigen_tpu.models import qwen2 as JQ
from unigen_tpu.models import siglip as JS
from unigen_tpu.models import siglip2 as JS2
from unigen_tpu.models import unigen as JU
from unigen_tpu.utils import configuration as JC
from unigen_tpu.utils import hf_import as JHI
from unigen_tpu.utils import persistence as JP
from unigen_tpu_torch import launch as TL
from unigen_tpu_torch import weights as W
from unigen_tpu_torch.models import magvit as TMV
from unigen_tpu_torch.models import qwen2 as TQ
from unigen_tpu_torch.models import siglip as TS
from unigen_tpu_torch.models import siglip2 as TS2
from unigen_tpu_torch.models import unigen as TU
from unigen_tpu_torch.training import train_sft as SFT
from unigen_tpu_torch.utils import configuration as TC
from unigen_tpu_torch.utils import hf_import as THI
from unigen_tpu_torch.utils import import_weights as TIW
from unigen_tpu_torch.utils import persistence as TP

from test_torch_launch_config import _same_port_trees, _t2i_codes

ROOT = pathlib.Path(__file__).resolve().parent.parent
SMOKE_SFT = str(ROOT / "configs/tiny/smoke_sft.yaml")


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _load("chip_smoke_for_tests", ROOT / "chip_smoke.py")
JIW = _load("jax_import_weights", ROOT / "scripts" / "import_weights.py")


def _randomize(tree, seed):
    """Every leaf moved by seeded noise (biases and norm scales nonzero and
    distinct), fp32."""
    gen = torch.Generator().manual_seed(seed)
    return W.map_tree(tree, lambda t: (t.float() + 0.02 * torch.randn(t.shape, generator=gen)))


def _np(sd):
    return {k: v.detach().contiguous().numpy() for k, v in sd.items()}


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.reshape(-1).view(np.uint8)


def _tbits(t):
    return t.detach().contiguous().reshape(-1).view(torch.uint8).numpy()


# ---------------------------------------------------------------------------
# load_state_dict, resize_embedding
# ---------------------------------------------------------------------------

def _write_files(root, kind, sd):
    """``sd`` (numpy) in one of four layouts; bf16 only where safetensors holds it."""
    from safetensors.numpy import save_file
    os.makedirs(root, exist_ok=True)
    keys = sorted(sd)
    if kind == "safetensors":
        save_file(sd, os.path.join(root, "model.safetensors"))
        return
    if kind == "bin":
        torch.save({k: torch.from_numpy(sd[k]) for k in keys},
                   os.path.join(root, "pytorch_model.bin"))
        return
    ext = "safetensors" if kind == "safetensors_shards" else "bin"
    stem = "model" if ext == "safetensors" else "pytorch_model"
    weight_map = {}
    for i in range(3):
        name = f"{stem}-{i + 1:05d}-of-00003.{ext}"
        part = {k: sd[k] for k in keys[i::3]}
        if ext == "safetensors":
            save_file(part, os.path.join(root, name))
        else:
            torch.save({k: torch.from_numpy(v) for k, v in part.items()},
                       os.path.join(root, name))
        weight_map.update(dict.fromkeys(part, name))
    with open(os.path.join(root, f"{stem}.{ext}.index.json"), "w") as f:
        json.dump({"metadata": {}, "weight_map": weight_map}, f)


@pytest.mark.parametrize("kind", ["safetensors", "safetensors_shards", "bin", "bin_shards"])
def test_load_state_dict_matches_jax(tmp_path, kind):
    import ml_dtypes
    rng = np.random.default_rng(0)
    sd = {f"layer.{i}.w": rng.normal(size=(3, 5)).astype(np.float32) for i in range(4)}
    sd.update({"i8": np.arange(-4, 4, dtype=np.int8), "f16": rng.normal(size=7).astype(np.float16),
               "scalar": np.asarray(2.5, np.float32)})
    if kind.startswith("safetensors"):
        sd["bf16"] = rng.normal(size=(2, 9)).astype(ml_dtypes.bfloat16)
    _write_files(str(tmp_path), kind, sd)
    got, want = TP.load_state_dict(str(tmp_path)), JHI.load_state_dict(str(tmp_path))
    assert sorted(got) == sorted(want) == sorted(sd)
    for k in sd:
        assert tuple(got[k].shape) == want[k].shape == sd[k].shape, k
        np.testing.assert_array_equal(_tbits(got[k]), _bits(want[k]), err_msg=k)
        np.testing.assert_array_equal(_tbits(got[k]), _bits(sd[k]), err_msg=k)
    if kind == "bin":
        one = TP.load_state_dict(str(tmp_path / "pytorch_model.bin"))
        assert sorted(one) == sorted(sd)
    empty = tmp_path / "empty"
    empty.mkdir()
    for fn in (TP.load_state_dict, JHI.load_state_dict):
        with pytest.raises(FileNotFoundError, match="no weight files"):
            fn(str(empty))


@pytest.mark.parametrize("new", [9, 4, 6], ids=["grow", "shrink", "equal"])
def test_resize_embedding_matches_jax(new):
    import ml_dtypes
    w = np.random.default_rng(1).normal(scale=0.02, size=(6, 5)).astype(np.float32)
    got, want = THI.resize_embedding(torch.from_numpy(w), new), JHI.resize_embedding(w, new)
    assert tuple(got.shape) == want.shape == (new, 5) and got.dtype == torch.float32
    np.testing.assert_array_equal(_tbits(got), _bits(want))
    wb = torch.from_numpy(w).to(torch.bfloat16)
    got = THI.resize_embedding(wb, new)
    assert got.dtype == torch.bfloat16
    want = JHI.resize_embedding(wb.float().numpy(), new).astype(ml_dtypes.bfloat16)
    np.testing.assert_array_equal(_tbits(got), _bits(want))
    if new > 6:
        # within one bf16 step (2^-8 relative) of the fp32 mean of the bf16 table
        mean = wb.float().mean(0)
        step = torch.exp2(torch.floor(torch.log2(mean.abs())) - 7)
        assert bool(((got[6:].float() - mean).abs() <= step).all())
        assert torch.equal(got[:6], wb)


# ---------------------------------------------------------------------------
# the four converters
# ---------------------------------------------------------------------------

def _converter_case(model, dtype):
    """(port tree written, reference-layout state dict, the port's
    conversion, JAX's conversion brought to the port's layout)."""
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    if model == "qwen2":
        tcfg = TQ.Qwen2Config.tiny(vocab_size=97, tie_word_embeddings=False, dtype=tdt)
        jcfg = JQ.Qwen2Config.tiny(vocab_size=97, tie_word_embeddings=False, dtype=jdt)
        ucfg = TU.UniGenConfig.tiny(llm=TQ.Qwen2Config.tiny(vocab_size=97,
                                                            tie_word_embeddings=False))
        tree = _randomize(W.init_unigen(ucfg, torch.Generator().manual_seed(0), "cpu"), 1)
        sd = {("model." + k[10:] if k.startswith("llm.model.") else k[4:]): v
              for k, v in CS.hf_unigen_state_dict(tree).items()}
        got = TQ.convert_hf_state_dict(sd, tcfg)
        want = W.unigen_from_jax({"llm": JQ.convert_hf_state_dict(_np(sd), jcfg)},
                                 TU.UniGenConfig.tiny(llm=tcfg), dtype=tdt)["llm"]
        return tree["llm"], sd, got, want
    if model in ("siglip", "siglip2"):
        naflex = model == "siglip2"
        tcls, jmod, tmod = ((TS2.Siglip2Config, JS2, TS2) if naflex else
                            (TS.SiglipConfig, JS, TS))
        tcfg = tcls.tiny(dtype=tdt)
        jcfg = (JS2.Siglip2Config if naflex else JS.SiglipConfig).tiny(dtype=jdt)
        init = W.init_siglip2 if naflex else W.init_siglip
        tree = _randomize(init(tcls.tiny(), torch.Generator().manual_seed(0), "cpu"), 2)
        sd = CS.hf_siglip_state_dict(tree, torch.Generator().manual_seed(3), naflex=naflex)
        assert "vision_model.encoder.layers.2.mlp.fc2.bias" in sd and \
            "vision_model.post_layernorm.weight" in sd
        got = tmod.convert_hf_state_dict(sd, tcfg)
        want = (W.siglip2_from_jax if naflex else W.siglip_from_jax)(
            jmod.convert_hf_state_dict(_np(sd), jcfg), tcfg, dtype=tdt)
        return tree, sd, got, want
    tcfg, jcfg = TMV.MagvitConfig.tiny(dtype=tdt), JMV.MagvitConfig.tiny(dtype=jdt)
    tree = _randomize(W.init_magvit(TMV.MagvitConfig.tiny(), torch.Generator().manual_seed(0),
                                    "cpu"), 4)
    sd = CS.torch_magvit_state_dict(tree)
    got = TMV.convert_torch_state_dict(sd, tcfg)
    want = W.magvit_from_jax(JMV.convert_torch_state_dict(_np(sd), jcfg), tcfg, dtype=tdt)
    return tree, sd, got, want


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("model", ["qwen2", "siglip", "siglip2", "magvit"])
def test_converters_match_jax(model, dtype):
    tree, sd, got, want = _converter_case(model, dtype)
    _same_port_trees(got, want)
    tdt = getattr(torch, dtype)
    _same_port_trees(got, W.map_tree(tree, lambda t: t.to(tdt)))
    for _, leaf in TP._leaves(got):
        assert leaf.is_contiguous() and leaf.dtype == tdt
    missing = dict(sd)
    key = next(k for k in sd if ".layers.1." in k or ".up.1.block.0.conv2." in k)
    del missing[key]
    convert = {"qwen2": lambda s: TQ.convert_hf_state_dict(
                   s, TQ.Qwen2Config.tiny(vocab_size=97, tie_word_embeddings=False)),
               "siglip": lambda s: TS.convert_hf_state_dict(s, TS.SiglipConfig.tiny()),
               "siglip2": lambda s: TS2.convert_hf_state_dict(s, TS2.Siglip2Config.tiny()),
               "magvit": lambda s: TMV.convert_torch_state_dict(s, TMV.MagvitConfig.tiny())}
    with pytest.raises(KeyError, match=key.replace(".", r"\.")):
        convert[model](missing)


# ---------------------------------------------------------------------------
# import_unigen, import_siglip
# ---------------------------------------------------------------------------

def _unigen_cfgs(**kw):
    kw = dict(dict(w_und_encoder=True, mm_input_dim=24, gen_proj_depth=2), **kw)
    return (JU.UniGenConfig.tiny(llm=JQ.Qwen2Config.tiny(vocab_size=161,
                                                         tie_word_embeddings=False), **kw),
            TU.UniGenConfig.tiny(llm=TQ.Qwen2Config.tiny(vocab_size=161,
                                                         tie_word_embeddings=False), **kw))


def test_import_unigen_matches_jax():
    """A checkpoint of 120 rows grown to 161: the embedding and the untied
    head (mean rows), the gen parts and a 2-layer mm_projector."""
    jcfg, tcfg = _unigen_cfgs()
    tree = _randomize(W.init_unigen(tcfg, torch.Generator().manual_seed(0), "cpu"), 5)
    sd = CS.hf_unigen_state_dict(tree)
    for k in ("llm.model.embed_tokens.weight", "llm.lm_head.weight"):
        sd[k] = sd[k][:120]
    assert {"gen_embed.weight", "gen_projector.2.weight", "img_head.weight",
            "mm_projector.2.bias"} <= set(sd)
    got = THI.import_unigen(sd, tcfg)
    jparams = JHI.import_unigen(_np(sd), jcfg)
    _same_port_trees(got, W.unigen_from_jax(jax.tree.map(np.asarray, jparams), tcfg))
    assert len(got["mm_projector"]) == 2 and len(got["gen_projector"]) == 2
    mean = sd["llm.lm_head.weight"].numpy().mean(0)
    np.testing.assert_array_equal(got["llm"]["lm_head"][120:].numpy(),
                                  np.broadcast_to(mean, (41, mean.size)))
    ids = np.random.default_rng(2).integers(0, tcfg.llm.vocab_size, size=(2, 9))
    jh, _ = JQ.forward(jparams["llm"], jcfg.llm, input_ids=jnp.asarray(ids))
    want = np.asarray(JQ.logits(jparams["llm"], jcfg.llm, jh))
    th, _ = TQ.forward(got["llm"], tcfg.llm, input_ids=torch.from_numpy(ids))
    np.testing.assert_allclose(TQ.logits(got["llm"], tcfg.llm, th).numpy(), want,
                               atol=1e-5, rtol=1e-5)
    del sd["llm.model.layers.1.mlp.up_proj.weight"]
    with pytest.raises(KeyError, match=r"llm\.model\.layers\.1\.mlp\.up_proj\.weight"):
        THI.import_unigen(sd, tcfg)


@pytest.mark.parametrize("prefix", ["vision_model.", "vision_tower.vision_model.", ""])
def test_import_siglip_prefixes_match_jax(prefix):
    tree = _randomize(W.init_siglip(TS.SiglipConfig.tiny(), torch.Generator().manual_seed(0),
                                    "cpu"), 6)
    sd = CS.hf_siglip_state_dict(tree, torch.Generator().manual_seed(7), prefix=prefix)
    got = THI.import_siglip(sd, TS.SiglipConfig.tiny())
    want = W.siglip_from_jax(JHI.import_siglip(_np(sd), JS.SiglipConfig.tiny()),
                             TS.SiglipConfig.tiny())
    _same_port_trees(got, want)
    _same_port_trees(got, tree)


# ---------------------------------------------------------------------------
# build_pipeline(config), import_weights, the SFT entry
# ---------------------------------------------------------------------------

def _write_reference(base, config_path, seed=11):
    """The tiny config's three models as reference-layout checkpoints:
    UniGen in 3 safetensors shards with an index under
    ``base/unigen/unwrapped_model``, MAGViTv2 as ``pytorch_model.bin`` and
    the tower in one safetensors file with its extra layer and
    post_layernorm, under ``base`` by the config's names. Returns (the
    overrides that point the config there, the port trees written)."""
    ov = [f"model.ckpt_base_path={base}", f"model.unigen.pretrained_model_path={base}/unigen"]
    conf = TC.initialize_config(config_path, ov)
    pro = TL.build_prompting_from_config(conf, TL.load_tokenizer(conf))
    cfg = TL.build_unigen_config(conf, pro, torch.float32)
    trees = {"unigen": _randomize(W.init_unigen(cfg, torch.Generator().manual_seed(seed), "cpu"),
                                  seed)}
    CS.write_sharded(CS.hf_unigen_state_dict(trees["unigen"]),
                     os.path.join(base, "unigen", "unwrapped_model"), 3)
    vq_cfg = TL.vq_config(conf, torch.float32)
    trees["vq"] = _randomize(W.init_magvit(vq_cfg, torch.Generator().manual_seed(seed), "cpu"),
                             seed + 1)
    os.makedirs(os.path.join(base, conf.model.vq_model.vq_model_name))
    torch.save({k: v.contiguous() for k, v in CS.torch_magvit_state_dict(trees["vq"]).items()},
               os.path.join(base, conf.model.vq_model.vq_model_name, "pytorch_model.bin"))
    if conf.model.get("vision_tower"):
        vs_cfg = TL.vision_tower_config(conf)
        trees["tower"] = _randomize(W.init_siglip(vs_cfg, torch.Generator().manual_seed(seed),
                                                  "cpu"), seed + 2)
        CS.write_sharded(CS.hf_siglip_state_dict(trees["tower"],
                                                 torch.Generator().manual_seed(seed)),
                         os.path.join(base, conf.model.vision_tower.name), 1)
    return ov, trees


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The tiny SFT config's reference-layout checkpoints, written once for
    the tests that read them: (their directory, the overrides, the trees)."""
    base = str(tmp_path_factory.mktemp("ref"))
    ov, trees = _write_reference(base, SMOKE_SFT)
    return base, ov, trees


def test_build_pipeline_from_reference_layouts_matches_jax(reference):
    _, ov, trees = reference
    jpipe = JL.build_pipeline(JC.initialize_config(SMOKE_SFT, ov), dtype=jnp.float32)
    tpipe = TL.build_pipeline(TC.initialize_config(SMOKE_SFT, ov), dtype=torch.float32,
                              device="cpu")
    _same_port_trees(tpipe.params, W.unigen_from_jax(jax.tree.map(np.asarray, jpipe.params),
                                                     tpipe.cfg))
    _same_port_trees(tpipe.params, trees["unigen"])
    _same_port_trees(tpipe.vq_params, W.magvit_from_jax(
        jax.tree.map(np.asarray, jpipe.vq_params), tpipe.vq_cfg))
    _same_port_trees(tpipe.vq_params, trees["vq"])
    _same_port_trees(tpipe.vision_params, W.siglip_from_jax(
        jax.tree.map(np.asarray, jpipe.vision_params), tpipe.vision_cfg))
    _same_port_trees(tpipe.vision_params, trees["tower"])
    got, want = _t2i_codes(jpipe, tpipe)
    np.testing.assert_array_equal(got, want)
    px = np.random.default_rng(6).integers(0, 256, size=(2, 28, 28, 3), dtype=np.uint8)
    qs = ["what is this?", "is it red?"]
    want = np.asarray(jpipe.understand(jnp.asarray(px), qs, jax.random.key(6), max_new_tokens=6))
    np.testing.assert_array_equal(tpipe.understand(px, qs, None, max_new_tokens=6).numpy(), want)


def test_import_weights_matches_jax(reference, tmp_path, monkeypatch):
    """Both ``convert``s on the same reference checkpoints (UniGen sharded);
    JAX's script converts MAGViTv2 and the tower at the full configs'
    defaults, which the tiny config's overrides stand in for here."""
    base = reference[0]
    conf_kw = ["model.unigen.pretrained_model_path="]
    tconf = TC.initialize_config(SMOKE_SFT, conf_kw)
    jconf = JC.initialize_config(SMOKE_SFT, conf_kw)
    srcs = dict(unigen_src=os.path.join(base, "unigen"),
                magvit_src=os.path.join(base, "magvitv2-smoke"),
                vision_src=os.path.join(base, "siglip-smoke"))
    # the tiny sizes as JAX configs (float32, the defaults), without JAX's random inits
    jvq = JMV.MagvitConfig(**{k: v for k, v in
                              dataclasses.asdict(TL.vq_config(tconf, torch.float32)).items()
                              if k != "dtype"})
    jvs = JS.SiglipConfig(**{k: v for k, v in dataclasses.asdict(TL.vision_tower_config(tconf))
                             .items() if k != "dtype"})
    monkeypatch.setattr(JMV, "MagvitConfig", lambda: jvq)
    monkeypatch.setattr(JB, "get_vision_tower_config", lambda name: (JS, jvs))
    jout, tout = str(tmp_path / "jax"), str(tmp_path / "port")
    assert JIW.convert(jconf, out=jout, **srcs) == \
        {k: os.path.join(jout, v) for k, v in (("unigen", "unigen"), ("magvitv2", "magvitv2"),
                                               ("siglip-smoke", "siglip-smoke"))}
    monkeypatch.undo()
    written = TIW.convert(tconf, out=tout, **srcs)
    assert sorted(written) == ["magvitv2", "siglip-smoke", "unigen"]
    for comp in written:
        got = TP.load_state_dict(written[comp])
        want = JHI.load_state_dict(os.path.join(jout, comp))
        assert sorted(got) == sorted(want), comp
        for k in want:
            assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype), (comp, k)
            np.testing.assert_array_equal(_tbits(got[k]), _bits(want[k]), err_msg=f"{comp} {k}")
        with open(os.path.join(written[comp], "config.json")) as f:
            tjson = json.load(f)
        with open(os.path.join(jout, comp, "config.json")) as f:
            jjson = json.load(f)
        # JAX's MagvitConfig alone has fused_convs (which conv route JAX runs)
        assert tjson == {k: v for k, v in jjson.items() if k != "fused_convs"}, comp
    # each package reads the other's output
    jcfg = JL.build_unigen_config(jconf, JL.build_prompting(jconf, JL.load_tokenizer(jconf)))
    template = jax.eval_shape(lambda k: JU.init(k, jcfg), jax.random.key(0))
    jread = JP.from_pretrained(written["unigen"], template)[0]
    tpro = TL.build_prompting_from_config(tconf, TL.load_tokenizer(tconf))
    tcfg = TL.build_unigen_config(tconf, tpro)
    tread = TL._load_native(os.path.join(jout, "unigen"),
                            W.unigen_to_jax(W.init_unigen(tcfg, None, "meta"), tcfg),
                            lambda t: W.unigen_from_jax(t, tcfg))
    _same_port_trees(tread, W.unigen_from_jax(jax.tree.map(np.asarray, jread), tcfg))
    _same_port_trees(tread, THI.import_unigen(os.path.join(base, "unigen", "unwrapped_model"),
                                              tcfg))
    with pytest.raises(SystemExit) as e:
        TIW.main([f"config={SMOKE_SFT}"])
    assert e.value.code == 2


def test_sft_step_from_reference_layout_matches_native(reference, tmp_path):
    """One step of the SFT entry from a reference-layout
    ``pretrained_model_path`` equals the step from the same weights saved
    natively."""
    base, ov, trees = reference
    conf = TC.initialize_config(SMOKE_SFT, ov)
    pro = TL.build_prompting_from_config(conf, TL.load_tokenizer(conf))
    cfg = TL.build_unigen_config(conf, pro, torch.float32)
    native = str(tmp_path / "native")
    TP.save_pretrained(W.unigen_to_jax(trees["unigen"], cfg), native, config=cfg)
    states = {}
    for label, path in (("reference", os.path.join(base, "unigen")), ("native", native)):
        run = SFT.SFTRun(TC.initialize_config(SMOKE_SFT, [
            f"experiment.output_dir={tmp_path / label}", "device=cpu",
            "training.max_train_steps=1", "experiment.save_every=0",
            f"model.unigen.pretrained_model_path={path}"]))
        states[label] = run.train()
        with open(tmp_path / label / "metrics.jsonl") as f:
            states[label + " log"] = [json.loads(line) for line in f]
    _same_port_trees(states["reference"].params, states["native"].params)
    keys = ("loss", "loss_t2i", "loss_lm", "loss_mmu", "grad_norm")
    assert [[e[k] for k in keys] for e in states["reference log"]] == \
        [[e[k] for k in keys] for e in states["native log"]]
