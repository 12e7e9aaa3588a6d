"""The port's config-driven launch against the JAX package.

* ``utils/configuration.py``: the port's YAML reader equals ``yaml.safe_load``
  on every file under ``configs/`` and on override values;
  ``initialize_config`` (overrides, interpolation, ``config=`` skipped) and
  ``flatten_config`` equal JAX's;
* ``utils/checkpoint_registry.py`` resolves as JAX's does;
* ``utils/persistence.py``: files that JAX's ``save_pretrained`` writes
  (one file and shards; fp32, bf16 and the integer and bool dtypes) read
  back bit for bit, and the port's files read back bit for bit by JAX's
  ``from_pretrained``, through ``weights.py``'s bridge both ways;
* ``launch``: ``build_unigen_config`` of the flagship SFT config equals
  JAX's field by field; ``build_pipeline(config)`` of the tiny PT2 and SFT
  configs over native checkpoints that JAX wrote in the test gives JAX's
  parameters exactly, t2i codes exact under shared noise and ``understand``
  tokens exact, also with ``model.quantization=int8``;
* ``models/builder.py`` (the NaFlex name dispatching to ``models.siglip2``),
  ``models/registry.py``, the refusal of a torch-layout checkpoint that
  lacks a tensor, ``enable_reuse_tk`` as JAX builds it; ``task_token_first``.
"""
import dataclasses
import glob
import json
import math
import os
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from unigen_tpu import launch as JL
from unigen_tpu.generation import t2i_generate as j_t2i
from unigen_tpu.models import builder as JB
from unigen_tpu.models import magvit as JMV
from unigen_tpu.models import registry as JR
from unigen_tpu.models import siglip as JS
from unigen_tpu.models import unigen as JU
from unigen_tpu.ops import masks as JM
from unigen_tpu.ops import quantization as JQZ
from unigen_tpu.prompting import UniPrompting as JPrompting
from unigen_tpu.utils import checkpoint_registry as JCR
from unigen_tpu.utils import configuration as JC
from unigen_tpu.utils import persistence as JP
from unigen_tpu_torch import launch as TL
from unigen_tpu_torch import weights as W
from unigen_tpu_torch.models import builder as TB
from unigen_tpu_torch.models import registry as TR
from unigen_tpu_torch.prompting import UniPrompting as TPrompting
from unigen_tpu_torch.utils import checkpoint_registry as TCR
from unigen_tpu_torch.utils import configuration as TC
from unigen_tpu_torch.utils import persistence as TP

from test_prompting import MockTokenizer, SPECIALS
from test_torch_qwen2 import _perturb

ROOT = pathlib.Path(__file__).resolve().parent.parent
CONFIGS = sorted(str(p.relative_to(ROOT)) for p in ROOT.glob("configs/**/*.yaml"))


# ---------------------------------------------------------------------------
# configuration
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("path", CONFIGS)
def test_yaml_reader_matches_safe_load(path):
    text = (ROOT / path).read_text()
    assert TC.load_yaml(text) == yaml.safe_load(text)


_VALUES = ["8000", "-7", "+3", "0x1f", "012", "0b101", "1_000", "1.0e-3", "1e-3", "1.0e3", ".5",
           "3.", "-.inf", "true", "True", "no", "off", "null", "~", "", "abc", "foo bar",
           "x:y", "'x y'", "'it''s'", '"a\\tb\\u00e9"', "[64]", "[64, 128]", "[]", "{}",
           "{a: 1, b: [1, 2], c: {d: 'e'}}", "[a, 'b', {c: d}]", "a: b", "${a.b}",
           "llm,mm_projector", "output/x.yaml"]


@pytest.mark.parametrize("value", _VALUES)
def test_override_values_parse_as_safe_load(value):
    try:
        want = yaml.safe_load(value)
    except yaml.YAMLError:
        want = value
    got = TC._parse_value(value)
    assert type(got) is type(want) and (got == want or (isinstance(want, float)
                                                         and math.isnan(want)))


def test_initialize_config_matches_jax(tmp_path):
    p = str(tmp_path / "c.yaml")
    with open(p, "w") as f:
        f.write("a:\n  b: 1\n  lr: 2.0e-4\nc: ${a.lr}\n")
    ov = ["a.b=5", "d.e=hello", "config=ignored", "x.y=[1, 2]", "z=${a.b}", "no_equals"]
    got, want = TC.initialize_config(p, ov), JC.initialize_config(p, ov)
    assert got == want and got.a.b == 5 and got.c == 2e-4 and got.z == 5
    assert got.get("missing", 7) == 7 and isinstance(got.a, TC.Config)
    assert TC.flatten_config(got) == JC.flatten_config(want)
    for path in CONFIGS:
        ov = ["serving.port=8123", "serving.buckets=[64]", "model.unigen.num_hidden_layers=2",
              "optimizer.params.learning_rate=3.0e-5"]
        got, want = TC.initialize_config(str(ROOT / path), ov), \
            JC.initialize_config(str(ROOT / path), ov)
        assert got == want, path
        assert got["lr_scheduler"]["params"]["learning_rate"] == 3.0e-5
        assert TC.flatten_config(got) == JC.flatten_config(want)
    with pytest.raises(ValueError, match="unsupported"):
        TC.load_yaml("a:\n  - 1\n")


def test_checkpoint_registry_matches_jax(tmp_path):
    (tmp_path / "google" / "siglip-so400m-patch14-384").mkdir(parents=True)
    (tmp_path / "mine").mkdir()
    assert TCR.CHECKPOINT_REGISTRY == JCR.CHECKPOINT_REGISTRY
    for name in ("siglip", "SigLIP", "mine", "magvitv2", "other/path"):
        for base in ("", str(tmp_path)):
            assert TCR.real_checkpoint(name, base) == JCR.real_checkpoint(name, base)
    TCR.register_checkpoint("MyAlias", "somewhere")
    try:
        assert TCR.real_checkpoint("myalias") == "somewhere"
    finally:
        del TCR.CHECKPOINT_REGISTRY["myalias"]


# ---------------------------------------------------------------------------
# persistence
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_unigen():
    cfg_kw = dict(w_und_encoder=True, mm_input_dim=32)
    jcfg = JU.UniGenConfig.tiny(**cfg_kw)
    from unigen_tpu_torch.models import unigen as TU
    tcfg = TU.UniGenConfig.tiny(**cfg_kw)
    tree = _perturb(jax.tree.map(np.asarray, JU.init(jax.random.key(0), jcfg)),
                    np.random.default_rng(0))
    return jcfg, tcfg, tree


def _bits(t: torch.Tensor) -> np.ndarray:
    t = t.detach().contiguous()
    if t.dtype == torch.bool:
        return t.numpy()
    return t.reshape(-1).view(torch.uint8).numpy()


def _same_port_trees(a, b):
    la, lb = list(TP._leaves(a)), list(TP._leaves(b))
    assert [k for k, _ in la] == [k for k, _ in lb]
    for (k, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape, k
        np.testing.assert_array_equal(_bits(x), _bits(y), err_msg=k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shard", [None, 20_000])
def test_jax_checkpoint_read_by_port_bit_for_bit(tmp_path, tiny_unigen, dtype, shard):
    jcfg, tcfg, tree = tiny_unigen
    jtree = jax.tree.map(lambda a: jnp.asarray(a, dtype), tree)
    kw = {} if shard is None else dict(max_shard_bytes=shard)
    JP.save_pretrained(jtree, str(tmp_path), config=jcfg, **kw)
    assert (len(glob.glob(str(tmp_path / "*.safetensors"))) > 1) == (shard is not None)
    tdtype = getattr(torch, dtype)
    template = W.unigen_to_jax(W.init_unigen(tcfg, None, "meta", tdtype), tcfg)
    got, cfg_json = TP.from_pretrained(str(tmp_path), template)
    assert cfg_json["llm.hidden_size"] == 64
    want = W.unigen_from_jax(jax.tree.map(np.asarray, jtree), tcfg, dtype=tdtype)
    _same_port_trees(W.unigen_from_jax(got, tcfg, dtype=tdtype), want)


@pytest.mark.parametrize("shard", [None, 20_000])
def test_port_checkpoint_read_by_jax_bit_for_bit(tmp_path, tiny_unigen, shard):
    jcfg, tcfg, tree = tiny_unigen
    for dtype in ("float32", "bfloat16"):
        jtree = jax.tree.map(lambda a: jnp.asarray(a, dtype), tree)
        tparams = W.unigen_from_jax(jax.tree.map(np.asarray, jtree), tcfg,
                                    dtype=getattr(torch, dtype))
        out = str(tmp_path / dtype)
        kw = {} if shard is None else dict(max_shard_bytes=shard)
        TP.save_pretrained(W.unigen_to_jax(tparams, tcfg), out, config=tcfg, **kw)
        got, cfg_json = JP.from_pretrained(out, jtree)
        assert cfg_json["llm.num_hidden_layers"] == 2
        jax.tree.map(lambda a, b: np.testing.assert_array_equal(
            np.asarray(a).view(np.uint8), np.asarray(b).view(np.uint8)), got, jtree)


def test_every_dtype_round_trips_with_jax(tmp_path):
    """F32, BF16, F16, I8, I32, U8 and BOOL leaves: JAX -> port -> JAX."""
    tree = {"a": {"w": jnp.asarray(np.arange(6, dtype=np.float32).reshape(2, 3)),
                  "b": jnp.asarray([1.5, -2], jnp.bfloat16)},
            "l": [{"k": jnp.asarray([1, -2], jnp.int8)}, {"k": jnp.asarray([True, False])}],
            "u": jnp.asarray([3, 250], jnp.uint8), "i": jnp.asarray([7, -9], jnp.int32),
            "h": jnp.asarray([[1.25, -3]], jnp.float16)}
    JP.save_pretrained(tree, str(tmp_path / "j"), max_shard_bytes=8)
    assert json.load(open(tmp_path / "j" / JP.INDEX_NAME))["weight_map"]
    template = jax.tree.map(lambda a: torch.empty(a.shape, dtype=getattr(torch, str(a.dtype)),
                                                  device="meta"), tree)
    got, _ = TP.from_pretrained(str(tmp_path / "j"), template)
    for (k, t), (_, a) in zip(TP._leaves(got), TP._leaves(jax.tree.map(np.asarray, tree))):
        np.testing.assert_array_equal(_bits(t), a.reshape(-1).view(np.uint8)
                                      if a.dtype != bool else a, err_msg=k)
    for shard in (8, TP.MAX_SHARD_BYTES):
        TP.save_pretrained(got, str(tmp_path / f"t{shard}"), max_shard_bytes=shard)
        back, _ = JP.from_pretrained(str(tmp_path / f"t{shard}"), tree)
        jax.tree.map(lambda a, b: np.testing.assert_array_equal(np.asarray(a), np.asarray(b)),
                     back, tree)
    with pytest.raises(ValueError, match="shape"):
        TP.from_pretrained(str(tmp_path / "j"), dict(template, u=torch.empty((3,),
                                                                             device="meta")))


# ---------------------------------------------------------------------------
# launch
# ---------------------------------------------------------------------------

def test_build_unigen_config_matches_jax():
    path = str(ROOT / "configs/unigen_1_5b/unigen_sft.yaml")
    jconf, tconf = JC.initialize_config(path, []), TC.initialize_config(path, [])
    jpro = JL.build_prompting(jconf, JL.load_tokenizer(jconf))
    tpro = TL.build_prompting_from_config(tconf, TL.load_tokenizer(tconf))
    assert (tpro.max_seq_len, tpro.task_token_first) == (jpro.max_seq_len, False) == (1603, False)
    jcfg, tcfg = JL.build_unigen_config(jconf, jpro), TL.build_unigen_config(tconf, tpro)

    def fields(c):
        return {f.name: (fields(getattr(c, f.name)) if dataclasses.is_dataclass(getattr(c, f.name))
                         else str(getattr(c, f.name)).rsplit(".", 1)[-1].strip("'>"))
                for f in dataclasses.fields(c)}
    assert fields(tcfg) == fields(jcfg)
    assert tcfg.llm.dtype == torch.bfloat16 and tcfg.llm.num_hidden_layers == 28


def _save_checkpoints(config_path, base):
    """JAX writes the three models of a tiny config as native checkpoints
    (random from other keys than launch's, biases and norm scales
    perturbed): UniGen under ``base/unigen/unwrapped_model``, MAGViTv2 and
    the tower under ``base`` by their config names. Returns the overrides
    that point the config at them."""
    ov = [f"model.ckpt_base_path={base}", f"model.unigen.pretrained_model_path={base}/unigen"]
    conf = JC.initialize_config(config_path, ov)
    pro = JL.build_prompting(conf, JL.load_tokenizer(conf))
    rng = np.random.default_rng(4)
    cfg = JL.build_unigen_config(conf, pro, jnp.float32)
    JP.save_pretrained(_perturb(jax.tree.map(np.asarray, JU.init(jax.random.key(7), cfg)), rng),
                       os.path.join(base, "unigen", "unwrapped_model"))
    vq_cfg = JL.build_vq(conf, jnp.float32)[1]
    JP.save_pretrained(_perturb(jax.tree.map(np.asarray, JMV.init(jax.random.key(8), vq_cfg)),
                                rng), os.path.join(base, conf.model.vq_model.vq_model_name),
                       max_shard_bytes=50_000)
    if conf.model.get("vision_tower"):
        vs_cfg = JL.build_vision_tower(conf, jnp.float32)[1]
        JP.save_pretrained(_perturb(jax.tree.map(np.asarray, JS.init(jax.random.key(9), vs_cfg)),
                                    rng), os.path.join(base, conf.model.vision_tower.name))
    return ov


def _t2i_codes(jpipe, tpipe, prompts=("a red cat", "two dogs")):
    steps, n = 3, jpipe.cfg.num_vq_tokens
    mask_img = np.full((len(prompts), n), jpipe.cfg.mask_token_id, np.int64)
    ids, _ = jpipe.prompting((list(prompts), mask_img, 8), "t2i_gen")
    uncond, _ = jpipe.prompting(([""] * len(prompts), mask_img, 8), "t2i_gen")
    tids, tuncond = tpipe.prompt_ids(list(prompts), 8)
    np.testing.assert_array_equal(ids, tids)
    np.testing.assert_array_equal(uncond, tuncond)
    rng = np.random.default_rng(5)
    u_s = rng.random((steps, len(prompts), n, jpipe.cfg.codebook_size), dtype=np.float32)
    u_m = rng.random((steps, len(prompts), n), dtype=np.float32)
    sp, pad = jpipe.prompting.sptids_dict, jpipe.prompting.pad_id
    mask = JM.create_attention_mask_predict_next(
        jnp.asarray(np.concatenate([ids, uncond])), pad, sp["<|soi|>"], sp["<|eoi|>"],
        rm_pad_in_image=True)
    want = j_t2i(jpipe.params, jpipe.cfg, jax.random.key(0), jnp.asarray(ids), mask,
                 uncond_input_ids=jnp.asarray(uncond), guidance_scale=2.0, timesteps=steps,
                 temperature=1.0, pad_id=pad, noise=(jnp.asarray(u_s), jnp.asarray(u_m)))
    got = tpipe.generate_images(list(prompts), None, guidance_scale=2.0, timesteps=steps,
                                max_text_len=8, return_codes=True,
                                noise=(torch.from_numpy(u_s), torch.from_numpy(u_m)))
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("name,quant", [("smoke_pt2", False), ("smoke_sft", False),
                                        ("smoke_sft", True)])
def test_build_pipeline_from_config_matches_jax(tmp_path, name, quant):
    """With ``model.quantization=int8`` the oracle is JAX's float pipeline
    of the same config with JAX's quantizers applied eagerly: JAX's launch
    runs them under ``jit``, where XLA on the CPU may turn the division by
    127 of a weight scale into a product with its reciprocal, one ulp off."""
    path = str(ROOT / f"configs/tiny/{name}.yaml")
    ov = _save_checkpoints(path, str(tmp_path))
    jpipe = JL.build_pipeline(JC.initialize_config(path, ov), dtype=jnp.float32)
    if quant:
        ov.append("model.quantization=int8")
        jpipe = dataclasses.replace(
            jpipe, params=JQZ.quantize_unigen_params(jpipe.params, jpipe.cfg, lm_head=True),
            vision_params=JQZ.quantize_siglip_params(jpipe.vision_params))
    tpipe = TL.build_pipeline(TC.initialize_config(path, ov), dtype=torch.float32, device="cpu")
    assert tpipe.cfg.llm.vocab_size == jpipe.cfg.llm.vocab_size == 151674 + 16 + 1
    _same_port_trees(tpipe.params, W.unigen_from_jax(jax.tree.map(np.asarray, jpipe.params),
                                                     tpipe.cfg))
    _same_port_trees(tpipe.vq_params, W.magvit_from_jax(jax.tree.map(np.asarray, jpipe.vq_params),
                                                        tpipe.vq_cfg))
    got, want = _t2i_codes(jpipe, tpipe)
    np.testing.assert_array_equal(got, want)
    if name == "smoke_sft":
        _same_port_trees(tpipe.vision_params, W.siglip_from_jax(
            jax.tree.map(np.asarray, jpipe.vision_params), tpipe.vision_cfg))
        px = np.random.default_rng(6).integers(0, 256, size=(2, 28, 28, 3), dtype=np.uint8)
        qs = ["what is this?", "is it red?"]
        want = np.asarray(jpipe.understand(jnp.asarray(px), qs, jax.random.key(6),
                                           max_new_tokens=6))
        np.testing.assert_array_equal(tpipe.understand(px, qs, None, max_new_tokens=6).numpy(),
                                      want)
    else:
        assert tpipe.vision_params is None and jpipe.vision_params is None


def test_random_init_and_refusals(tmp_path, caplog):
    path = str(ROOT / "configs/tiny/smoke_pt2.yaml")
    with caplog.at_level("WARNING"):
        pipe = TL.build_pipeline(TC.initialize_config(
            path, [f"model.unigen.pretrained_model_path={tmp_path}/absent"]), device="cpu")
    text = caplog.text
    assert "using byte-level fallback" in text and "random init" in text
    assert pipe.cfg.llm.dtype == torch.bfloat16 and pipe.params["llm"]["embed"].dtype == torch.bfloat16
    torch_dir = tmp_path / "torch_layout"
    torch_dir.mkdir()
    TP.save_file({"model.embed_tokens.weight": torch.zeros(2, 2)},
                 str(torch_dir / "model.safetensors"))
    conf = TC.initialize_config(path, [f"model.unigen.pretrained_model_path={torch_dir}"])
    # a torch-layout checkpoint is converted on load (utils/hf_import.py): one
    # that lacks a tensor the model needs names it
    with pytest.raises(KeyError, match=r"llm\.model\.embed_tokens\.weight"):
        TL.build_pipeline(conf, device="cpu")
    assert TB.get_vision_tower_config("siglip2-so400m-patch16-naflex")[0].__name__ == \
        "unigen_tpu_torch.models.siglip2"
    # enable_reuse_tk builds (it raised before the rest of prompting was
    # ported) and maps the vision markers as JAX's build_prompting does
    reuse = ["model.enable_reuse_tk=true"]
    tp = TL.build_prompting_from_config(TC.initialize_config(path, reuse), TL.FallbackTokenizer())
    jp = JL.build_prompting(JC.initialize_config(path, reuse), JL.FallbackTokenizer())
    assert tp.sptids_dict == jp.sptids_dict
    assert tp.sptids_dict["<|soi|>"] == TL.FallbackTokenizer().convert_tokens_to_ids(
        ["<|vision_start|>"])[0]


@pytest.mark.parametrize("kw", [dict(seed=1), dict(vision=True), dict(quantization="int4"),
                                dict(quantized_cache=True)], ids=lambda kw: next(iter(kw)))
def test_build_pipeline_config_refuses_code_built_settings(kw):
    """A config sets the seed, the tower, the quantization and the cache
    itself: ``build_pipeline(config, quantization="int4")`` must not hand
    back a float pipeline."""
    conf = TC.initialize_config(str(ROOT / "configs/tiny/smoke_pt2.yaml"), [])
    with pytest.raises(ValueError, match="from the config"):
        TL.build_pipeline(conf, device="cpu", **kw)


def test_builder_and_registry_dispatch():
    for name in ("siglip-so400m-patch14-384", "SigLIP-smoke"):
        (tm, tcfg), (jm, jcfg) = TB.get_vision_tower_config(name), JB.get_vision_tower_config(name)
        assert tm.__name__.rsplit(".", 1)[-1] == jm.__name__.rsplit(".", 1)[-1] == "siglip"
        assert dataclasses.asdict(tcfg).keys() == dataclasses.asdict(jcfg).keys()
        assert tcfg.hidden_size == jcfg.hidden_size and tcfg.num_patches == jcfg.num_patches
    for bad in ("clip", "resnet"):
        with pytest.raises(ValueError):
            TB.get_vision_tower_config(bad)
    for name in ("magvitv2", "VQ_16-x", "siglip-so400m", "unigen-1.5b"):
        (tm, tcfg), (jm, jcfg) = TR.model_from_name(name), JR.model_from_name(name)
        assert tm.__name__.rsplit(".", 1)[-1] == jm.__name__.rsplit(".", 1)[-1]
        assert type(tcfg).__name__ == type(jcfg).__name__
        assert name in TR.MODEL_REGISTRY
    assert "llama" not in TR.MODEL_REGISTRY
    with pytest.raises(KeyError):
        TR.model_from_name("llama")


@pytest.mark.parametrize("first", [True, False])
def test_task_token_first_matches_jax(first):
    ours = TPrompting(MockTokenizer(), special_tokens=SPECIALS, max_seq_len=64,
                      task_token_first=first)
    ref = JPrompting(MockTokenizer(), special_tokens=SPECIALS, max_seq_len=64,
                     cond_dropout_prob=0.0, task_token_first=first)
    img = np.full((2, 16), 77, np.int64)
    for got, want in zip(ours((["a red cat", "a dog"], img, 8), "t2i_gen"),
                         ref((["a red cat", "a dog"], img, 8), "t2i_gen")):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(ours((img, ["what?", "why not?"]), "mmu"),
                         ref((img, ["what?", "why not?"]), "mmu")):
        np.testing.assert_array_equal(got, want)
    q = np.asarray([[5, 6, 7, 8], [5, 9, 9, 0]])
    for got, want in zip(ours((np.zeros((2, 4, 1)), q, None, None), "mmu_conv"),
                         ref((np.zeros((2, 4, 1)), q, None, None), "mmu_conv")):
        np.testing.assert_array_equal(got, want)


def test_no_module_level_import_of_host_only_packages():
    """The port depends on no yaml, safetensors, PIL, transformers,
    tokenizers or regex, which the card's machine need not have: no module
    of the port imports them when it is imported (only inside a function, where a path that needs them runs),
    and nothing of the port imports ``transformers`` at all, inside
    functions or by name: the tokenizer directory is read by
    ``utils/qwen_tokenizer.py``."""
    import ast
    banned = {"yaml", "safetensors", "PIL", "transformers", "tokenizers", "regex"}
    package = sorted((ROOT / "unigen_tpu_torch").rglob("*.py"))
    for path in package + [ROOT / "chip_smoke.py"]:
        for node in ast.parse(path.read_text()).body:
            names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            assert not {n.split(".")[0] for n in names} & banned, (path, names)
    for path in package:
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom) else
                     [node.value] if isinstance(node, ast.Constant) else [])
            assert "transformers" not in {str(n).split(".")[0] for n in names}, (path, names)
