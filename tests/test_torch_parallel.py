"""The port's parallelism against the JAX package's, on the CPU in fp32.

The specs of every leaf of the tiny UniGen, SigLIP and MAGViTv2 trees (and
of a UniGen of vocabulary 512, whose embedding shards) against JAX's
``partition_*`` / ``add_fsdp`` / ``sanitize_specs``. Then one spawn of 8
gloo ranks (``torch_parallel_ranks.parallel_all``) runs, on the tiny
models with JAX's weights, batches and draws:

* the PT2 step at data 4 x model 2, against JAX's step sharded on the same
  mesh of 8 virtual devices (tests/test_training.py's setup) and against
  the port's unsharded step; and at data 2 x model 4, where two KV heads do
  not divide over the model axis (k/v whole, sliced a rank);
* the SFT step (separate and packed modes, tower sharded) and the DPO step
  (reference sharded) at data 4 x model 2, against JAX's unsharded steps;
* the vocab-parallel embedding and text head at vocab 512, model 2;
* a checkpoint saved on (2, 2, 2) with ``add_fsdp`` and restored bit for bit
  onto (4, 2, 1), then one more step; this process restores it onto one
  process, and reads the ``unwrapped_model`` back through
  ``launch.build_pipeline``;
* t2i at model 2 against the unsharded sampler; the errors;
* the engine at model 2, float, in int8+kv and in int8+int4, against the
  one-rank engine and JAX's;
* JAX's W8A8 and W4A8 trees at model 2: the row-parallel products against
  one rank's (W8A8 bit for bit), the int8 t2i codes, the W4A8 backbone with
  the down projection's groups straddling a rank's cut; every quantized and
  LoRA tree gathered back from its shards bit for bit;
* the SFT (separate and packed) and DPO steps with LoRA adapters at model 2;
* trees derived from shards (a clone, a deep copy, a ``torch.save`` /
  ``torch.load`` round trip, a cast to float64 and back), run with their
  ``Sharding``: the logits at model 2 and the PT2 step on (2, 2, 2) with
  ``add_fsdp``, against JAX's and the port's unsharded runs; and the error
  a sharded tree run without its specs raises.

The JAX references are computed here while the ranks run.
"""
import json
import os
import re
import threading
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

import torch_parallel_ranks as R
from test_torch_training import _jax_draws, _leaf_errors, _perturb
from test_torch_int4 import _match_but_flips
from test_torch_int8 import PAD, SOI, EOI, STEPS, _t2i_prompts
from unigen_tpu.generation import t2i_generate as j_t2i
from unigen_tpu.models import magvit as JMV
from unigen_tpu.models import qwen2 as JQ
from unigen_tpu.models import siglip as JSG
from unigen_tpu.models import unigen as JU
from unigen_tpu.ops import masks as JM
from unigen_tpu.parallel import make_mesh as j_make_mesh
from unigen_tpu.parallel import partition as JP
from unigen_tpu.serving.engine import ServingEngine as JServingEngine
from unigen_tpu.training import dpo as JDPO
from unigen_tpu.training import lr_schedules as JLRS
from unigen_tpu.training import optimizer as JO
from unigen_tpu.training import sft as JSFT
from unigen_tpu.training import train_step as JT
from unigen_tpu_torch import parallel as P
from unigen_tpu_torch.launch import build_pipeline
from unigen_tpu_torch import weights as W
from unigen_tpu_torch.models import magvit as TMV
from unigen_tpu_torch.models import siglip as TSG
from unigen_tpu_torch.models import unigen as TU
from unigen_tpu_torch.ops import int4 as TI4
from unigen_tpu_torch.ops import masks as TM
from unigen_tpu_torch.ops import quantization as TQZ
from unigen_tpu_torch.parallel import partition as PT
from unigen_tpu_torch.training import lora as TL
from unigen_tpu_torch.training import optimizer as TO
from unigen_tpu_torch.training import train_step as TT
from unigen_tpu_torch.training.train import build_trainer
from unigen_tpu_torch.utils import checkpoint as CK
from unigen_tpu_torch.utils.configuration import initialize_config

PT2_METRICS = TT.METRICS + ("grad_norm",)
SFT_METRICS = ("loss", "loss_t2i", "loss_lm", "loss_mmu", "grad_norm", "avg_masking_rate")
DPO_METRICS = ("loss", "reward_accuracy", "policy_chosen_logps", "policy_rejected_logps",
               "chosen_masking_rate", "rejected_masking_rate", "grad_norm")
COSINE = ("cosine", dict(num_warmup_steps=2, num_training_steps=50))
SMOKE = os.path.join(R.REPO, "configs", "tiny", "smoke_pt2.yaml")
CKPT_OVERRIDES = ["device=cpu", "training.batch_size_t2i=8", "training.batch_size_lm=8",
                  "training.batch_size_mmu=8", "experiment.checkpoints_total_limit=3"]


class SpecMesh:
    """A mesh's axis sizes, all ``sanitize_specs`` and ``align_heads`` read."""

    def __init__(self, data, fsdp, model):
        self.shape = {"data": data, "fsdp": fsdp, "model": model}

    def size(self, *axes):
        return int(np.prod([self.shape[a] for a in axes]))


# ---------------------------------------------------------------------------
# shared tiny models
# ---------------------------------------------------------------------------

def _numpy(tree):
    return jax.tree.map(lambda t: t.detach().numpy(), tree)


# the W4A8 tree's backbone: a rank's down projection at model 2 (192 -> 96
# rows) cuts a group of 64 in half, its o projection (128 -> 64) does not
W4_LLM = dict(vocab_size=161, hidden_size=128, intermediate_size=192, head_dim=32)
W4_GROUP = 64
LORA = ("lora_a", "lora_b")


def _unigen(llm=None, **kw):
    """(JAX config, JAX-layout numpy tree, port config, port tree): the
    port's init with perturbed biases and norm scales, carried across;
    ``llm``: Qwen2 overrides of the tiny backbone."""
    jcfg, tcfg = (m.UniGenConfig.tiny(**kw, **({} if llm is None else {
        "llm": q.Qwen2Config.tiny(**llm)})) for m, q in ((JU, JQ), (TU, TU.qwen2)))
    params = W.init_unigen(tcfg, torch.Generator().manual_seed(0), "cpu")
    tree = _perturb(_numpy(W.unigen_to_jax(params, tcfg)), np.random.default_rng(0))
    return jcfg, tree, tcfg, W.unigen_from_jax(tree, tcfg)


def _vq():
    jvq, tvq = (m.MagvitConfig.tiny(resolution=8, z_channels=5) for m in (JMV, TMV))
    tree = _numpy(W.magvit_to_jax(W.init_magvit(tvq, torch.Generator().manual_seed(1), "cpu")))
    return jvq, tree, tvq, W.magvit_from_jax(tree, tvq)


def _siglip():
    jvs, tvs = (m.SiglipConfig.tiny(image_size=28, patch_size=14, hidden_size=32)
                for m in (JSG, TSG))
    params = W.init_siglip(tvs, torch.Generator().manual_seed(2), "cpu")
    tree = _perturb(_numpy(W.siglip_to_jax(params, tvs)), np.random.default_rng(1))
    return jvs, tree, tvs, W.siglip_from_jax(tree, tvs)


def _with_lora(params, tcfg, seed):
    """(JAX-layout numpy tree, port tree): ``params`` with rank-4 fp32
    adapters on every projection, their b drawn nonzero so that they act."""
    g = torch.Generator().manual_seed(seed)
    llm = TL.add_lora(params["llm"], g, 4, dtype=torch.float32)
    for lp in llm["layers"]:
        for k in [k for k in lp if k.endswith("_lora_b")]:
            lp[k] = torch.randn(lp[k].shape, generator=g) * 0.05
    tree = dict(params, llm=llm)
    return _numpy(W.unigen_to_jax(tree, tcfg)), tree


def _jax_node(node):
    """A port W8A8 / W4A8 node in JAX's layout (numpy): the W8A8 kernel's
    real rows, transposed to [K, N]; a W4A8 node as it is."""
    if "kernel_int8" in node:
        n = node["scale"].shape[0]
        node = dict(node, kernel_int8=node["kernel_int8"][:n].t())
    return {k: v.numpy() for k, v in node.items()}


def _jax_quantized(tq, jtree):
    """The port's quantized UniGen tree ``tq`` in JAX's layout over the JAX
    float tree it was quantized from (its norms, embeddings and projectors):
    the tree JAX's ``quantize_unigen_params`` / ``quantize_unigen_params_int4``
    make, bit for bit (tests/test_torch_int8.py, tests/test_torch_int4.py),
    without JAX's eager quantization, whose op compiles cost seconds."""
    out = jax.tree.map(lambda a: a, dict(jtree))
    layers = out["llm"]["layers"]
    for name, path in W._PROJECTIONS.items():
        nodes = [_jax_node(lp[name]) for lp in tq["llm"]["layers"]]
        layers[path[0]][path[1]] = {k: np.stack([n[k] for n in nodes]) for k in nodes[0]}
    if "lm_head_q" in tq["llm"]:
        out["llm"]["lm_head_q"] = _jax_node(tq["llm"]["lm_head_q"])
    if "img_head_q" in tq:
        out["img_head_q"] = _jax_node(tq["img_head_q"])
    return jax.tree.map(jnp.asarray, out)


def _t2i_rows(rng, b, n, length=28):
    t = rng.integers(3, 100, size=(b, length))
    t[:, -n - 2] = 1
    t[:, -n - 1:-1] = 0
    t[:, -1] = 2
    return t


def _pt2_batch(b, n, seed=0, length=28):
    rng = np.random.default_rng(seed)
    t2i = _t2i_rows(rng, b, n, length)
    t2i[0, :3] = 0
    mmu = rng.integers(3, 100, size=(b, length))
    mmu[:, 2] = 1
    mmu[:, 3 + n] = 2
    mmu[:, 3:3 + n] = 0
    mmu_labels = np.where(rng.random((b, length)) < 0.5, rng.integers(3, 100, (b, length)), -100)
    mmu_labels[:, :4 + n] = -100
    lm = rng.integers(3, 100, size=(b, length))
    return {"t2i_template": t2i, "t2i_labels": np.full((b, length), -100),
            "t2i_pixels": rng.normal(size=(b, 8, 8, 3)).astype(np.float32),
            "lm_ids": lm, "lm_labels": lm.copy(), "mmu_template": mmu, "mmu_labels": mmu_labels,
            "mmu_pixels": rng.normal(size=(b, 8, 8, 3)).astype(np.float32)}


def _sft_batch(cfg, vs_cfg, b=4, part2=8):
    n, p = cfg.num_vq_tokens, vs_cfg.num_patches
    rng = np.random.default_rng(3)
    mmu_len = 3 + p + part2
    mmu_labels = np.full((b, mmu_len), -100)
    mmu_labels[:, -6:] = rng.integers(3, 100, size=(b, 6))
    t2i_labels = np.full((b, 28), -100)
    t2i_labels[:, -n - 2] = 1
    t2i_labels[:, -1] = 2
    return {"t2i_template": _t2i_rows(rng, b, n), "t2i_labels": t2i_labels,
            "t2i_pixels": rng.normal(size=(b, 8, 8, 3)).astype(np.float32),
            "lm_ids": rng.integers(3, 100, size=(b, 28)),
            "lm_labels": rng.integers(3, 100, size=(b, 28)),
            "mmu_part1": rng.integers(3, 100, size=(b, 3)),
            "mmu_part2": rng.integers(3, 100, size=(b, part2)),
            "mmu_labels": mmu_labels,
            "mmu_pixels": rng.normal(size=(b, 28, 28, 3)).astype(np.float32),
            "mmu_prompt_len": np.array([mmu_len, mmu_len - 2] * (b // 2))}


def _torch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _jax_batch(batch, mesh=None):
    out = {k: jnp.asarray(v) for k, v in batch.items()}
    if mesh is not None:
        out = {k: jax.device_put(v, NamedSharding(mesh, JP.partition_batch(v.ndim)))
               for k, v in out.items()}
    return out


# ---------------------------------------------------------------------------
# specs
# ---------------------------------------------------------------------------

def _siglip_jax_path(p):
    m = re.match(r"layers/\d+/(\w+)_([wb])$", p)
    if m:
        name, kind = m.groups()
        node = "mlp" if name.startswith("fc") else "attn"
        return f"layers/{node}/{name}/{'kernel' if kind == 'w' else 'bias'}", True
    m = re.match(r"layers/\d+/(ln\d)/(\w+)$", p)
    if m:
        return f"layers/{m.group(1)}/{m.group(2)}", True
    return ("pos_embed/weight" if p == "pos_embed" else p), False


def _jax_spec(jspecs, jpath):
    node = jspecs
    for k in jpath.split("/"):
        node = node[int(k)] if isinstance(node, list) else node[k]
    return tuple(node)


def _expected(jspec, pre, jshape, layer, transposed, mesh):
    """JAX's spec of a leaf in the port's layout: the stacked layer axis
    dropped, a kernel transposed. Where JAX's ``add_fsdp`` chose the layer
    axis (``pre``: its spec before ``sanitize_specs``), the port's leaf
    takes fsdp on its first free dimension instead (the port's rule), kept
    where the fsdp axis divides it."""
    dims = list(jspec) + [None] * (len(jshape) - len(jspec))
    if layer:
        dims, jshape = dims[1:], jshape[1:]
        if tuple(pre)[:1] == ("fsdp",):
            for i, d in enumerate(dims):
                if d is None and jshape[i] > 1:
                    dims[i] = "fsdp" if jshape[i] % mesh.size("fsdp") == 0 else None
                    break
    return tuple(dims[::-1] if transposed else dims)


def _spec_cases():
    jcfg, jtree, tcfg, ttree = _unigen()
    jcfg5, jtree5, tcfg5, ttree5 = _unigen(text_vocab_len=479)
    _, vs_tree, _, tvs = _siglip()
    _, vq_tree, _, tvq = _vq()

    def unigen_paths(p):
        return W.jax_leaf_path(p), "layers/" in p
    return {
        "unigen_v161": (jtree, ttree, JP.partition_unigen, PT.partition_unigen, unigen_paths),
        "unigen_v512": (jtree5, ttree5, JP.partition_unigen, PT.partition_unigen, unigen_paths),
        "siglip": (vs_tree, tvs, JP.partition_siglip, PT.partition_siglip, _siglip_jax_path),
        "magvit": (vq_tree, tvq, JP.partition_magvit, PT.partition_magvit,
                   lambda p: (p, False)),
    }


MESHES = {"4x1x2": (4, 1, 2, False), "2x2x2_fsdp": (2, 2, 2, True),
          "1x1x8": (1, 1, 8, False), "1x8x1_fsdp": (1, 8, 1, True)}


@pytest.fixture(scope="module")
def spec_cases():
    return _spec_cases()


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("tree", ["unigen_v161", "unigen_v512", "siglip", "magvit"])
def test_specs_match_jax(spec_cases, eight_devices, tree, mesh_name):
    """Every leaf's spec after ``sanitize_specs`` (and ``add_fsdp``) equals
    JAX's on the same mesh, in the port's layout."""
    jtree, ttree, jpart, tpart, to_jax = spec_cases[tree]
    d, f, m, fsdp = MESHES[mesh_name]
    jmesh = j_make_mesh(data=d, fsdp=f, model=m)
    mesh = SpecMesh(d, f, m)
    jspecs = jpart(jtree)
    tspecs = tpart(ttree)
    if fsdp:
        jspecs, tspecs = JP.add_fsdp(jspecs, jtree), PT.add_fsdp(tspecs, ttree)
    pre = jax.tree.map(lambda s: s, jspecs, is_leaf=lambda x: isinstance(x, JP.P))
    jspecs = JP.sanitize_specs(jspecs, jtree, jmesh)
    tspecs = PT.sanitize_specs(tspecs, ttree, mesh)
    jshapes = {jax.tree_util.keystr(p, simple=True, separator="/"): a.shape
               for p, a in jax.tree_util.tree_leaves_with_path(jtree)}
    jspec_tree = jax.tree.map(lambda s: s, jspecs, is_leaf=lambda x: isinstance(x, JP.P))
    assert len(tspecs) == len(dict(PT.named_leaves(ttree)))
    sharded = 0
    for path, leaf in PT.named_leaves(ttree):
        jpath, layer = to_jax(path)
        transposed = jpath.endswith("kernel") and leaf.dim() == 2
        want = _expected(_jax_spec(jspec_tree, jpath), _jax_spec(pre, jpath), jshapes[jpath],
                         layer, transposed, mesh)
        assert tspecs[path] == want, (path, tspecs[path], want)
        sharded += any(a is not None for a in want)
    assert sharded or tree == "magvit"
    embed = tspecs.get("llm/embed")
    if embed is not None and m > 1:
        assert (embed[0] == "model") == (tree == "unigen_v512")   # 161 replicates, 512 shards


def test_align_heads_keeps_heads_whole():
    """At the flagship's 12 query / 2 KV heads, model 4 replicates k/v (the
    port's rule; JAX's GSPMD splits them mid-head) and model 5 raises."""
    tcfg = TU.UniGenConfig.tiny(llm=TU.qwen2.Qwen2Config.tiny(
        vocab_size=161, num_attention_heads=12, num_key_value_heads=2, hidden_size=96,
        head_dim=8))
    params = W.init_unigen(tcfg, torch.Generator().manual_seed(0), "cpu")
    specs = P.unigen_specs(params, tcfg, SpecMesh(1, 1, 4))
    assert specs["llm/layers/0/q_w"] == ("model", None)
    assert specs["llm/layers/0/k_w"] == specs["llm/layers/1/v_b"][:1] + (None,) == (None, None)
    assert P.unigen_specs(params, tcfg, SpecMesh(1, 1, 2))["llm/layers/0/k_w"] == ("model", None)
    with pytest.raises(ValueError, match="query heads"):
        P.unigen_specs(params, tcfg, SpecMesh(1, 1, 5))
    assert TU.qwen2.kv_heads_of_rank(12, 2, 3, 1) == slice(0, 1)
    assert TU.qwen2.kv_heads_of_rank(12, 2, 3, 2) == slice(1, 2)
    assert TU.qwen2.kv_heads_of_rank(4, 2, 1, 3) == slice(1, 2)
    assert TU.qwen2.kv_heads_of_rank(6, 2, 2, 1) == slice(0, 2)   # one KV head a query head
    assert TU.qwen2.kv_heads_of_rank(6, 3, 3, 0) == [0, 0, 1]     # two groups, unevenly


def test_make_mesh_raises_on_a_world_it_cannot_factor():
    with pytest.raises(ValueError, match="mesh 2x1x1 != 1 devices"):
        P.make_mesh(data=2, device_type="cpu")
    with pytest.raises(ValueError, match="not divisible"):
        P.make_mesh(data=-1, model=2, device_type="cpu")
    mesh = P.make_mesh(device_type="cpu")
    assert mesh.shape == {"data": 1, "fsdp": 1, "model": 1} and mesh.group("model") is None
    P.mesh.set_mesh(None)


@pytest.mark.parametrize("saved", ["sharded_f2_m2", "unsharded"])
def test_checkpoint_pieces_read_by_overlap(tmp_path, saved):
    """A restore builds each rank's piece from the parts of the saved pieces
    that overlap it: for every target (fsdp, model) layout and rank, the
    pieces equal the whole leaf's slices and own no more memory than
    themselves."""
    from unigen_tpu_torch.utils.persistence import save_pretrained
    g = torch.Generator().manual_seed(0)
    whole = {"a": torch.randn(8, 12, generator=g), "b": torch.randn(12, generator=g),
             "c": torch.randn(4, 8, generator=g).bfloat16(), "step": torch.tensor(3)}
    specs = {"a": ("model", "fsdp"), "b": ("fsdp",), "c": (None, "model"), "step": ()}
    d = str(tmp_path)
    if saved == "unsharded":
        save_pretrained(whole, d)
    else:
        src = {"fsdp": 2, "model": 2}
        for f in range(2):
            for m in range(2):
                coord = {"fsdp": f, "model": m}
                save_pretrained({p: _piece(t, specs[p], src, coord) for p, t in whole.items()},
                                os.path.join(d, f"shard-f{f}-m{m}"))
        with open(os.path.join(d, CK.SHARDING_NAME), "w") as fh:
            json.dump({"mesh": dict(src, data=1), "specs": specs}, fh)
    for sizes in ({"fsdp": 1, "model": 1}, {"fsdp": 2, "model": 1}, {"fsdp": 1, "model": 4},
                  {"fsdp": 4, "model": 2}, {"fsdp": 2, "model": 2}):
        for f in range(sizes["fsdp"]):
            for m in range(sizes["model"]):
                coord = {"fsdp": f, "model": m}
                got = CK._read_pieces(d, specs, sizes, coord)
                for p, t in whole.items():
                    want = _piece(t, specs[p], sizes, coord)
                    assert torch.equal(got[p], want), (sizes, coord, p)
                    assert got[p].untyped_storage().nbytes() == want.numel() * want.element_size()


def _piece(t, spec, sizes, coord):
    for dim, axis in enumerate(spec):
        if axis is not None:
            k = t.shape[dim] // sizes[axis]
            t = t.narrow(dim, coord[axis] * k, k)
    return t.contiguous()


# ---------------------------------------------------------------------------
# the 8-rank spawn
# ---------------------------------------------------------------------------

def _inputs():
    jcfg, jtree, tcfg, tparams = _unigen()
    jvq, vq_tree, tvq, tvq_params = _vq()
    n = jcfg.num_vq_tokens
    out, refs = {}, {}

    # PT2 at data 4 x model 2
    pt2 = _pt2_batch(4, n)
    key = jax.random.key(0)
    kw = dict(batch_size_t2i=4, batch_size_lm=4, batch_size_mmu=4, max_grad_norm=1.0)
    out["pt2"] = dict(cfg=tcfg, vq_cfg=tvq, tcfg=TT.TrainStepConfig(**kw), params=tparams,
                      vq=tvq_params, batch=_torch(pt2), draws=_jax_draws(key, 4, n),
                      schedule=COSINE)
    refs["pt2"] = (jcfg, jtree, jvq, vq_tree, pt2, key, kw)

    # SFT: separate and packed modes
    _, vs_tree, tvs_cfg, tvs = _siglip()
    jvs = JSG.SiglipConfig.tiny(image_size=28, patch_size=14, hidden_size=32)
    skw = dict(w_und_encoder=True, mm_input_dim=32)
    sjcfg, sjtree, stcfg, stparams = _unigen(**skw)
    sep, packed = _sft_batch(sjcfg, jvs), _sft_batch(sjcfg, jvs, part2=50)
    cases = {"separate": (sep, dict(batch_size_t2i=4, batch_size_lm=4, batch_size_mmu=4)),
             "packed": (packed, dict(batch_size_t2i=4, batch_size_lm=4, batch_size_mmu=4,
                                     common_length=3 + jvs.num_patches + 50))}
    skey = jax.random.key(5)
    opt_kw = dict(lr_mapper={"mm_projector": 2.0}, tunable_parts=["mm_projector", "llm"],
                  max_grad_norm=1.0, weight_decay=0.01)
    out["sft"] = dict(cfg=stcfg, vq_cfg=tvq, vs_cfg=tvs_cfg, params=stparams, vq=tvq_params,
                      vs=tvs, draws=_jax_draws(skey, 4, n), opt_kw=opt_kw,
                      cases={name: (_torch(b), kw_) for name, (b, kw_) in cases.items()},
                      schedule=("constant", {}))
    refs["sft"] = (sjcfg, sjtree, jvq, vq_tree, jvs, vs_tree, cases, skey, opt_kw)

    # DPO
    rng = np.random.default_rng(0)
    template = _t2i_rows(rng, 4, n)
    template[1, :3] = 0
    dpo = {"template": template, "labels": np.full((4, 28), -100),
           "chosen_pixels": rng.normal(size=(4, 8, 8, 3)).astype(np.float32),
           "rejected_pixels": rng.normal(size=(4, 8, 8, 3)).astype(np.float32)}
    dkey = jax.random.key(7)
    k_c, k_r = jax.random.split(dkey)
    out["dpo"] = dict(cfg=tcfg, vq_cfg=tvq, params=tparams, vq=tvq_params, batch=_torch(dpo),
                      draws=(_jax_draws(k_c, 4, n), _jax_draws(k_r, 4, n)),
                      schedule=("constant", {}))
    refs["dpo"] = (jcfg, jtree, jvq, vq_tree, dpo, dkey)

    # vocab 512
    _, _, vcfg, vparams = _unigen(text_vocab_len=479)
    g = np.random.default_rng(4)
    ids = torch.as_tensor(g.integers(0, 512, size=(4, 12)))
    ids[0, 0] = 511                                       # the last row of rank 1's shard
    out["vocab"] = dict(qcfg=vcfg.llm, qparams=vparams["llm"], ids=ids,
                        labels=torch.as_tensor(g.integers(0, 512, size=(4, 12))))

    # checkpoint across meshes: the Trainer of the tiny PT2 config, its batch
    # divisible by both meshes' batch groups (4 and 8)
    out["ckpt"] = dict(config=SMOKE, overrides=CKPT_OVERRIDES + [
        "experiment.save_every=1000", "experiment.resume_from_checkpoint=latest"])

    # t2i at model 2
    rng = np.random.default_rng(5)
    t2i_ids = _t2i_rows(rng, 2, n, 24)
    t2i_ids[:, -n - 1:-1] = tcfg.mask_token_id
    uncond = t2i_ids.copy()
    uncond[:, :-n - 2] = 0
    out["t2i"] = dict(cfg=tcfg, params=tparams, t2i_ids=torch.as_tensor(t2i_ids),
                      t2i_uncond=torch.as_tensor(uncond))
    out["errors"] = dict(cfg=tcfg, params=tparams)

    # the serving engine at model 2: tests/test_serving.py's requests
    rng = np.random.default_rng(21)
    prompts = [rng.integers(3, tcfg.text_vocab_len - 1, size=(n,)).tolist() for n in (5, 11, 8)]
    emb_ids = torch.tensor([prompts[1] + [0] * 5])
    pad = torch.arange(16)[None] >= 11
    z = torch.zeros_like(pad)
    out["serving"] = dict(cfg=tcfg, params=tparams, prompts=prompts, emb_ids=prompts[1],
                          emb=TU.embed_tokens(tparams, emb_ids), plen=11,
                          bits=TM.pack_meta(TM.AttnMeta(pad=pad, bidir_q=z, bidir_k=z)))
    refs["serving"] = (jcfg, jtree, prompts, emb_ids.numpy(), 11)

    # the W8A8 tree of the tiny model (both heads), its W4A8 trees (group 32,
    # the engine's decode tree) and W4_LLM's (group 64), by the port's
    # quantizers; JAX's references run on the same trees (``_jax_quantized``)
    t8 = TQZ.quantize_unigen_params(tparams, tcfg, lm_head=True)
    t4 = TI4.quantize_unigen_params_int4(tparams, tcfg, group=32)
    jcfg4, jtree4, tcfg4, tparams4 = _unigen(llm=W4_LLM)
    t44 = TI4.quantize_unigen_params_int4(tparams4, tcfg4, group=W4_GROUP)
    rng = np.random.default_rng(22)

    def x(k):
        return torch.as_tensor(rng.normal(size=(3, 5, k)).astype(np.float32))
    ids, uncond = _t2i_prompts(jcfg)
    u_s = rng.random((STEPS, 2, n, jcfg.codebook_size), dtype=np.float32)
    u_m = rng.random((STEPS, 2, n), dtype=np.float32)
    t2i_kw = dict(guidance_scale=2.0, timesteps=STEPS, temperature=1.0, reuse_prefix_cache=True)
    rb, lp, total = 3, 9, 12
    bb_ids = np.random.default_rng(5).integers(3, 100, size=(rb, lp))
    valid = np.arange(total)[None].repeat(rb, 0) <= lp
    tok = np.array([[7], [8], [9]])
    lora_jtree, lora_params = _with_lora(tparams, tcfg, 30)
    out["quant"] = dict(
        cfg=tcfg, w8=t8, cfg4=tcfg4, w4=t44,
        rows8={"o": x(64), "down": x(128)}, rows4={"o": x(128), "down": x(192)},
        t2i=dict(ids=torch.from_numpy(ids), uncond=torch.from_numpy(uncond),
                 noise=(torch.from_numpy(u_s), torch.from_numpy(u_m)), pad=PAD, soi=SOI,
                 eoi=EOI, kw=t2i_kw),
        backbone=dict(ids=torch.from_numpy(bb_ids), tok=torch.from_numpy(tok),
                      pos=torch.full((rb, 1), lp), valid=torch.from_numpy(valid), total=total),
        lora=lora_params, lora_cfg=tcfg, lora_ids=torch.as_tensor(rng.integers(0, 161, (4, 12))),
        lora_labels=torch.as_tensor(rng.integers(0, 161, (4, 12))))
    refs["quant"] = (jcfg, _jax_quantized(t8, jtree), ids, uncond, u_s, u_m, t2i_kw, jcfg4,
                     _jax_quantized(t44, jtree4), bb_ids, tok, valid, total)
    out["serving_quant"] = dict(cfg=tcfg, w8=t8, w4=t4, prompts=prompts)
    refs["serving_quant"] = (jcfg, refs["quant"][1], _jax_quantized(t4, jtree), prompts)

    # LoRA: the SFT cases and the DPO step with adapters, the adapters alone trained
    sl_jtree, sl_params = _with_lora(stparams, stcfg, 31)
    lora_opt = dict(tunable_parts=list(LORA), max_grad_norm=1.0, weight_decay=0.01)
    out["sft_lora"] = dict(out["sft"], params=sl_params, opt_kw=lora_opt)
    refs["sft_lora"] = (sjcfg, sl_jtree, jvq, vq_tree, jvs, vs_tree, cases, skey, lora_opt)
    # Adam's epsilon 1e-6: at DPO's first step some adapter gradients lie within
    # a few 1e-8 of zero, where AdamW's first update g / (|g| + eps) turns fp32
    # rounding into lr-sized moves (at 1e-8 the port's one-rank step is 1.07e-4
    # of a lora_b leaf from JAX's, the sharded one 1.3e-4)
    dpo_lora_opt = dict(tunable_parts=list(LORA), epsilon=1e-6)
    out["dpo_lora"] = dict(out["dpo"], params=lora_params, opt_kw=dpo_lora_opt)
    refs["dpo_lora"] = (jcfg, lora_jtree, jvq, vq_tree, dpo, dkey, dpo_lora_opt)

    # trees derived from shards: PT2's tree, batch and draws, and a forward's ids
    d_ids = np.random.default_rng(23).integers(3, jcfg.vocab_size, size=(4, 12))
    out["derived"] = dict(out["pt2"], ids=torch.as_tensor(d_ids))
    refs["derived"] = (jcfg, jtree, d_ids)
    out["without_specs"] = dict(cfg=tcfg, params=tparams, ids=torch.as_tensor(d_ids),
                                vs=tvs, vs_cfg=tvs_cfg)
    return out, refs


def _jax_pt2(refs):
    jcfg, jtree, jvq, vq_tree, pt2, key, kw = refs["pt2"]
    jparams = jax.tree.map(jnp.asarray, jtree)
    tx = JO.make_optimizer(jparams, 1e-3, JLRS.get_scheduler(COSINE[0], **COSINE[1]),
                           max_grad_norm=1.0)
    mesh = j_make_mesh(data=4, fsdp=1, model=2)
    sharded = JP.shard_params(jparams, JP.partition_unigen(jparams), mesh)
    vq = JP.shard_params(jax.tree.map(jnp.asarray, vq_tree), JP.partition_magvit(vq_tree), mesh)
    step = JT.make_train_step(jcfg, jvq, tx, JT.TrainStepConfig(**kw))
    with jax.set_mesh(mesh):
        state, m = jax.jit(step)(JT.init_train_state(sharded, tx), vq, _jax_batch(pt2, mesh), key)
    return jax.tree.map(np.asarray, state.params), {k: float(v) for k, v in m.items()}


def _jax_sft(refs, name="sft"):
    sjcfg, sjtree, jvq, vq_tree, jvs, vs_tree, cases, skey, opt_kw = refs[name]
    sjparams = jax.tree.map(jnp.asarray, sjtree)
    b, kw = cases["separate"]          # the packed mode is held to the port's unsharded step
    stx = JO.make_optimizer(sjparams, 1e-3, JLRS.get_scheduler("constant"), **opt_kw)
    sstep = jax.jit(JSFT.make_sft_train_step(sjcfg, jvq, jvs, stx, JSFT.SFTStepConfig(
        max_grad_norm=1.0, **kw)))
    st, sm = sstep(JT.init_train_state(sjparams, stx), jax.tree.map(jnp.asarray, vq_tree),
                   jax.tree.map(jnp.asarray, vs_tree), _jax_batch(b), skey)
    return {"separate": (jax.tree.map(np.asarray, st.params),
                         {k: float(v) for k, v in sm.items()})}


def _jax_dpo(refs, name="dpo"):
    jcfg, jtree, jvq, vq_tree, dpo, dkey, *opt_kw = refs[name]
    jparams = jax.tree.map(jnp.asarray, jtree)
    dtx = JO.make_optimizer(jparams, 5e-4, JLRS.get_scheduler("constant"), max_grad_norm=1.0,
                            **(opt_kw[0] if opt_kw else {}))
    dstep = jax.jit(JDPO.make_dpo_step(jcfg, jvq, dtx, JDPO.DPOConfig(beta=0.1)))
    ds, dm = dstep(JT.init_train_state(jparams, dtx), jparams, jax.tree.map(jnp.asarray, vq_tree),
                   _jax_batch(dpo), dkey)
    return jax.tree.map(np.asarray, ds.params), {k: float(v) for k, v in dm.items()}


def _jax_serving(refs):
    """JAX's ServingEngine on the rank program's first engine trace (the
    same requests, slots, buckets, chunks and speculation): the embeddings
    request under the dense causal mask its pad bits describe."""
    jcfg, jtree, prompts, emb_ids, plen = refs["serving"]
    jparams = jax.tree.map(jnp.asarray, jtree)
    pos = np.arange(emb_ids.shape[1])
    keep = pos < plen
    mask = ((pos[:, None] >= pos[None, :]) & keep[None, :] & keep[:, None])[None, None]
    emb = np.asarray(JU.embed_tokens(jparams, jnp.asarray(emb_ids, jnp.int32)))
    with JServingEngine(jparams, jcfg, slots=2, max_len=48, buckets=(16,), chunk=(2, 4),
                        speculate_k=2) as eng:
        futs = [eng.submit(x, max_new_tokens=8) for x in prompts]
        futs.append(eng.submit(prompts[0], max_new_tokens=6, temperature=0.9, seed=5))
        futs.append(eng.submit_embeds(emb, mask, plen, max_new_tokens=7,
                                      lookup_ids=emb_ids[0, :plen]))
        return [f.result(timeout=300) for f in futs]


def _jax_quant(refs):
    """JAX's int8 t2i codes (CFG on the hidden states) on its W8A8 tree, and its
    W4A8 backbone's prefill and decode step (test_torch_int4's)."""
    (jcfg, j8, ids, uncond, u_s, u_m, kw, jcfg4, j44, bb_ids, tok, valid,
     total) = refs["quant"]
    out = {}
    both = np.concatenate([ids, uncond])
    mask = JM.create_attention_mask_predict_next(jnp.asarray(both), PAD, SOI, EOI,
                                                 rm_pad_in_image=True)
    out["t2i_hidden"] = np.asarray(j_t2i(
        j8, jcfg, jax.random.key(0), jnp.asarray(ids), mask, uncond_input_ids=jnp.asarray(uncond),
        noise=(jnp.asarray(u_s), jnp.asarray(u_m)), pad_id=PAD, cfg_combine="hidden", **kw))
    rb, lp = bb_ids.shape
    pos = np.arange(lp)
    pm = np.broadcast_to((pos[:, None] >= pos[None, :])[None, None], (rb, 1, lp, lp))
    pm = np.concatenate([pm, np.zeros((rb, 1, lp, total - lp), bool)], axis=-1)
    h, cache = JQ.forward(j44["llm"], jcfg4.llm, input_ids=jnp.asarray(bb_ids),
                          mask=jnp.asarray(pm), cache=JQ.init_kv_cache(jcfg4.llm, rb, total))
    h2, _ = JQ.forward(j44["llm"], jcfg4.llm, input_ids=jnp.asarray(tok),
                       mask=jnp.asarray(valid[:, None, None, :]),
                       positions=jnp.full((rb, 1), lp), cache=cache)
    out["backbone"] = (np.asarray(h), np.asarray(h2))
    return out


def _jax_serving_quant(refs):
    """JAX's engine in int8+kv and int8+int4 on the greedy requests of the
    rank program's trace."""
    jcfg, j8, j4, prompts = refs["serving_quant"]
    out = {}
    for mode, extra in (("int8+kv", dict(quantized_cache=True)),
                        ("int8+int4", dict(decode_params=j4))):
        with JServingEngine(j8, jcfg, slots=2, max_len=48, buckets=(16,), chunk=(2, 4),
                            **extra) as eng:
            out[mode] = [f.result(timeout=300) for f in
                         [eng.submit(x, max_new_tokens=8) for x in prompts]]
    return out


def _jax_derived(refs):
    """JAX's logits of the derived trees' ids, unsharded, causal."""
    jcfg, jtree, ids = refs["derived"]
    return np.asarray(JU.forward(jax.tree.map(jnp.asarray, jtree), jcfg,
                                 input_ids=jnp.asarray(ids, jnp.int32)))


JAX_REFERENCES = (("pt2", _jax_pt2), ("sft", _jax_sft), ("dpo", _jax_dpo),
                  ("derived", _jax_derived),
                  ("serving", _jax_serving), ("quant", _jax_quant),
                  ("serving_quant", _jax_serving_quant),
                  ("sft_lora", lambda r: _jax_sft(r, "sft_lora")),
                  ("dpo_lora", lambda r: _jax_dpo(r, "dpo_lora")))


def _jax_references(refs):
    """JAX's steps, its serving engines and the quantized references, a
    thread each."""
    with ThreadPoolExecutor(len(JAX_REFERENCES)) as pool:
        futures = {name: pool.submit(fn, refs) for name, fn in JAX_REFERENCES}
        return {name: f.result() for name, f in futures.items()}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, eight_devices):
    """The 8 ranks' results and the JAX references, computed together."""
    tmp = str(tmp_path_factory.mktemp("parallel"))
    inputs, refs = _inputs()
    torch.save(inputs, os.path.join(tmp, "inputs.pt"))
    errors = []

    def run():
        try:
            R.spawn("parallel_all", 8, os.path.join(tmp, "inputs.pt"), tmp)
        except Exception as e:   # the ranks' tracebacks are in error-<rank>.txt
            errors.append(e)
    thread = threading.Thread(target=run)
    thread.start()
    try:
        jax_refs = _jax_references(refs)
    finally:
        thread.join()
    if errors:
        logs = [open(os.path.join(tmp, f)).read() for f in sorted(os.listdir(tmp))
                if f.startswith("error-")]
        raise RuntimeError(f"{errors[0]}\n{logs[0] if logs else ''}")
    out = {name: torch.load(os.path.join(tmp, f"{name}.pt"), weights_only=False)
           for name in R.PROGRAMS}
    return out, jax_refs, inputs


def _close_metrics(got, want, keys, rtol, atol):
    for k in keys:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol, err_msg=k)


def _max_leaf_err(a, b):
    return max((x - y).abs().max().item() / max(x.abs().max().item(), 1e-12)
               for (_, x), (_, y) in zip(TO.named_leaves(a), TO.named_leaves(b)))


@pytest.mark.parametrize("case", ["jax_sharded", "port_unsharded", "model4_kv_whole"])
def test_pt2_step_data4_model2(ranks, case):
    """The sharded PT2 step: against JAX's step on the same 8-device mesh
    (its dense masks: losses and grad norm rtol 1e-4, the updated
    parameters within 1e-4 of each leaf's largest magnitude), and against
    the port's unsharded step (1e-5, parameters 1e-5)."""
    out, jax_refs, inputs = ranks
    r = out["pt2"]
    cfg = inputs["pt2"]["cfg"]
    assert r["q_local"] == (32, 64)                           # 2 of 4 heads a rank
    if case == "jax_sharded":
        jparams, jm = jax_refs["pt2"]
        _close_metrics(r["metrics"], jm, PT2_METRICS, 1e-4, 1e-5)
        errs = _leaf_errors(jparams, W.unigen_to_jax(r["params"], cfg))
        assert max(errs.values()) < 1e-4, {k: v for k, v in errs.items() if v >= 1e-4}
    else:
        metrics, params = ((r["metrics"], r["params"]) if case == "port_unsharded"
                           else (r["metrics4"], r["params4"]))
        if case == "model4_kv_whole":
            assert r["specs4"]["llm/layers/0/k_w"] == (None, None)
        _close_metrics(metrics, r["whole_metrics"], PT2_METRICS, 1e-5, 1e-6)
        assert _max_leaf_err(r["whole_params"], params) < 1e-5


@pytest.mark.parametrize("mode,ref", [("separate", "jax"), ("separate", "port_unsharded"),
                                      ("packed", "port_unsharded")])
def test_sft_step_data4_model2(ranks, mode, ref):
    """The sharded SFT step (SigLIP tower sharded too; a packed rank packs
    its own rows) against JAX's unsharded step (its dense masks: rtol 1e-4,
    parameters 1e-4) and the port's unsharded step (1e-5)."""
    out, jax_refs, inputs = ranks
    r = out["sft"][mode]
    assert r["mode"] == mode
    if ref == "jax":
        jparams, jm = jax_refs["sft"][mode]
        _close_metrics(r["metrics"], jm, SFT_METRICS, 1e-4, 1e-5)
        errs = _leaf_errors(jparams, W.unigen_to_jax(r["params"], inputs["sft"]["cfg"]))
        assert max(errs.values()) < 1e-4, {k: v for k, v in errs.items() if v >= 1e-4}
    else:
        _close_metrics(r["metrics"], r["whole_metrics"], SFT_METRICS, 1e-5, 1e-6)
        assert _max_leaf_err(r["whole_params"], r["params"]) < 1e-5


@pytest.mark.parametrize("ref", ["jax", "port_unsharded"])
def test_dpo_step_data4_model2(ranks, ref):
    """The sharded DPO step (reference tree sharded as the policy) against
    JAX's unsharded step (rtol 1e-4, parameters 1e-4) and the port's
    (metrics 1e-5; parameters 1e-4, tests/test_torch_dpo.py's: at DPO's
    first step the gradients are near zero and Adam's update turns their
    rounding into lr-sized differences)."""
    out, jax_refs, inputs = ranks
    r = out["dpo"]
    if ref == "jax":
        jparams, jm = jax_refs["dpo"]
        _close_metrics(r["metrics"], jm, DPO_METRICS, 1e-4, 1e-6)
        errs = _leaf_errors(jparams, W.unigen_to_jax(r["params"], inputs["dpo"]["cfg"]))
        assert max(errs.values()) < 1e-4, {k: v for k, v in errs.items() if v >= 1e-4}
    else:
        _close_metrics(r["metrics"], r["whole_metrics"], DPO_METRICS, 1e-5, 1e-6)
        assert _max_leaf_err(r["whole_params"], r["params"]) < 1e-4


@pytest.mark.parametrize("what", ["embed", "logits", "grads"])
def test_vocab_parallel_embedding_and_head(ranks, what):
    """Vocab 512 at model 2: the masked lookup plus reduce equals the whole
    table's rows exactly; the gathered logits and every gradient (the
    vocab-sharded table's gathered) within 1e-5."""
    r = ranks[0]["vocab"]
    assert r["specs"]["embed"] == ("model", None)
    whole, sharded = r["whole"], r["sharded"]
    if what == "embed":
        assert torch.equal(whole["embed"], sharded["embed"])
    elif what == "logits":
        torch.testing.assert_close(sharded["logits"], whole["logits"], rtol=1e-5, atol=1e-5)
        assert abs(whole["loss"] - sharded["loss"]) < 1e-5
    else:
        for p, g in whole["grads"].items():
            torch.testing.assert_close(sharded["grads"][p], g, rtol=1e-5, atol=1e-6, msg=p)


@pytest.mark.parametrize("target", ["mesh_4x2x1", "one_process", "unwrapped_model"])
def test_checkpoint_across_meshes(ranks, tmp_path, target):
    """The Trainer on (2, 2, 2) with add_fsdp saves a step: a Trainer on
    (4, 2, 1) resumes it bit for bit and takes one more step; this process
    restores it onto one process bit for bit; the portable export read back
    by ``build_pipeline`` equals the gathered parameters."""
    r = ranks[0]["ckpt"]
    if target == "mesh_4x2x1":
        assert r["files"] == ["shard-f0-m0", "shard-f0-m1", "shard-f1-m0", "shard-f1-m1",
                              "sharding.json"]
        assert sorted(r["want"]) == sorted(r["got"])
        for p, t in r["want"].items():
            assert torch.equal(r["got"][p], t), p
        assert r["gate_local_b"] == (128, 32)                 # fsdp 2 on the restored mesh
        assert r["resumed_at"] == 1 and r["step2"] == 2
        assert r["ranks_saved"][:2] == ["checkpoint-1", "checkpoint-2"]
        return
    config = initialize_config(SMOKE, CKPT_OVERRIDES + [f"experiment.output_dir={tmp_path}"])
    if target == "one_process":
        restored = CK.restore_checkpoint(r["path"], build_trainer(config).state)
        got = dict(CK._leaves(CK._to_tree(restored)))
        assert sorted(got) == sorted(r["want"])
        for p, t in r["want"].items():
            assert torch.equal(got[p].detach(), t), p
        return
    handoff = initialize_config(SMOKE, CKPT_OVERRIDES + [
        f"experiment.output_dir={tmp_path}", f"model.unigen.pretrained_model_path={r['path']}"])
    pipe = build_pipeline(handoff, device="cpu")
    for (p, a), (_, b) in zip(TO.named_leaves(r["whole_params"]), TO.named_leaves(pipe.params)):
        assert torch.equal(a, b), p


def test_t2i_model2_tokens_equal_one_rank(ranks):
    r = ranks[0]["t2i"]
    for toks in r["ranks"]:
        assert toks == r["whole"].tolist()


@pytest.mark.parametrize("what", ["mesh"])
def test_errors(ranks, what):
    """``make_mesh`` on 8 ranks with fsdp 3."""
    msg = ranks[0]["errors"][what]
    assert "not divisible by fsdp*model=3" in msg


@pytest.mark.parametrize("what", ["jax", "one_rank", "ranks_identical", "follower_submit",
                                  "cancel", "followed_pruned"])
def test_engine_model2_matches_one_rank(ranks, what):
    """The serving engine on TP-sharded params at data 4 x model 2 (JAX's
    test_engine_tensor_parallel_matches_unsharded, tests/test_serving.py:410,
    holds JAX's at >= 0.95 agreement with its unsharded engine): three greedy
    prompts of 8 tokens, a sampled one and an embeddings prompt, speculation
    on. The greedy and embeddings requests' tokens equal JAX's engine's on
    the same trace (agreement 1.0 against JAX's bar of 0.95); the sampled
    one, whose random stream differs from JAX's, is held to the port's
    one-rank engine, which the whole trace equals exactly in fp32. The
    followers run rank 0's plan: the same tokens, decode chunks and busy
    steps on every rank, the same outcome of a request cancelled mid-stream,
    ``submit`` on a follower raises, and a follower that does not keep
    finished requests holds none once they ended."""
    r = ranks[0]["serving"]
    ranks_out = r["ranks"]
    if what == "jax":
        want, got = ranks[1]["serving"], ranks_out[0]["toks"]
        pairs = [(want[i], got[i]) for i in (0, 1, 2, 4)]      # not the sampled request
        agree = np.mean([np.mean(np.array(a) == np.array(b)) for a, b in pairs])
        assert agree >= 0.95, f"TP engine agreement with JAX {agree:.2f}"
        assert [g for _, g in pairs] == [w for w, _ in pairs]
    elif what == "one_rank":
        got = ranks_out[0]["toks"]
        agree = np.mean([np.mean(np.array(a) == np.array(b)) for a, b in zip(r["whole"], got)])
        assert agree >= 0.95, f"TP engine agreement {agree:.2f}"
        assert got == r["whole"]
    elif what == "ranks_identical":
        for o in ranks_out[1:]:
            for key in ("toks", "decode_chunks", "busy_steps", "cancel"):
                assert o[key] == ranks_out[0][key], key
        assert ranks_out[0]["decode_chunks"] == r["whole_chunks"]
    elif what == "follower_submit":
        assert ranks_out[0]["error"] == ""
        for o in ranks_out[1:]:
            assert "follows rank 0's plan" in o["error"]
    elif what == "cancel":
        assert all(o["cancel"] == "cancelled" for o in ranks_out)
    else:
        assert ranks_out[0]["followed_after"] == ([], 2)
        for o in ranks_out[1:]:
            assert o["followed_after"] == ([], 2)       # both followed, neither kept


# ---------------------------------------------------------------------------
# quantized and LoRA trees under tensor parallelism
# ---------------------------------------------------------------------------

# the port's layout of the quantized and LoRA leaves, which JAX's rules leave
# whole (partition.py's module docstring; ROADMAP "Deliberate differences")
PINNED = ((r"/(q|k|v|gate|up)/kernel_int8$", ("model", None)),
          (r"/(q|k|v|gate|up)/(scale|bias)$", ("model",)),
          (r"/(o|down)/kernel_int8$", (None, "model")),
          (r"/(q|k|v|gate|up)/(kernel_int4|scale4)$", (None, "model")),
          (r"/(o|down)/(kernel_int4|scale4)$", ("model", None)),
          (r"/(q|k|v|gate|up)_lora_b$", (None, "model")),
          (r"/(o|down)_lora_a$", ("model", None)),
          (r"^img_head_q/kernel_int8$", ("model", None)),
          (r"^img_head_q/scale$", ("model",)))


def _quant_jax_path(path):
    m = re.match(r"llm/layers/\d+/(\w+)/(kernel_int8|kernel_int4|scale4|scale|bias)$", path)
    if m:
        return "llm/layers/" + "/".join(W._PROJECTIONS[m.group(1)]) + "/" + m.group(2), True
    if path.startswith(("llm/lm_head_q/", "img_head_q/")):
        return path, False
    return W.jax_leaf_path(path), "layers/" in path


@pytest.fixture(scope="module")
def quant_spec_cases():
    _, jtree, tcfg, tparams = _unigen()
    _, jtree4, tcfg4, tparams4 = _unigen(llm=W4_LLM)
    t8 = TQZ.quantize_unigen_params(tparams, tcfg, lm_head=True)
    t4 = TI4.quantize_unigen_params_int4(tparams4, tcfg4, group=W4_GROUP)
    jl, tl = _with_lora(tparams, tcfg, 30)
    return {"w8a8": (jax.tree.map(np.asarray, _jax_quantized(t8, jtree)), t8),
            "w4a8": (jax.tree.map(np.asarray, _jax_quantized(t4, jtree4)), t4),
            "lora": (jl, tl)}


@pytest.mark.parametrize("mesh_name", ["4x1x2", "1x1x8"])
@pytest.mark.parametrize("tree", ["w8a8", "w4a8", "lora"])
def test_quantized_and_lora_specs(quant_spec_cases, eight_devices, tree, mesh_name):
    """JAX's W8A8, W4A8 and LoRA trees: every leaf that JAX's rules shard
    (the column projections' biases) has JAX's spec; the quantized and LoRA
    leaves JAX keeps whole have the port's pinned layout (a rank's cut of a
    W4A8 group included at model 8); the 161-row quantized text head, whose
    real N does not divide, stays whole; every other leaf is JAX's."""
    jtree, ttree = quant_spec_cases[tree]
    d, f, m, _ = MESHES[mesh_name]
    jmesh, mesh = j_make_mesh(data=d, fsdp=f, model=m), SpecMesh(d, f, m)
    jspecs = JP.sanitize_specs(JP.partition_unigen(jtree), jtree, jmesh)
    tspecs = PT.sanitize_specs(PT.partition_unigen(ttree), ttree, mesh)
    jspec_tree = jax.tree.map(lambda s: s, jspecs, is_leaf=lambda x: isinstance(x, JP.P))
    jshapes = {jax.tree_util.keystr(p, simple=True, separator="/"): a.shape
               for p, a in jax.tree_util.tree_leaves_with_path(jtree)}
    pinned = 0
    for path, leaf in PT.named_leaves(ttree):
        jpath, layer = _quant_jax_path(path)
        jspec = _jax_spec(jspec_tree, jpath)
        want = next((spec for pat, spec in PINNED if re.search(pat, path)), None)
        if path.startswith("llm/lm_head_q/"):
            want = (None,) * leaf.dim()
        if want is None:
            transposed = jpath.endswith("kernel") and leaf.dim() == 2
            want = _expected(jspec, (), jshapes[jpath], layer, transposed, mesh)
        else:
            pinned += 1
            if any(a is not None for a in jspec):       # a rule JAX has: the same spec
                assert tuple(a for a in jspec[int(layer):]) == want, path
        assert tspecs[path] == want, (path, tspecs[path], want)
    assert pinned >= 14                       # 7 projections x 2 layers at least


def test_flagship_head_sanitize_keeps_lm_head_q_whole():
    """The flagship's 159,867-row head quantized (W8A8 Npad 159,872, W4A8
    Npad 160,256, both even) stays whole at model 2, as the float head
    does; a 512-row head splits. ``sanitize_specs`` reads the real N."""
    def heads(n):
        npad8, npad4 = -(-n // 8) * 8, -(-n // 512) * 512
        return {"lm_head_q": {"kernel_int8": torch.zeros((npad8, 4), dtype=torch.int8),
                              "scale": torch.ones(n)}}, {
            "lm_head_q": {"kernel_int4": torch.zeros((2, npad4), dtype=torch.int8),
                          "scale4": torch.ones((1, npad4)), "bias": torch.zeros(n)}}
    mesh = SpecMesh(1, 1, 2)
    for n, split in ((159867, False), (512, True)):
        for tree in heads(n):
            specs = PT.sanitize_specs(PT.partition_qwen2(tree), tree, mesh)
            assert all(("model" in s) == split for s in specs.values()), (n, specs)


@pytest.mark.parametrize("name", ["o", "down"])
def test_w8a8_row_product_bit_for_bit_model2(ranks, name):
    """A row-parallel W8A8 layer at model 2 (the slice quantized with the
    rows' global absmax, the int32 products summed over ``model``, one
    epilogue) equals the whole layer's ``dense_int8`` bit for bit on every
    rank."""
    for rows in ranks[0]["quant"]["rows"]:
        assert rows[f"w8a8/{name}"] is True


@pytest.mark.parametrize("combine,ref", [("hidden", "one_rank"), ("hidden", "jax"),
                                         ("logits", "one_rank")])
def test_w8a8_t2i_codes_model2(ranks, combine, ref):
    """The tiny int8 t2i (W8A8 backbone, the int8 image head split over the
    codes and gathered) at model 2: every rank's codes equal the port's
    one-rank codes and, with CFG on the hidden states (the default), JAX's,
    exactly (tests/test_torch_int8.py's bar; test_t2i_int8_codes_exact_vs_jax
    holds the one-rank codes of both combines to JAX's)."""
    r = ranks[0]["quant"][f"t2i_{combine}"]
    want = (r["whole"].numpy() if ref == "one_rank" else ranks[1]["quant"][f"t2i_{combine}"])
    assert want.shape == (2, 16)
    for codes in r["ranks"]:
        np.testing.assert_array_equal(np.asarray(codes), want)


@pytest.mark.parametrize("name", ["o", "down"])
def test_w4a8_row_product_model2(ranks, name):
    """A row-parallel W4A8 layer at model 2 within 1e-6 of the output scale
    of the whole layer's: kernel 4's fp32 partials summed over ``model``
    fold the group scales in another order. o's cut falls on a group of 64
    (128 -> 64 rows a rank); down's (192 -> 96) halves one, and the node is
    repacked at group 32 (``Sharding.groups``)."""
    r = ranks[0]["quant"]
    for rows in r["rows"]:
        assert rows[f"w4a8/{name}"] <= 1e-6
    cut = {p.split("/")[-1] for p in r["groups4"]}
    assert cut == {"down"} and set(r["groups4"].values()) == {W4_GROUP}


@pytest.mark.parametrize("ref", ["jax", "one_rank"])
@pytest.mark.parametrize("step", ["prefill", "decode"])
def test_w4a8_backbone_model2(ranks, step, ref):
    """The W4A8 backbone (down's groups cut by the ranks) at model 2, into a
    cache of the rank's one KV head: the prefill's and a decode step's
    hidden states match JAX's within ``_match_but_flips(max_flipped=1)``
    (tests/test_torch_int4.py's bar), and the port's one-rank run's too."""
    r = ranks[0]["quant"]
    h, h2, shape = r["backbone_sharded"]
    assert shape[3] == 1
    i = 0 if step == "prefill" else 1
    want = ranks[1]["quant"]["backbone"][i] if ref == "jax" else r["backbone_whole"][i].numpy()
    _match_but_flips((h, h2)[i].numpy(), np.asarray(want), max_flipped=1)


@pytest.mark.parametrize("mesh", ["4x1x2", "2x1x4", "2x2x2"])
@pytest.mark.parametrize("tree", ["w8", "w4", "lora"])
def test_quantized_and_lora_trees_gather_back_bit_for_bit(ranks, tree, mesh):
    """``gather_params(shard_params(t))`` is ``t`` bit for bit on every rank:
    the W8A8, W4A8 (relayouts undone, group 64 rebuilt) and LoRA trees at
    model 2, at model 4 (k/v, their nodes and adapters whole) and on (2, 2,
    2) with ``add_fsdp``."""
    for trips in ranks[0]["quant"]["roundtrip"]:
        t = trips[f"{tree}@{mesh}"]
        assert t["equal"]
        kspecs = set(t["k"].values())
        if mesh == "2x1x4":
            assert all(a is None for s in kspecs for a in s), t["k"]
        else:
            assert any("model" in s for s in kspecs), t["k"]
        assert (t["fsdp"] > 0) == (mesh == "2x2x2")


@pytest.mark.parametrize("model", [2, 4])
def test_lora_gradients_model2_and_4(ranks, model):
    """A cross-entropy forward of the LoRA tree at model 2 and at model 4
    (k/v, their adapters included, whole): every leaf's gathered gradient
    (the frozen ones and the adapter scales too) within 1e-5 of its largest
    from the unsharded forward's, on every rank."""
    for errs in ranks[0]["quant"]["lora_grads"][model]:
        worst = max(errs, key=errs.get)
        assert errs[worst] <= 1e-5, (worst, errs[worst])
        assert any(p.endswith("_lora_scale") for p in errs)


LORA_CASES = [("sft_lora", "separate", "jax"), ("sft_lora", "separate", "port_unsharded"),
              ("sft_lora", "packed", "port_unsharded"), ("dpo_lora", None, "jax"),
              ("dpo_lora", None, "port_unsharded")]


@pytest.mark.parametrize("program,mode,ref", LORA_CASES)
def test_lora_steps_model2(ranks, program, mode, ref):
    """The SFT (separate, packed) and DPO steps with adapters at data 4 x
    model 2, the adapters alone trained: against the port's one-rank step
    (metrics 1e-5; parameters 1e-5, DPO's 1e-4 as test_dpo_step_data4_model2
    says) and JAX's unsharded LoRA step (1e-4; its ``grad_norm`` metric also
    counts the frozen leaves' gradients, which the port does not take:
    ROADMAP "Deliberate differences", so the metrics there are the losses
    and rates, and the update, whose clip covers the trained leaves in both,
    is held leaf by leaf)."""
    out, jax_refs, inputs = ranks
    r = out[program] if mode is None else out[program][mode]
    names = DPO_METRICS if mode is None else SFT_METRICS
    cfg = inputs[program]["cfg"]
    if ref == "jax":
        jparams, jm = jax_refs[program] if mode is None else jax_refs[program][mode]
        _close_metrics(r["metrics"], jm, [k for k in names if k != "grad_norm"], 1e-4, 1e-6)
        errs = _leaf_errors(jparams, W.unigen_to_jax(r["params"], cfg))
        assert max(errs.values()) < 1e-4, {k: v for k, v in errs.items() if v >= 1e-4}
    else:
        _close_metrics(r["metrics"], r["whole_metrics"], names, 1e-5, 1e-6)
        assert _max_leaf_err(r["whole_params"], r["params"]) < (1e-4 if mode is None else 1e-5)


@pytest.mark.parametrize("program,mode", [("sft_lora", "separate"), ("sft_lora", "packed"),
                                          ("dpo_lora", None)])
def test_lora_steps_model2_move_only_adapters(ranks, program, mode):
    out, _, inputs = ranks
    r = out[program] if mode is None else out[program][mode]
    before = dict(TO.named_leaves(inputs[program]["params"]))
    moved = {p for p, t in TO.named_leaves(r["params"]) if not torch.equal(t, before[p])}
    assert moved and all(p.endswith(("_lora_a", "_lora_b")) for p in moved), moved
    assert any(p.endswith("down_lora_a") for p in moved)         # a row projection's a


@pytest.mark.parametrize("what", ["one_rank", "jax", "ranks_identical", "local_heads"])
@pytest.mark.parametrize("mode", ["int8+kv", "int8+int4"])
def test_quantized_engine_model2(ranks, mode, what):
    """The engine at model 2 in int8+kv (W8A8, the int8 cache) and int8+int4
    (W8A8 admission, W4A8 decode chunks): every request's tokens equal the
    port's one-rank engine in fp32; the greedy ones agree with JAX's engine
    at >= 0.95 (JAX's TP engine test's bar); the followers run the same
    chunks and busy steps; each rank's cache holds one of the two KV heads."""
    r = ranks[0]["serving_quant"][mode]
    whole, ranks_out = r["whole"], r["ranks"]
    if what == "one_rank":
        assert ranks_out[0][0] == whole[0]
    elif what == "jax":
        want, got = ranks[1]["serving_quant"][mode], ranks_out[0][0][:3]
        agree = np.mean([np.mean(np.array(a) == np.array(b)) for a, b in zip(want, got)])
        assert agree >= 0.95, f"{mode} TP engine agreement with JAX {agree:.2f}"
    elif what == "ranks_identical":
        for o in ranks_out[1:]:
            assert o[:3] == ranks_out[0][:3]
    else:
        assert whole[3] == 2 and all(o[3] == 1 for o in ranks_out)


@pytest.mark.parametrize("how", R.DERIVED)
def test_derived_sharded_tree_matches_jax(ranks, how):
    """A tree rebuilt from shards (``torch_parallel_ranks.derive``) runs as
    the shards with its ``Sharding``: the tiny UniGen's logits at data 4 x
    model 2 against the port's unsharded forward (rtol 1e-5) and JAX's
    (1e-4); the PT2 step of a derived state on (2, 2, 2) with ``add_fsdp``
    against the port's unsharded step (1e-5, parameters 1e-5) and JAX's
    step (1e-4, parameters 1e-4)."""
    out, jax_refs, inputs = ranks
    r = out["derived"]
    logits = r["logits"][how]
    torch.testing.assert_close(logits, r["whole_logits"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(logits.numpy(), jax_refs["derived"], rtol=1e-4, atol=1e-4)
    step = r["steps"][how]
    _close_metrics(step["metrics"], out["pt2"]["whole_metrics"], PT2_METRICS, 1e-5, 1e-6)
    assert _max_leaf_err(out["pt2"]["whole_params"], step["params"]) < 1e-5
    jparams, jm = jax_refs["pt2"]
    _close_metrics(step["metrics"], jm, PT2_METRICS, 1e-4, 1e-5)
    errs = _leaf_errors(jparams, W.unigen_to_jax(step["params"], inputs["pt2"]["cfg"]))
    assert max(errs.values()) < 1e-4, {k: v for k, v in errs.items() if v >= 1e-4}


@pytest.mark.parametrize("tree,leaf,sizes", [
    ("attention", "layers/0/q_w's output features", "32 here and 64"),
    ("mlp", "layers/0/gate_w's output features", "64 here and 128"),
    ("fsdp", "layers/0/gate_w's input features", "32 here and 64"),
    ("siglip", "layers/0/q_w's shape", "(16, 32) here and (32, 32)")],
    ids=["attention", "mlp", "fsdp", "siglip"])
def test_sharded_tree_without_specs_raises(ranks, tree, leaf, sizes):
    """A sharded tree run without its specs raises a ``ValueError`` naming
    the leaf and both sizes, where it would fail on a reshape (attention)
    or return a rank's partial sum (the MLP's down projection)."""
    msg = ranks[0]["without_specs"][tree]
    assert msg.startswith(f"{leaf} is {sizes} in the config"), msg
