"""The last public functions of the JAX package's ops and utils, held to
JAX's on the CPU: ``ops/sampling.py``'s ``gumbel_sample`` (the same uniforms
on both sides), ``top_k_by_threshold`` and ``top_k_top_p_filtering`` (ties
and ``min_tokens_to_keep`` included), ``ops/masks.py``'s
``create_attention_mask_for_mmu_vit`` and ``to_additive``, all exact; and
``utils/hf_import.py::load_state_dict``'s shard resolution (a file, an
index json, every ``*.safetensors``, else every ``pytorch_model*.bin``),
bit for bit."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unigen_tpu.ops import masks as JM
from unigen_tpu.ops import sampling as JS
from unigen_tpu.utils import hf_import as JH
from unigen_tpu_torch.ops import masks as TM
from unigen_tpu_torch.ops import sampling as TS
from unigen_tpu_torch.utils import hf_import as TH
from unigen_tpu_torch.utils import persistence as TP


def _logits(seed, shape=(4, 64), ties=True):
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32) * 3
    if ties:          # whole tied groups around the cuts
        x[:, 10:14] = x[:, 3:4]
        x[0, :] = np.round(x[0, :])
    return x


@pytest.mark.parametrize("temperature", [1.0, 0.3, 0.0])
def test_gumbel_sample_matches_jax(temperature):
    key = jax.random.key(3)
    logits = _logits(1, ties=False)
    want = np.asarray(JS.gumbel_sample(key, jnp.asarray(logits), temperature))
    u = np.asarray(jax.random.uniform(key, logits.shape, jnp.float32))  # JAX's draw inside
    got = TS.gumbel_sample(None, torch.as_tensor(logits), temperature, noise=torch.as_tensor(u))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("thres", [0.9, 0.5, 0.99, 0.0])
def test_top_k_by_threshold_matches_jax(thres):
    x = _logits(2)
    want = np.asarray(JS.top_k_by_threshold(jnp.asarray(x), thres))
    np.testing.assert_array_equal(TS.top_k_by_threshold(torch.as_tensor(x), thres).numpy(), want)


@pytest.mark.parametrize("top_k,top_p,keep", [(0, 1.0, 1), (5, 1.0, 1), (12, 1.0, 1),
                                              (0, 0.9, 1), (0, 0.5, 1), (0, 0.05, 3),
                                              (8, 0.7, 1), (2, 0.3, 4), (100, 0.99, 1)])
def test_top_k_top_p_filtering_matches_jax(top_k, top_p, keep):
    x = _logits(3)
    want = np.asarray(JS.top_k_top_p_filtering(jnp.asarray(x), top_k, top_p,
                                               min_tokens_to_keep=keep))
    got = TS.top_k_top_p_filtering(torch.as_tensor(x), top_k, top_p, min_tokens_to_keep=keep)
    np.testing.assert_array_equal(got.numpy(), want)
    got = TS.top_k_top_p_filtering(torch.as_tensor(x), top_k, top_p, filter_value=-5.0,
                                   min_tokens_to_keep=keep)
    want = np.asarray(JS.top_k_top_p_filtering(jnp.asarray(x), top_k, top_p, filter_value=-5.0,
                                               min_tokens_to_keep=keep))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("kw", [dict(), dict(system_prompt_len=5), dict(num_tokens=9),
                                dict(num_tokens=4, num_images=2, prefix_length=7),
                                dict(return_causal_mask=True), "naflex"],
                         ids=["default", "system", "tokens", "prefix", "causal", "naflex"])
def test_mmu_vit_mask_matches_jax(kw):
    if kw == "naflex":
        shapes = np.asarray([[2, 3], [1, 4], [3, 3]])
        want = JM.create_attention_mask_for_mmu_vit(3, 24, num_tokens=jnp.asarray(shapes))
        got = TM.create_attention_mask_for_mmu_vit(3, 24, num_tokens=torch.as_tensor(shapes))
    else:
        kw = dict(dict(num_tokens=6), **kw)
        want = JM.create_attention_mask_for_mmu_vit(2, 20, **kw)
        got = TM.create_attention_mask_for_mmu_vit(2, 20, **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_to_additive_matches_jax(dtype):
    m = np.random.default_rng(4).random((2, 1, 5, 5)) > 0.4
    want = JM.to_additive(jnp.asarray(m), getattr(jnp, dtype))
    got = TM.to_additive(torch.as_tensor(m), getattr(torch, dtype))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want).astype(np.float32))


def _tensors(seed):
    rng = np.random.default_rng(seed)
    return {f"layer.{i}.w": torch.as_tensor(rng.normal(size=(3, 4)).astype(np.float32))
            for i in range(4)} | {"ids": torch.arange(5), "half": torch.ones(2, dtype=torch.float16)}


def _layouts(root):
    """{name: path}: one safetensors file (as a file and as a directory),
    shards behind an index json (beside a stray file the index does not
    name), plain shards without an index, and two ``pytorch_model*.bin``."""
    sd = _tensors(0)
    names = sorted(sd)
    out = {}
    single = os.path.join(root, "single")
    os.makedirs(single)
    TP.save_file(sd, os.path.join(single, "model.safetensors"))
    out["file"] = os.path.join(single, "model.safetensors")
    out["single_dir"] = single
    for name, index in (("indexed", True), ("unindexed", False)):
        d = os.path.join(root, name)
        os.makedirs(d)
        weight_map = {}
        for i, part in enumerate((names[:3], names[3:])):
            fn = f"model-0000{i + 1}-of-00002.safetensors"
            TP.save_file({k: sd[k] for k in part}, os.path.join(d, fn))
            weight_map.update({k: fn for k in part})
        if index:
            with open(os.path.join(d, "model.safetensors.index.json"), "w") as f:
                json.dump({"metadata": {}, "weight_map": weight_map}, f)
            TP.save_file({"stray": torch.zeros(1)}, os.path.join(d, "zz-other.safetensors"))
        out[name] = d
    bins = os.path.join(root, "bins")
    os.makedirs(bins)
    for i, part in enumerate((names[:2], names[2:])):
        torch.save({k: sd[k] for k in part}, os.path.join(bins, f"pytorch_model-0000{i + 1}.bin"))
    out["bins"] = bins
    return out


def test_load_state_dict_matches_jax(tmp_path):
    for name, path in _layouts(str(tmp_path)).items():
        want = JH.load_state_dict(path)
        got = TH.load_state_dict(path)
        assert sorted(got) == sorted(want), name
        for k, v in want.items():
            assert got[k].numpy().dtype == v.dtype, (name, k)
            np.testing.assert_array_equal(got[k].numpy(), v, err_msg=f"{name} {k}")
    with pytest.raises(FileNotFoundError):
        TH.load_state_dict(str(tmp_path / "empty_dir_absent"))
