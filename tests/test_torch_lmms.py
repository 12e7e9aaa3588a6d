"""The port's lmms-eval adapter and plugin against the JAX package, fp32 on the CPU.

Both towers' tiny pipelines (tests/test_torch_pipeline_more.py's SigLIP one,
tests/test_torch_naflex.py's NaFlex one) on shared weights. Requests carry
images already at their prepared size (28 px for SigLIP; 16 x 16, 8 x 32,
12 x 20 and 20 x 12 within the NaFlex budget of 16 patches of 4 px), so
neither side's resize moves a value and the comparisons are exact:

* ``generate_until`` strings equal JAX's adapter's, greedy, for both towers,
  over interleaved decode groups, mixed aspects, ``until`` stops and two
  'concat' multi-image requests;
* batched = batch 1; served (``ServingEngine``, 3 slots, chunk 2) = static,
  with ``speculate_k`` 0 and 3;
* ``loglikelihood``: batched = one request at a time (1e-5), and JAX's
  adapter's scores within 1e-5 relative, greedy flags equal;
* the plugin module (``evaluation/lmms_plugin.py``) through a fake
  ``lmms_eval`` package in ``sys.modules``: registered as
  "unigen_tpu_torch", its ``generate_until`` and ``loglikelihood`` equal the
  adapter's on the same requests.
"""
import importlib
import pathlib
import sys
import types

import numpy as np
import pytest
from PIL import Image

from test_torch_naflex import make_naflex_pipes
from test_torch_pipeline_more import make_pipes
from unigen_tpu.evaluation import lmms_adapter as JA
from unigen_tpu_torch.evaluation import lmms_adapter as TA

ROOT_CONFIG = str(pathlib.Path(__file__).resolve().parent.parent / "configs/tiny/smoke_sft.yaml")


@pytest.fixture(scope="module")
def towers():
    return {"siglip": make_pipes(), "naflex": make_naflex_pipes()}


def _img(h, w, seed):
    arr = np.random.default_rng(seed).integers(0, 256, size=(h, w, 3), dtype=np.uint8)
    return Image.fromarray(arr)


def _requests(tower):
    """Interleaved decode groups, a stop string, two 'concat' requests and
    (NaFlex) mixed aspects, every image at its prepared size."""
    if tower == "siglip":
        sizes = [(28, 28)] * 6
        pair = [(28, 14), (28, 14)]
    else:
        sizes = [(16, 16), (8, 32), (12, 20), (16, 16), (20, 12), (8, 32)]
        pair = [(16, 8), (16, 8)]
    imgs = [_img(h, w, i) for i, (h, w) in enumerate(sizes)]
    two = [_img(h, w, 10 + i) for i, (h, w) in enumerate(pair)]
    long_q = "please describe every object and its color in this picture " * 2
    return [("what is shown?", {"max_new_tokens": 3}, imgs[0]),
            (long_q, {"max_new_tokens": 4}, imgs[1]),
            ("what color?", {"max_new_tokens": 3}, imgs[2]),
            ("count the objects", {"max_new_tokens": 4, "until": ["\n", "a"]}, imgs[3]),
            ("compare these", {"max_new_tokens": 3}, two),
            ("is it red?", {"max_new_tokens": 2}, imgs[4]),
            ("and these?", {"max_new_tokens": 4, "until": ["b"]}, list(reversed(two))),
            ("why?", {"max_new_tokens": 3}, imgs[5])]


@pytest.mark.parametrize("tower", ["siglip", "naflex"])
def test_generate_until_matches_jax(towers, tower):
    jpipe, tpipe = towers[tower]
    reqs = _requests(tower)
    ours = TA.UniGenLmmsAdapter(tpipe, use_system_prompt=True, batch_size=4, max_new_tokens=3)
    ref = JA.UniGenLmmsAdapter(jpipe, use_system_prompt=True, batch_size=4, max_new_tokens=3)
    for _, _, images in reqs:
        assert ours._prepared_shape(images) == ref._prepared_shape(images)
        assert ours._prepare_image(images).shape == ref._prepare_image(images).shape
        assert ours._num_patches(images) == ref._num_patches(images)
    got = ours.generate_until(reqs)
    assert got == ref.generate_until(reqs)
    assert len(got) == len(reqs) and all(isinstance(t, str) for t in got)


def test_concat_images_horizontal_matches_jax():
    ims = [_img(12, 5, 0), _img(7, 9, 1), _img(12, 3, 2).convert("L")]
    want = np.asarray(JA.concat_images_horizontal(ims))
    got = TA.concat_images_horizontal(ims)
    assert got.shape == want.shape == (12, 17, 3)
    np.testing.assert_array_equal(got, want)


def test_batched_matches_batch1_naflex(towers):
    """Batches of 4 over interleaved groups and mixed aspects give the batch-1
    strings, in request order."""
    _, tpipe = towers["naflex"]
    reqs = _requests("naflex")
    a1 = TA.UniGenLmmsAdapter(tpipe, use_system_prompt=True, batch_size=1)
    ab = TA.UniGenLmmsAdapter(tpipe, use_system_prompt=True, batch_size=4)
    assert ab.generate_until(reqs) == a1.generate_until(reqs)


@pytest.mark.parametrize("tower,spec_k", [("naflex", 0), ("naflex", 3), ("siglip", 3)])
def test_serving_matches_static(towers, tower, spec_k):
    """The continuous-batching route (3 slots, chunk 2: more requests than
    slots, mixed budgets) gives the static route's strings."""
    _, tpipe = towers[tower]
    reqs = _requests(tower)
    static = TA.UniGenLmmsAdapter(tpipe, use_system_prompt=True, batch_size=4)
    served = TA.UniGenLmmsAdapter(tpipe, use_system_prompt=True, batch_size=4, serving=True,
                                  serving_slots=3, serving_chunk=2, serving_speculate_k=spec_k)
    assert served.generate_until(reqs) == static.generate_until(reqs)
    assert served.last_latency["n"] == len(reqs) and served.generate_until([]) == []


@pytest.mark.parametrize("tower", ["siglip", "naflex"])
def test_loglikelihood_matches_jax_and_single(towers, tower):
    jpipe, tpipe = towers[tower]
    imgs = [r[2] for r in _requests(tower)][:5]
    reqs = [("what is this?", "a cat", imgs[0]),
            ("is the long object on the left red or blue?", "blue", imgs[1]),
            ("how many?", "three objects in total", imgs[2]),
            ("why?", "because", imgs[3]),
            ("color?", "green", imgs[4])]
    ours = TA.UniGenLmmsAdapter(tpipe, use_system_prompt=True, batch_size=3)
    got = ours.loglikelihood(reqs)
    want = JA.UniGenLmmsAdapter(jpipe, use_system_prompt=True, batch_size=3).loglikelihood(reqs)
    sys_ids = ours._system_ids()
    for (ctx, cont, img), (lp, g), (lp_j, g_j) in zip(reqs, got, want):
        assert g == g_j
        np.testing.assert_allclose(lp, lp_j, rtol=1e-5)
        ids = np.asarray(tpipe.prompting._tokenize(cont)[0], np.int64)
        lp_s, g_s = tpipe.score_continuation(ours._prepare_image(img)[None], ctx, ids,
                                             system_prompt_ids=sys_ids)
        assert g == g_s
        np.testing.assert_allclose(lp, lp_s, rtol=1e-5, atol=1e-5)


def _fake_lmms_eval(monkeypatch):
    """A stand-in ``lmms_eval`` with the three names the plugin imports."""
    registered = {}

    class lmms:                              # noqa: N801 (lmms-eval's own name)
        def __init__(self):
            self.task_dict = {}

    def register_model(name):
        def deco(cls):
            registered[name] = cls
            return cls
        return deco

    mods = {"lmms_eval": types.ModuleType("lmms_eval"),
            "lmms_eval.api": types.ModuleType("lmms_eval.api"),
            "lmms_eval.api.instance": types.ModuleType("lmms_eval.api.instance"),
            "lmms_eval.api.model": types.ModuleType("lmms_eval.api.model"),
            "lmms_eval.api.registry": types.ModuleType("lmms_eval.api.registry")}
    mods["lmms_eval.api.instance"].Instance = types.SimpleNamespace
    mods["lmms_eval.api.model"].lmms = lmms
    mods["lmms_eval.api.registry"].register_model = register_model
    for name, mod in mods.items():
        monkeypatch.setitem(sys.modules, name, mod)
    monkeypatch.delitem(sys.modules, "unigen_tpu_torch.evaluation.lmms_plugin", raising=False)
    return registered


def test_plugin_through_fake_lmms_eval(monkeypatch):
    """The plugin registers under "unigen_tpu_torch", builds the NaFlex tiny
    pipeline from a config on the CPU, and answers lmms-eval's Instance
    requests as the adapter answers the same requests."""
    registered = _fake_lmms_eval(monkeypatch)
    plugin = importlib.import_module("unigen_tpu_torch.evaluation.lmms_plugin")
    assert registered == {"unigen_tpu_torch": plugin.UniGenTpuTorch}
    from unigen_tpu_torch.utils import configuration
    real = configuration.initialize_config
    monkeypatch.setattr(configuration, "initialize_config", lambda path, ov: real(
        path, ov + ["model.vision_tower.name=siglip2-naflex-smoke",
                    "model.vision_tower.patch_size=4"]))
    model = plugin.UniGenTpuTorch(config=ROOT_CONFIG, batch_size=2, mm_input_mode="concat",
                                  max_new_tokens=3, device="cpu")
    assert type(model.adapter.pipeline.vision_cfg).__name__ == "Siglip2Config"
    docs = [{"q": "what is shown?", "img": _img(16, 24, 0), "a": "a cat"},
            {"q": "and here?", "img": [_img(8, 8, 1), _img(8, 16, 2)], "a": "two"},
            {"q": "why?", "img": _img(20, 12, 3), "a": "because"}]
    model.task_dict = {"t": {"test": docs}}

    def visual(doc):
        return doc["img"]

    gen = [types.SimpleNamespace(args=(d["q"], {"max_new_tokens": 2 + i}, visual, i, "t", "test"))
           for i, d in enumerate(docs)]
    ll = [types.SimpleNamespace(args=(d["q"], lambda doc: doc["a"], visual, i, "t", "test"))
          for i, d in enumerate(docs)]
    texts = model.generate_until(gen)
    assert texts == model.adapter.generate_until(
        [(d["q"], {"max_new_tokens": 2 + i}, d["img"]) for i, d in enumerate(docs)])
    scores = model.loglikelihood(ll)
    assert scores == model.adapter.loglikelihood([(d["q"], d["a"], d["img"]) for d in docs])
    assert all(np.isfinite(lp) and isinstance(g, bool) for lp, g in scores)
    with pytest.raises(NotImplementedError):
        model.generate_until_multi_round([])
