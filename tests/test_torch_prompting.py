"""The port's prompting (``unigen_tpu_torch/prompting.py``) against the JAX
package's, task by task: ``UniPrompting`` and ``UniPromptingLegacy``, each
side with a fresh instance of tests/test_prompting.py's mock tokenizers (the
reference prompt engine is absent and its golden tests skip, so the JAX classes
are the oracle). Every output (ids, masks, labels, positions) equal element
for element, with the dtype, across the truncation, negative ``max_len``,
system-prompt, ``task_token_first``, ``ignore_id``, conditioning-dropout and
``enable_reuse_tk`` variants that tests/test_prompting.py runs."""
import numpy as np
import pytest

from test_prompting import SPECIALS, LegacyMockTokenizer, MockTokenizer, _img
from unigen_tpu import prompting as JP
from unigen_tpu_torch import prompting as TP


def _same(a, b, where="out"):
    if isinstance(a, tuple) or isinstance(b, tuple):
        assert isinstance(a, tuple) and isinstance(b, tuple) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    elif a is None or b is None:
        assert a is None and b is None, where
    else:
        assert a.dtype == b.dtype, where
        np.testing.assert_array_equal(a, b, err_msg=where)


def _conv(b, n, seed, eos_at=None, no_eos_row=None):
    rng = np.random.default_rng(seed)
    conv = rng.integers(10, 90, size=(b, n))
    if eos_at is not None:
        conv[eos_at] = 501
    if no_eos_row is not None:
        conv[no_eos_row] = np.where(conv[no_eos_row] == 501, 99, conv[no_eos_row])
    return conv


def _lm_conv_ids():
    ids = _conv(3, 64, 5)
    ids[0, 20] = 501
    ids[1, 63] = 501
    ids[2] = np.where(ids[2] == 501, 99, ids[2])
    return ids


EMB_TEXTS = ["what<|im_end|>\n<|im_start|>assistant\nanswer<|im_end|>",
             "why<|im_end|>\n<|im_start|>assistant\nyes<|im_end|>"]
IMG = _img()
CONV = _conv(2, 12, 3, eos_at=(0, 7), no_eos_row=1)
SYS_CONV = _conv(2, 10, 4, eos_at=(slice(None), -1))
SYSTEM = _conv(2, 5, 4)

# name: (engine keyword arguments, inputs, task)
UNI_CASES = {
    "t2i": ({}, (["a red cat", "dog"], IMG, IMG + 1), "t2i"),
    "t2i_dropout": (dict(cond_dropout_prob=0.5), (["a red cat", "dog", "x", "long one"],
                                                  _img(b=4), _img(b=4) + 1), "t2i"),
    "t2i_ignore_id": (dict(ignore_id=-1), (["a red cat", "dog"], IMG, IMG + 1), "t2i"),
    "t2i_gen": ({}, (["blue bird flying", "x"], IMG), "t2i_gen"),
    "t2i_gen_max_len": ({}, (["blue bird flying", "x"], IMG, 20), "t2i_gen"),
    "t2i_gen_truncation": ({}, (["a" * 100], _img(b=1)), "t2i_gen"),
    "lm": ({}, (["hello world", "k" * 80], 32), "lm"),
    "lm_ignore_id": (dict(ignore_id=-7), (["hello world", "k" * 80], 32), "lm"),
    "mmu": ({}, (IMG, ["what is this?", "describe"]), "mmu"),
    "mmu_task_token_first": (dict(task_token_first=True), (IMG, ["q1", "q2"]), "mmu"),
    "mmu_truncation": ({}, (IMG, ["z" * 90, "short"]), "mmu"),
    "mmu_conv_discrete": ({}, (_img(n=6), CONV, None, None), "mmu_conv"),
    "mmu_conv_system": ({}, (_img(n=6), SYS_CONV, SYS_CONV, SYSTEM), "mmu_conv"),
    "mmu_conv_system_once": ({}, (_img(n=6), SYS_CONV, None, SYSTEM[:1]), "mmu_conv"),
    "mmu_conv_embeddings": (dict(task_token_first=True),
                            (np.zeros((2, 6, 4), np.float32), CONV, None, SYSTEM), "mmu_conv"),
    "mmu_emb": ({}, (np.zeros((2, 6, 4), np.float32), EMB_TEXTS), "mmu_emb"),
    "mmu_emb_task_token_first": (dict(task_token_first=True, ignore_id=-3),
                                 (np.zeros((2, 6, 4), np.float32), EMB_TEXTS), "mmu_emb"),
    "mmu_emb_naflex": ({}, (np.asarray([[2, 3], [1, 4]]), EMB_TEXTS), "mmu_emb"),
    "mmu_emb_truncation": (dict(max_seq_len=40), (np.zeros((2, 6, 4), np.float32),
                                                  [EMB_TEXTS[0] + "q" * 40, EMB_TEXTS[1]]),
                           "mmu_emb"),
    "lm_conv": ({}, _lm_conv_ids(), "lm_conv"),
    "reuse_tk_t2i": (dict(enable_reuse_tk=True), (["a red cat", "dog"], IMG, IMG + 1), "t2i"),
    "reuse_tk_mmu_emb": (dict(enable_reuse_tk=True),
                         (np.zeros((2, 6, 4), np.float32), EMB_TEXTS), "mmu_emb"),
}


@pytest.mark.parametrize("name", list(UNI_CASES))
def test_uniprompting_matches_jax(name):
    kw, inputs, task = UNI_CASES[name]
    kw = dict(dict(special_tokens=SPECIALS, max_seq_len=64, cond_dropout_prob=0.0), **kw)
    jax_side = JP.UniPrompting(MockTokenizer(), rng=np.random.default_rng(3), **kw)
    port = TP.UniPrompting(MockTokenizer(), rng=np.random.default_rng(3), **kw)
    assert port.sptids_dict == jax_side.sptids_dict
    assert (port.bos_token_id, port.eos_token_id, port.pad_id, port.ignore_id) == \
        (jax_side.bos_token_id, jax_side.eos_token_id, jax_side.pad_id, jax_side.ignore_id)
    _same(port(inputs, task), jax_side(inputs, task))
    if kw.get("enable_reuse_tk"):       # tests/test_prompting.py::test_reuse_tk_maps_vision_tokens
        assert port.sptids_dict["<|soi|>"] == 503 and port.sptids_dict["<|eoi|>"] == 504


LEGACY_CASES = {
    "t2i": ((["a red cat", "dog"], IMG, IMG + 1), "t2i", None),
    "t2v": ((["a video of rain", "x"], IMG, IMG + 1), "t2v", None),
    "lvg": ((["a video of rain", "x"], IMG, IMG + 1), "lvg", None),
    "t2i_dropout": ((["a red cat", "dog", "x"], _img(b=3), _img(b=3) + 1), "t2i", None),
    "t2i_truncation": ((["a" * 30, "dog"], IMG, IMG + 1), "t2i", None),
    "t2i_gen": ((["blue bird", "y"], IMG), "t2i_gen", None),
    "t2i_gen_negative_max_len": ((["longer caption here", "s"], IMG, -1), "t2i_gen", None),
    "t2i_gen_max_len": ((["longer caption here", "s"], IMG, 8), "t2i_gen", None),
    "t2v_gen": ((["blue bird", "y"], IMG), "t2v_gen", None),
    "lvg_gen": ((["blue bird", "y"], IMG), "lvg_gen", None),
    "lm": ((["some document text", "tiny"], 16), "lm", None),
    "mmu": ((IMG, ["what is it?", "hm"]), "mmu", None),
    "mmu_truncation": ((IMG, ["w" * 30, "hm"]), "mmu", None),
    "mmu_conv": ((_img(n=6), SYS_CONV, SYS_CONV, None), "mmu_conv", None),
    "mmu_conv_system": ((_img(n=6), SYS_CONV, SYS_CONV, SYSTEM[:, :4]), "mmu_conv", None),
    "mmu_conv_embeddings": ((np.zeros((2, 6, 4), np.float32), SYS_CONV, SYS_CONV, None),
                            "mmu_conv", None),
    "mmu_emb": ((np.zeros((2, 6, 4), np.float32), ["hello", "y" * 30]), "mmu_emb", None),
    "t2i_plus_lm": ((["img caption", "more caption", "pure text", "another doc"], IMG, IMG + 1,
                     16), "t2i_plus_lm", 2),
}


@pytest.mark.parametrize("name", list(LEGACY_CASES))
def test_legacy_prompting_matches_jax(name):
    inputs, task, config = LEGACY_CASES[name]
    kw = dict(special_tokens=SPECIALS, max_text_len=12, max_seq_len=64,
              cond_dropout_prob=0.5 if name == "t2i_dropout" else 0.0)
    jax_side = JP.UniPromptingLegacy(LegacyMockTokenizer(), rng=np.random.default_rng(2), **kw)
    port = TP.UniPromptingLegacy(LegacyMockTokenizer(), rng=np.random.default_rng(2), **kw)
    assert port.sptids_dict == jax_side.sptids_dict
    _same(port(inputs, task, config=config), jax_side(inputs, task, config=config))
