"""The port's pipeline, prompting and launch, and its isolation from JAX.

* prompt ids from the port's ``UniPrompting`` / ``FallbackTokenizer`` equal
  the JAX package's;
* ``generate_images`` on the tiny pipeline (CPU) gives in-range codes and
  finite pixels, and the same ``torch.Generator`` seed gives the same images;
* the package imports neither ``jax`` nor ``unigen_tpu``: checked in a
  subprocess that runs the tiny pipeline (t2i, and W4A8 ``understand``), and
  by an AST scan of the sources;
* an entry point called without ``device`` on a machine with no CUDA raises.
"""
import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from unigen_tpu.launch import FallbackTokenizer as JFallback
from unigen_tpu.launch import TRAIN_SPECIAL_TOKENS as J_SPECIALS
from unigen_tpu.pipeline import pixels_to_uint8 as j_to_uint8
from unigen_tpu.prompting import UniPrompting as JPrompting
from unigen_tpu_torch import launch as L
from unigen_tpu_torch.pipeline import pixels_to_uint8
from unigen_tpu_torch.prompting import UniPrompting as TPrompting

from test_prompting import MockTokenizer, SPECIALS

ROOT = pathlib.Path(__file__).resolve().parent.parent
PROMPTS = ["a red cat", "two dogs on a very long walk along the river bank", ""]


@pytest.mark.parametrize("max_text_len", [None, 8, 40])
def test_t2i_gen_prompt_ids_match_jax(max_text_len):
    n = 16
    img = np.full((len(PROMPTS), n), 77, np.int64)
    ours = TPrompting(MockTokenizer(), special_tokens=SPECIALS, max_seq_len=64)
    ref = JPrompting(MockTokenizer(), special_tokens=SPECIALS, max_seq_len=64,
                     cond_dropout_prob=0.0)
    inputs = (PROMPTS, img) if max_text_len is None else (PROMPTS, img, max_text_len)
    for got, want in zip(ours(inputs, "t2i_gen"), ref(inputs, "t2i_gen")):
        np.testing.assert_array_equal(got, want)


def test_flagship_prompt_ids_match_jax():
    """The flagship pipeline's GenEval prompts (byte tokenizer, 128-token budget)."""
    pipe_prompting = L.build_prompting(L.FallbackTokenizer())
    ref = JPrompting(JFallback(), special_tokens=J_SPECIALS, max_seq_len=L.FLAGSHIP_MAX_SEQ_LEN,
                     cond_dropout_prob=0.0, task_token_first=False)
    img = np.full((len(PROMPTS), 256), 151674 + 8192, np.int64)
    got, _ = pipe_prompting((PROMPTS, img, 128), "t2i_gen")
    want, _ = ref((PROMPTS, img, 128), "t2i_gen")
    np.testing.assert_array_equal(got, want)
    assert got.shape == (3, 406)                       # prefix of 148 + [soi][256][eoi]
    assert len(pipe_prompting.text_tokenizer) == len(ref.text_tokenizer) == 151674


def test_fallback_tokenizer_matches_jax():
    ours, ref = L.FallbackTokenizer(), JFallback()
    ours.add_tokens(list(J_SPECIALS))
    ref.add_tokens(list(J_SPECIALS))
    text = "<|im_start|><|t2i|>user\nhé<|soi|>x<|im_end|>"
    assert ours(text) == ref(text)
    assert ours.decode(ours(text)["input_ids"]) == ref.decode(ref(text)["input_ids"])
    assert (ours.pad_token_id, ours.eos_token_id, len(ours)) == \
        (ref.pad_token_id, ref.eos_token_id, len(ref))


@pytest.fixture(scope="module")
def tiny():
    return L.build_pipeline("tiny", device="cpu", seed=0)


def test_generate_images_tiny_end_to_end(tiny):
    codes = tiny.generate_images(["a red cat", "a dog"], torch.Generator().manual_seed(0),
                                 guidance_scale=2.0, timesteps=3, max_text_len=8,
                                 return_codes=True)
    assert codes.shape == (2, tiny.cfg.num_vq_tokens)
    assert ((codes >= 0) & (codes < tiny.cfg.codebook_size)).all()
    pixels = tiny.decode_codes(codes)
    assert pixels.shape == (2, 8, 8, 3) and torch.isfinite(pixels).all()
    imgs = pixels_to_uint8(pixels)
    assert imgs.dtype == np.uint8 and imgs.shape == (2, 8, 8, 3)


def test_same_generator_seed_same_images(tiny):
    def run(seed):
        return tiny.generate_images(["a red cat"], torch.Generator().manual_seed(seed),
                                    guidance_scale=6.0, timesteps=4, max_text_len=8)
    a, b, c = run(1), run(1), run(2)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)


@pytest.mark.parametrize("guidance_scale", [1.0, 6.0])
def test_prefix_cached_codes_build_no_omni_mask(tiny, monkeypatch, guidance_scale):
    """``generate_images`` takes the prefix-cached path, which reads no dense
    omni mask: it builds none, and its codes equal those of ``t2i_generate``
    handed JAX's mask as before."""
    from unigen_tpu_torch.generation import t2i_generate
    from unigen_tpu_torch.ops import masks as M
    from unigen_tpu_torch.ops import sampling as S
    prompts = ["a red cat", "a dog"]
    ids, uncond = (torch.as_tensor(a) for a in tiny.prompt_ids(prompts, 8))
    sp, pad = tiny.prompting.sptids_dict, tiny.prompting.pad_id
    mask = M.create_attention_mask_predict_next(
        torch.cat([ids, uncond]), pad_id=pad, soi_id=sp["<|soi|>"], eoi_id=sp["<|eoi|>"],
        rm_pad_in_image=True)
    if guidance_scale <= 1:
        mask = mask[:2]
    want = t2i_generate(tiny.params, tiny.cfg, torch.Generator().manual_seed(0), ids, mask,
                        uncond_input_ids=uncond, temperature=1.0, timesteps=3,
                        guidance_scale=guidance_scale,
                        noise_schedule=S.get_mask_schedule("cosine"), pad_id=pad)
    built = []
    real = M.create_attention_mask_predict_next
    monkeypatch.setattr(M, "create_attention_mask_predict_next",
                        lambda *a, **k: built.append(1) or real(*a, **k))
    got = tiny.generate_images(prompts, torch.Generator().manual_seed(0),
                               guidance_scale=guidance_scale, timesteps=3, max_text_len=8,
                               return_codes=True)
    assert built == [] and torch.equal(got, want)


def test_pixels_to_uint8_matches_jax():
    x = np.random.default_rng(0).uniform(-1.3, 1.3, size=(2, 4, 4, 3)).astype(np.float32)
    np.testing.assert_array_equal(pixels_to_uint8(torch.from_numpy(x)), j_to_uint8(x))


def test_entry_point_without_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        L.build_pipeline("tiny")
    with pytest.raises(RuntimeError):
        L.build_pipeline("tiny", device="cuda")


def test_package_runs_without_jax_in_a_subprocess():
    code = (
        "import sys, torch\n"
        "from unigen_tpu_torch.launch import build_pipeline\n"
        "p = build_pipeline('tiny', device='cpu')\n"
        "px = p.generate_images(['a cat'], torch.Generator().manual_seed(0),\n"
        "                       guidance_scale=2.0, timesteps=2, max_text_len=8)\n"
        "assert torch.isfinite(px).all()\n"
        "import numpy as np, dataclasses\n"
        "from unigen_tpu_torch.ops.int4 import quantize_unigen_params_int4\n"
        "v = build_pipeline('tiny', device='cpu', vision=True)\n"
        "q = quantize_unigen_params_int4(v.params, v.cfg, group=32)\n"
        "v = dataclasses.replace(v, params=q)\n"
        "toks = v.understand(np.zeros((1, 28, 28, 3), np.uint8), ['what?'], None,\n"
        "                    max_new_tokens=3)\n"
        "assert toks.shape == (1, 3)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib'))\n"
        "       or m == 'unigen_tpu' or m.startswith('unigen_tpu.')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("banned", ["jax", "jaxlib", "unigen_tpu", "yaml", "PIL",
                                    "safetensors", "transformers", "omegaconf", "ml_dtypes"])
def test_no_banned_imports_in_package_or_chip_smoke(banned):
    files = sorted((ROOT / "unigen_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    for f in files:
        for mod in _imports(f):
            assert mod.split(".")[0] != banned, f"{f.relative_to(ROOT)} imports {mod}"
