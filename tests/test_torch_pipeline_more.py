"""The tokenizer-encode slice of the port against the JAX package, fp32 on the CPU.

The tiny pipeline of tests/test_pipeline.py (tiny Qwen2, an 8 px MAGViTv2
with 16 codes of 5 bits, the tiny SigLIP tower), its JAX init carried
across by ``weights.py``, the same mock tokenizer on both sides:

* ``mmu`` prompts, and ``mmu_attn_meta`` against JAX's dense mmu mask;
* ``understand_discrete`` tokens exact, greedy and under shared noise;
* ``t2i_generate_ar`` tokens exact under shared noise and against JAX's
  full re-forward greedy loop; ``generate_images(mode="ar")`` codes exact;
* ``score_continuation(s)`` within 1e-5 relative, greedy flags equal, the
  batched call equal to one request at a time;
* ``evaluation.geneval``: the layout of JAX's ``run_geneval``, PNG bytes that
  decode back (by zlib and by PIL), the same bytes from the same seed;
* the slice's entry points in a process that imports no JAX, and
  ``python -m unigen_tpu_torch.evaluation.geneval`` raising without a card.
"""
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unigen_tpu.evaluation.geneval import run_geneval as j_run_geneval
from unigen_tpu.generation import mmu_generate as j_mmu_generate
from unigen_tpu.generation import t2i_generate_ar as j_t2i_ar
from unigen_tpu.models import magvit as JMV
from unigen_tpu.models import qwen2 as JQ
from unigen_tpu.models import siglip as JS
from unigen_tpu.models import unigen as JU
from unigen_tpu.ops import masks as JM
from unigen_tpu.pipeline import UniGenPipeline as JPipeline
from unigen_tpu.prompting import UniPrompting as JPrompting
from unigen_tpu_torch import weights as W
from unigen_tpu_torch.evaluation import geneval as G
from unigen_tpu_torch.generation import t2i_generate_ar as t_t2i_ar
from unigen_tpu_torch.models import magvit as TMV
from unigen_tpu_torch.models import siglip as TS
from unigen_tpu_torch.models import unigen as TU
from unigen_tpu_torch.ops import masks as TM
from unigen_tpu_torch.pipeline import UniGenPipeline as TPipeline
from unigen_tpu_torch.pipeline import pixels_to_uint8
from unigen_tpu_torch.prompting import IGNORE_ID
from unigen_tpu_torch.prompting import UniPrompting as TPrompting

from test_pipeline import DecodableMockTokenizer
from test_prompting import MockTokenizer, SPECIALS

ROOT = pathlib.Path(__file__).resolve().parent.parent
QUESTIONS = ["is there a cat?", "what color is the large bus on the [PAD] left?"]
PROMPTS = ["a red cat", "two dogs on a walk"]


def _tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def pipes():
    tok = DecodableMockTokenizer()
    jprompt = JPrompting(tok, special_tokens=SPECIALS, max_seq_len=64, cond_dropout_prob=0.0)
    cfg_kw = dict(text_vocab_len=len(tok), w_und_encoder=True, mm_input_dim=32)
    jcfg, tcfg = JU.UniGenConfig.tiny(**cfg_kw), TU.UniGenConfig.tiny(**cfg_kw)
    jvs, tvs = (JS.SiglipConfig.tiny(image_size=28, patch_size=14, hidden_size=32),
                TS.SiglipConfig.tiny(image_size=28, patch_size=14, hidden_size=32))
    jvq, tvq = (JMV.MagvitConfig.tiny(resolution=8, z_channels=5),
                TMV.MagvitConfig.tiny(resolution=8, z_channels=5))
    params = JU.init(jax.random.key(0), jcfg)
    vq_params = JMV.init(jax.random.key(1), jvq)
    vs_params = JS.init(jax.random.key(2), jvs)
    jpipe = JPipeline(params, jcfg, vq_params, jvq, jprompt, vision_params=vs_params,
                      vision_cfg=jvs)
    tpipe = TPipeline(W.unigen_from_jax(_tree(params), tcfg), tcfg,
                      W.magvit_from_jax(_tree(vq_params), tvq), tvq,
                      TPrompting(DecodableMockTokenizer(), special_tokens=SPECIALS,
                                 max_seq_len=64),
                      torch.device("cpu"),
                      vision_params=W.siglip_from_jax(_tree(vs_params), tvs), vision_cfg=tvs)
    return jpipe, tpipe


def _pixels(seed=1, b=2, res=8):
    return np.random.default_rng(seed).uniform(-1, 1, size=(b, res, res, 3)).astype(np.float32)


# --------------------------------------------------------------------- mmu --

def test_mmu_prompt_matches_jax():
    ours = TPrompting(MockTokenizer(), special_tokens=SPECIALS, max_seq_len=64)
    ref = JPrompting(MockTokenizer(), special_tokens=SPECIALS, max_seq_len=64,
                     cond_dropout_prob=0.0)
    texts = ["a cat", "", "x" * 60, "what is [PAD] this?"]     # one cut to fit, one with a pad id
    img = np.random.default_rng(0).integers(700, 732, size=(len(texts), 16))
    got, want = ours((img, texts), "mmu"), ref((img, texts), "mmu")
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    ids, att, labels = got
    assert ids.shape == (4, 64) and att[2].all()
    assert (labels[:, :16 + 4] == IGNORE_ID).all()


def test_mmu_attn_meta_matches_dense_mask():
    """On every query row, including the rows past each prompt (which see
    nothing in both), the metadata's visibility equals JAX's dense
    ``create_attention_mask_for_mmu & keep``; pads come from the prompt
    length, not from the pad id, which the last prompt holds inside its text."""
    prompting = TPrompting(MockTokenizer(), special_tokens=SPECIALS, max_seq_len=64)
    texts = ["a cat", "how many dogs are there?", "x" * 60, "what is [PAD] this?"]
    img = np.random.default_rng(0).integers(700, 732, size=(len(texts), 16))
    ids, att, _ = prompting((img, texts), "mmu")
    assert (ids[3, :att[3].sum()] == prompting.pad_id).any()
    eoi = prompting.sptids_dict["<|eoi|>"]
    prompt_len = att.sum(axis=1)
    got = TM.mmu_attn_meta(torch.from_numpy(ids), eoi, torch.from_numpy(prompt_len))
    keep = jnp.arange(ids.shape[1])[None] < jnp.asarray(prompt_len)[:, None]
    dense = (JM.create_attention_mask_for_mmu(jnp.asarray(ids), eoi_id=eoi)
             & keep[:, None, None, :] & keep[:, None, :, None])
    np.testing.assert_array_equal(got.visibility().numpy(), np.asarray(dense))
    bits = TM.pack_meta(got)
    assert torch.equal(TM.unpack_meta(bits).bidir_k, got.bidir_k)


def test_encode_pixels_matches_jax(pipes):
    jpipe, tpipe = pipes
    px = _pixels()
    want = np.asarray(jpipe.encode_pixels(jnp.asarray(px)))
    got = tpipe.encode_pixels(px)
    assert got.shape == (2, tpipe.cfg.num_vq_tokens)
    np.testing.assert_array_equal(got.numpy(), want)


def test_encode_pixels_runs_in_the_pixels_dtype(pipes, monkeypatch):
    """With bf16 tokenizer weights, fp32 pixels run the encoder in fp32, as
    JAX's ``conv2d`` casts each kernel to the activations' dtype: the codes
    equal JAX's on the same bf16 tree, and the encoder sees fp32 input.
    float64 pixels run as float32 (JAX's default)."""
    jpipe, tpipe = pipes
    jvq = JMV.MagvitConfig.tiny(resolution=8, z_channels=5, dtype=jnp.bfloat16)
    tvq = TMV.MagvitConfig.tiny(resolution=8, z_channels=5, dtype=torch.bfloat16)
    vq_params = JMV.init(jax.random.key(1), jvq)
    tq = W.magvit_from_jax(_tree(vq_params), tvq)
    assert tq["encoder"]["conv_in"]["kernel"].dtype == torch.bfloat16
    tp = TPipeline(tpipe.params, tpipe.cfg, tq, tvq, tpipe.prompting, torch.device("cpu"))
    px = _pixels(seed=4)
    want = np.asarray(JMV.get_code(vq_params, jvq, jnp.asarray(px)))
    seen = []
    real = TMV.get_code

    def spy(params, cfg, x):
        seen.append(x.dtype)
        return real(params, cfg, x)
    monkeypatch.setattr(TMV, "get_code", spy)
    np.testing.assert_array_equal(tp.encode_pixels(px).numpy(), want)
    np.testing.assert_array_equal(tp.encode_pixels(px.astype(np.float64)).numpy(), want)
    assert seen == [torch.float32, torch.float32]


def test_understand_discrete_greedy_exact(pipes):
    jpipe, tpipe = pipes
    px = _pixels()
    want = np.asarray(jpipe.understand_discrete(jnp.asarray(px), QUESTIONS, jax.random.key(0),
                                                max_new_tokens=6))
    got = tpipe.understand_discrete(px, QUESTIONS, None, max_new_tokens=6)
    assert got.shape == (2, 6)
    np.testing.assert_array_equal(got.numpy(), want)


def test_understand_discrete_shared_noise_exact(pipes):
    """Sampled at temperature 0.9 from the same uniforms: the JAX side is
    ``_mmu_decode``'s construction with the noise hook of ``mmu_generate``."""
    jpipe, tpipe = pipes
    px = _pixels(seed=3)
    new = 6
    noise = np.random.default_rng(4).random((new, 2, jpipe.cfg.llm.vocab_size),
                                            dtype=np.float32)
    codes = np.asarray(jpipe.encode_pixels(jnp.asarray(px))) + jpipe.cfg.text_vocab_len
    ids, att, _ = jpipe.prompting((codes, QUESTIONS), "mmu")
    prompt_len = jnp.asarray(att.sum(axis=1))
    keep = jnp.arange(ids.shape[1])[None] < prompt_len[:, None]
    mask = (JM.create_attention_mask_for_mmu(jnp.asarray(ids),
                                             eoi_id=jpipe.prompting.sptids_dict["<|eoi|>"])
            & keep[:, None, None, :] & keep[:, None, :, None])
    want = j_mmu_generate(jpipe.params, jpipe.cfg, jax.random.key(0), input_ids=jnp.asarray(ids),
                          attention_mask=mask, prompt_len=prompt_len, max_new_tokens=new,
                          temperature=0.9, eot_token=jpipe.prompting.eos_token_id,
                          noise=jnp.asarray(noise))
    got = tpipe.understand_discrete(px, QUESTIONS, None, max_new_tokens=new, temperature=0.9,
                                    noise=torch.from_numpy(noise))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------- ar --

def _ar_prompts(cfg, b=2, seed=11):
    """[pad pad][text x 6][soi][mask x N][eoi], ragged left padding."""
    rng = np.random.default_rng(seed)
    n = cfg.num_vq_tokens
    text = rng.integers(3, 100, size=(b, 6))
    ids = np.concatenate([np.zeros((b, 2), np.int64), text, np.full((b, 1), 1),
                          np.full((b, n), cfg.mask_token_id), np.full((b, 1), 2)], axis=1)
    ids[1, 2] = 0
    uncond = np.roll(ids, 1, axis=0)
    uncond[:, 2:6] = 0
    return ids, uncond


@pytest.mark.parametrize("guidance", [0.0, 2.0])
def test_t2i_generate_ar_shared_noise_exact(pipes, guidance):
    jpipe, tpipe = pipes
    cfg = jpipe.cfg
    ids, uncond = _ar_prompts(cfg)
    att = (np.concatenate([ids, uncond]) != 0).astype(np.int32)
    noise = np.random.default_rng(5).random((cfg.num_vq_tokens, 2, cfg.codebook_size),
                                            dtype=np.float32)
    want = j_t2i_ar(jpipe.params, cfg, jax.random.key(0), jnp.asarray(ids), jnp.asarray(uncond),
                    jnp.asarray(att), guidance_scale=guidance, temperature=1.0,
                    noise=jnp.asarray(noise))
    got = t_t2i_ar(tpipe.params, tpipe.cfg, None, torch.from_numpy(ids),
                   torch.from_numpy(uncond), torch.from_numpy(att), guidance_scale=guidance,
                   temperature=1.0, noise=torch.from_numpy(noise))
    assert got.shape == (2, cfg.num_vq_tokens)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_t2i_generate_ar_matches_jax_naive_greedy(pipes):
    """Near-zero temperature with the KV cache == JAX's full re-forward
    argmax loop (tests/test_generation.py::test_t2i_generate_ar_matches_naive_greedy)."""
    jpipe, tpipe = pipes
    cfg, params = jpipe.cfg, jpipe.params
    b, n, g = 2, cfg.num_vq_tokens, 1.5
    ids, _ = _ar_prompts(cfg)
    ids[:, :3] = 7                                        # no padding: the naive loop has none
    uncond = np.roll(ids, 1, axis=0)
    prompt = jnp.asarray(np.concatenate([ids[:, :-(n + 1)], uncond[:, :-(n + 1)]]))
    w = JQ.lm_head_weight(params["llm"], cfg.llm)[:, cfg.text_vocab_len:
                                                  cfg.text_vocab_len + cfg.codebook_size]
    toks, cur = [], prompt
    for _ in range(n):
        hidden, _ = JQ.forward(params["llm"], cfg.llm, inputs_embeds=JU.embed_tokens(params, cur))
        logits = (hidden[:, -1] @ w).astype(jnp.float32)
        logits = logits[b:] + g * (logits[:b] - logits[b:])
        nxt = jnp.argmax(logits, axis=-1)
        toks.append(nxt)
        cur = jnp.concatenate([cur, jnp.concatenate([nxt, nxt])[:, None] + cfg.text_vocab_len],
                              axis=1)
    naive = np.asarray(jnp.stack(toks, axis=1))
    got = t_t2i_ar(tpipe.params, tpipe.cfg, torch.Generator().manual_seed(0),
                   torch.from_numpy(ids), torch.from_numpy(uncond),
                   torch.ones((2 * b, ids.shape[1]), dtype=torch.int32), guidance_scale=g,
                   temperature=1e-5)
    np.testing.assert_array_equal(got.numpy(), naive)


def test_generate_images_ar_codes_exact(pipes):
    """The pipeline's prompts (left-padded to the longer prompt) and the AR
    sampler at near-zero temperature: the same codes as JAX's pipeline."""
    jpipe, tpipe = pipes
    kw = dict(guidance_scale=3.0, temperature=1e-5, max_text_len=12, mode="ar",
              return_codes=True)
    want = np.asarray(jpipe.generate_images(PROMPTS, jax.random.key(0), **kw))
    got = tpipe.generate_images(PROMPTS, torch.Generator().manual_seed(0), **kw)
    np.testing.assert_array_equal(got.numpy(), want)
    pixels = tpipe.generate_images(PROMPTS, torch.Generator().manual_seed(0),
                                   **dict(kw, return_codes=False))
    assert pixels.shape == (2, 8, 8, 3) and torch.isfinite(pixels).all()


def test_generate_images_rejects_unknown_mode(pipes):
    with pytest.raises(ValueError, match="mode"):
        pipes[1].generate_images(["x"], None, mode="diffusion")


# ----------------------------------------------------------------- scoring --

def _score_inputs(tpipe):
    rng = np.random.default_rng(8)
    px = rng.integers(0, 256, size=(3, 28, 28, 3), dtype=np.uint8)
    qs = ["what is this?", "is the long object on the left red or blue?", "how many?"]
    greedy = tpipe.understand(px[:1], qs[:1], None, max_new_tokens=3)[0].numpy()
    conts = [greedy, rng.integers(40, 120, size=9), rng.integers(40, 120, size=1)]
    return px, qs, conts


def test_score_continuations_match_jax(pipes):
    jpipe, tpipe = pipes
    px, qs, conts = _score_inputs(tpipe)
    want = jpipe.score_continuations(jnp.asarray(px), qs, conts, length_bucket=16)
    got = tpipe.score_continuations(px, qs, conts, length_bucket=16)
    assert got[0][1] and not got[1][1]                   # the model's own greedy tokens
    for (lp, g), (lp_j, g_j) in zip(got, want):
        assert g == g_j
        np.testing.assert_allclose(lp, lp_j, rtol=1e-5)
        assert np.isfinite(lp) and lp < 0


def test_score_continuation_batched_equals_single(pipes):
    """One request at a time (other buckets, no batch padding) gives the
    batched call's values, and the JAX single-request call's."""
    jpipe, tpipe = pipes
    px, qs, conts = _score_inputs(tpipe)
    batched = tpipe.score_continuations(px, qs, conts, length_bucket=64)
    for i in range(3):
        lp, g = tpipe.score_continuation(px[i:i + 1], qs[i], conts[i], length_bucket=8)
        lp_j, g_j = jpipe.score_continuation(jnp.asarray(px[i:i + 1]), qs[i], conts[i],
                                             length_bucket=8)
        assert g == batched[i][1] == g_j
        np.testing.assert_allclose(lp, batched[i][0], rtol=1e-5)
        np.testing.assert_allclose(lp, lp_j, rtol=1e-5)


def test_score_ignores_non_finite_pad_rows(pipes, monkeypatch):
    """A pad query row that comes out non-finite changes neither the sum nor
    the greedy flag (``torch.where``, not a product with a 0/1 mask)."""
    from unigen_tpu_torch import pipeline as P
    _, tpipe = pipes
    px, qs, conts = _score_inputs(tpipe)
    want = tpipe.score_continuations(px, qs, conts, length_bucket=64)
    real = P.qwen2.forward

    def poisoned(*a, **kw):
        hidden, cache = real(*a, **kw)
        pad = TM.unpack_meta(kw["meta_bits"]).pad
        return torch.where(pad[..., None], float("nan"), hidden), cache
    monkeypatch.setattr(P.qwen2, "forward", poisoned)
    got = tpipe.score_continuations(px, qs, conts, length_bucket=64)
    assert got == want


# ----------------------------------------------------------------- geneval --

MD = [{"prompt": "a red cat"}, {"prompt": "two dogs"}, {"text": "a blue car"}]


def _files(root):
    return sorted(str(p.relative_to(root)) for p in pathlib.Path(root).rglob("*") if p.is_file())


def test_run_geneval_layout_matches_jax(pipes, tmp_path):
    jpipe, tpipe = pipes
    kw = dict(n_samples=2, guidance_scale=2.0, timesteps=2, eval_text_len=6,
              process_index=0, process_count=1)
    want = j_run_geneval(jpipe, MD, str(tmp_path / "jax"), jax.random.key(0), **kw)
    got = G.run_geneval(tpipe, MD, str(tmp_path / "torch"), torch.Generator().manual_seed(0),
                        **kw)
    assert [os.path.relpath(p, tmp_path / "torch") for p in got] == \
        [os.path.relpath(p, tmp_path / "jax") for p in want]
    assert _files(tmp_path / "torch") == _files(tmp_path / "jax")
    for d in ("00000", "00002"):
        assert G.load_metadata_jsonl(str(tmp_path / "torch" / d / "metadata.jsonl")) == \
            G.load_metadata_jsonl(str(tmp_path / "jax" / d / "metadata.jsonl"))
    img = G.load_png(str(tmp_path / "torch" / "00001" / "samples" / "00001.png"))
    assert img.shape == (8, 8, 3) and img.dtype == np.uint8
    # sharding: rank 1 of 2 writes the second prompt only
    w1 = G.run_geneval(tpipe, MD, str(tmp_path / "shard"), None, **dict(
        kw, n_samples=1, process_index=1, process_count=2))
    assert [os.path.basename(p) for p in w1] == ["00001"]


def test_run_geneval_pngs_are_the_batch_pixels(pipes, tmp_path):
    """Each PNG decodes back to ``pixels_to_uint8`` of its prompt's batch,
    which the same generator seed reproduces; ``mode="ar"`` writes too."""
    _, tpipe = pipes
    kw = dict(guidance_scale=2.0, timesteps=2, max_text_len=6)
    out = G.run_geneval(tpipe, MD[:2], str(tmp_path), torch.Generator().manual_seed(3),
                        n_samples=2, guidance_scale=2.0, timesteps=2, eval_text_len=6)
    gen = torch.Generator().manual_seed(3)
    for d, md in zip(out, MD[:2]):
        want = pixels_to_uint8(tpipe.generate_images([md["prompt"]] * 2, gen, **kw))
        for i in range(2):
            np.testing.assert_array_equal(G.load_png(os.path.join(d, "samples", f"{i:05}.png")),
                                          want[i])
    ar = G.run_geneval(tpipe, MD[:1], str(tmp_path / "ar"), None, n_samples=1, mode="ar",
                       guidance_scale=2.0, eval_text_len=6)
    assert G.load_png(os.path.join(ar[0], "samples", "00000.png")).shape == (8, 8, 3)


def test_same_seed_same_png_bytes(pipes, tmp_path):
    _, tpipe = pipes

    def run(seed, name):
        G.run_geneval(tpipe, MD[:2], str(tmp_path / name), torch.Generator().manual_seed(seed),
                      n_samples=2, guidance_scale=2.0, timesteps=2, eval_text_len=6)
        return {f: (tmp_path / name / f).read_bytes() for f in _files(tmp_path / name)}
    a, b, c = run(5, "a"), run(5, "b"), run(6, "c")
    assert a == b
    assert a != c


@pytest.mark.parametrize("shape", [(8, 8, 3), (5, 7, 3), (1, 1, 3)])
def test_png_round_trip(tmp_path, shape):
    img = np.random.default_rng(9).integers(0, 256, size=shape, dtype=np.uint8)
    path = str(tmp_path / "x.png")
    G.save_png(img, path)
    np.testing.assert_array_equal(G.load_png(path), img)
    Image = pytest.importorskip("PIL.Image")
    with Image.open(path) as im:
        assert im.mode == "RGB"
        np.testing.assert_array_equal(np.asarray(im), img)


def test_png_rejects_other_layouts(tmp_path):
    with pytest.raises(ValueError):
        G.png_bytes(np.zeros((4, 4), np.uint8))
    with pytest.raises(ValueError):
        G.png_bytes(np.zeros((4, 4, 3), np.float32))
    Image = pytest.importorskip("PIL.Image")
    path = str(tmp_path / "gray.png")
    Image.fromarray(np.zeros((4, 4), np.uint8)).save(path)
    with pytest.raises(ValueError):
        G.load_png(path)


def test_shard_for_process_defaults_to_one_process():
    assert G.shard_for_process(range(5)) == [0, 1, 2, 3, 4]
    assert G.shard_for_process(range(5), 1, 2) == [1, 3]


def test_geneval_main_raises_without_cuda(monkeypatch, tmp_path):
    md = tmp_path / "md.jsonl"
    md.write_text('{"prompt": "a cat"}\n')
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        G.main(["--metadata-file", str(md), "--output-dir", str(tmp_path / "out"),
                "--model", "tiny"])


def test_slice_runs_without_jax_in_a_subprocess(tmp_path):
    """encode_pixels, understand_discrete, mode="ar", the scoring calls and the
    geneval module on the tiny CPU pipeline, in a process without JAX."""
    md = tmp_path / "md.jsonl"
    md.write_text('{"prompt": "a cat"}\n{"prompt": "a dog"}\n')
    code = (
        "import sys, numpy as np, torch\n"
        "from unigen_tpu_torch.launch import build_pipeline\n"
        "from unigen_tpu_torch.evaluation import geneval\n"
        "p = build_pipeline('tiny', device='cpu', vision=True)\n"
        "px = np.zeros((1, 8, 8, 3), np.float32)\n"
        "assert p.encode_pixels(px).shape == (1, 16)\n"
        "assert p.understand_discrete(px, ['what?'], None, max_new_tokens=3).shape == (1, 3)\n"
        "c = p.generate_images(['a cat'], None, mode='ar', return_codes=True)\n"
        "assert c.shape == (1, 16)\n"
        "img = np.zeros((1, 28, 28, 3), np.uint8)\n"
        "lp, g = p.score_continuation(img, 'what?', np.array([65, 66]))\n"
        "assert np.isfinite(lp)\n"
        f"w = geneval.main(['--metadata-file', {str(md)!r}, '--output-dir', "
        f"{str(tmp_path / 'out')!r}, '--model', 'tiny', '--device', 'cpu', "
        "'--n-samples', '1', '--steps', '2', '--mode', 'ar'])\n"
        "assert len(w) == 2\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib'))\n"
        "       or m == 'unigen_tpu' or m.startswith('unigen_tpu.')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")
    assert (tmp_path / "out" / "00001" / "samples" / "00000.png").exists()
