"""CoT-V Best-of-N of the port against the JAX package, fp32 on the CPU.

The tiny pipeline pair of tests/test_torch_pipeline_more.py (the same
weights and mock tokenizer on both sides):

* the host parts (parsers, ``geneval_prompt2questions``,
  ``greedy_samples_byscore``) equal JAX's on one table of cases;
* ``rate_candidates`` on shared candidates: rows equal to JAX's, for the
  discrete and the vision rater, in the rule, outcome and think styles;
* the rater's resize against ``jax.image.resize`` within 1e-6;
* ``run_cot`` with both pipelines' ``generate_images`` fed the same
  candidates: rating table, stats and selections equal to JAX's, also with
  a question map; the vision rater's questions are not templated twice;
* a sharded run equals the single-process run (generators derived from the
  global prompt index), also when two processes of a gloo group gather
  their tables;
* ``python -m unigen_tpu_torch.evaluation.cot`` writes the layout of
  ``scripts/inference_cot.py`` and raises without a card.
"""
import dataclasses
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unigen_tpu.evaluation import cot as JCOT
from unigen_tpu_torch.evaluation import cot as COT
from unigen_tpu_torch.ops.sampling import derived_generator

from test_torch_pipeline_more import pipes  # noqa: F401  (the shared fixture)

ROOT = pathlib.Path(__file__).resolve().parent.parent
TWO_COLOUR = "a photo of a red cube and a blue sphere"

_TABLE = [
    {"image_id": "a/samples/00000.png", "question": "q1", "answer": "yes"},
    {"image_id": "a/samples/00000.png", "question": "q2", "answer": "no"},
    {"image_id": "a/samples/00001.png", "question": "q1", "answer": "yes"},
    {"image_id": "a/samples/00001.png", "question": "q2", "answer": "yes"},
    {"image_id": "b/samples/00000.png", "question": "q1", "answer": "no"},
    {"image_id": "b/samples/00001.png", "question": "q1", "answer": "no"},
    {"image_id": "b/samples/00002.png", "question": "q1", "answer": "yes"},
]

HOST_CASES = [
    ("parse_yesno", (" Yes, it is",)), ("parse_yesno", ("No.",)), ("parse_yesno", ("maybe",)),
    ("parse_yesno", ("yesterday",)), ("parse_yesno", ("",)),
    ("parse_qa_pairs", ("<think_start>Is there a cat? yes; Is it red? no<think_end>",)),
    ("parse_qa_pairs", ("Is there a cat? YES. is it big? No <answer_start>No<answer_end>",)),
    ("parse_qa_pairs", ("garbage",)),
    ("parse_qa_pairs", ("<think_start>no question here<think_end>",)),
    ("geneval_prompt2questions", ("a photo of a purple tennis racket and a black sink",)),
    ("geneval_prompt2questions", (TWO_COLOUR,)),
    ("geneval_prompt2questions", ("a photo of a cat above a table",)),
    ("geneval_prompt2questions", ("a photo of an apple right of a bowl",)),
    ("geneval_prompt2questions", ("a photo of four dogs",)),
    ("geneval_prompt2questions", ("a photo of a cup",)),
    ("geneval_prompt2questions", ("a photo of a hair drier and a cake",)),
    ("geneval_prompt2questions", ("a photo of a blue rubbish bin",)),
    ("geneval_prompt2questions", ("  A Photo of An Orange Elephant ",)),
    ("geneval_prompt2questions", ("two dogs playing in the snow",)),
    ("geneval_prompt2questions", ("a bowl of ramen with chopsticks",)),
    ("greedy_samples_byscore", (_TABLE, 1)),
    ("greedy_samples_byscore", (_TABLE, 2)),
    ("greedy_samples_byscore", ([], 4)),
]


@pytest.mark.parametrize("name,args", HOST_CASES,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(HOST_CASES)])
def test_host_parts_match_jax(name, args):
    assert getattr(COT, name)(*args) == getattr(JCOT, name)(*args)


def test_protocol_strings_match_jax():
    assert COT.QWEN_TEMPLATE == JCOT.QWEN_TEMPLATE
    assert COT.QWEN_SYSTEM_PROMPT == JCOT.QWEN_SYSTEM_PROMPT
    assert COT.MMU_RATING_USER_PROMPT == JCOT.MMU_RATING_USER_PROMPT


def test_derived_generator_is_a_function_of_seed_and_index():
    """The same (seed, index) draws the same numbers whatever was drawn
    before; another index or seed draws others."""
    def draw(*key):
        return torch.rand(8, generator=derived_generator(*key))
    first = draw(0, 3, COT.GEN_STREAM)
    torch.rand(100, generator=derived_generator(0, 1, COT.GEN_STREAM))
    assert torch.equal(draw(0, 3, COT.GEN_STREAM), first)
    others = [draw(0, 3, COT.RATE_STREAM), draw(0, 4, COT.GEN_STREAM), draw(1, 3, COT.GEN_STREAM)]
    assert not any(torch.equal(o, first) for o in others)


@pytest.mark.parametrize("a, b", [((2 ** 32,), (0, 1)), ((2 ** 32, 5), (0, 1, 5)), ((7,), (7, 0)),
                                  ((1, 2 ** 32), (1, 0, 1)), ((0, 0), (0,))])
def test_derived_generator_keys_never_collide(a, b):
    """Keys that numpy's SeedSequence would pool to the same words (a large
    seed or index split into 32-bit words, a trailing 0) draw apart."""
    assert not torch.equal(torch.rand(8, generator=derived_generator(*a)),
                           torch.rand(8, generator=derived_generator(*b)))


@pytest.mark.parametrize("key", [(-1,), (2 ** 64,), (0, -3), (0, 2 ** 64)])
def test_derived_generator_rejects_values_outside_64_bits(key):
    with pytest.raises(ValueError, match="2\\*\\*64"):
        derived_generator(*key)


def _candidates(seed, n=3, res=8):
    return np.random.default_rng(seed).uniform(-1, 1, (n, res, res, 3)).astype(np.float32)


@pytest.mark.parametrize("style", ["rule", "outcome", "think"])
@pytest.mark.parametrize("vision", [False, True], ids=["discrete", "vision"])
def test_rate_candidates_match_jax(pipes, vision, style):  # noqa: F811
    jpipe, tpipe = pipes
    px = _candidates(21)
    kw = dict(style=style, max_new_tokens=3, use_vision_tower=vision, instance_id="00007")
    want = JCOT.rate_candidates(jpipe, jnp.asarray(px), TWO_COLOUR, jax.random.key(0), **kw)
    got = COT.rate_candidates(tpipe, px, TWO_COLOUR, None, **kw)
    n_questions = 4 if style == "rule" else 1
    assert len(got) >= n_questions * len(px)
    assert got == want


@pytest.mark.parametrize("src,size", [(8, 28), (256, 384), (5, 7)])
def test_resize_matches_jax_image_resize(src, size):
    px = _candidates(22, n=2, res=src)
    want = np.asarray(jax.image.resize(jnp.asarray(px), (2, size, size, 3), "bilinear"))
    got = COT.resize_bilinear(torch.from_numpy(px), size)
    assert got.shape == (2, size, size, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="upsamples"):
        COT.resize_bilinear(torch.from_numpy(px), src - 1)


PROMPTS = [TWO_COLOUR, "a photo of a cup", "a strange prompt"]


def _fed(pipe, to_array, n):
    """A copy of ``pipe`` whose ``generate_images`` returns fixed candidates
    for each prompt (seeded by its position in PROMPTS) and records its
    keyword arguments."""
    fed = dataclasses.replace(pipe)
    calls = []

    def generate_images(prompts, key, **kw):
        assert len(set(prompts)) == 1 and len(prompts) == n
        calls.append(kw)
        return to_array(_candidates(30 + PROMPTS.index(prompts[0]), n=n))
    fed.generate_images = generate_images
    return fed, calls


def _run_both(pipes, **kw):  # noqa: F811
    jpipe, tpipe = pipes
    n = kw["n_samples"]
    jfed, jcalls = _fed(jpipe, jnp.asarray, n)
    tfed, tcalls = _fed(tpipe, torch.from_numpy, n)
    want = JCOT.run_cot(jfed, PROMPTS, jax.random.key(0), **kw)
    got = COT.run_cot(tfed, PROMPTS, 0, **kw)
    assert tcalls == jcalls and len(tcalls) == len(PROMPTS)
    return got, want


def _assert_same_cot(got, want):
    (res, table, stats), (jres, jtable, jstats) = got, want
    assert table == jtable
    assert stats == jstats
    assert len(res) == len(jres)
    for r, j in zip(res, jres):
        assert (r["prompt"], r["index"]) == (j["prompt"], j["index"])
        assert r["ratings"] == j["ratings"] and r["stats"] == j["stats"]
        assert r["candidates"].dtype == np.uint8
        np.testing.assert_array_equal(r["candidates"], j["candidates"])
        np.testing.assert_array_equal(r["selected"], j["selected"])


@pytest.mark.parametrize("vision", [False, True], ids=["discrete", "vision"])
def test_run_cot_matches_jax(pipes, vision):  # noqa: F811
    kw = dict(n_samples=3, topk=2, guidance_scale=2.0, timesteps=2, eval_text_len=8,
              style="rule", max_new_tokens=3, use_vision_tower=vision)
    got, want = _run_both(pipes, **kw)
    _assert_same_cot(got, want)
    res, table, stats = got
    # questions: 4 (two colours), 1 (one object), 1 (no family: the prompt itself)
    assert len(table) == (4 + 1 + 1) * 3 and len(stats) == 3 * len(PROMPTS)
    assert all(r["selected"].shape == (2, 8, 8, 3) for r in res)


def test_run_cot_with_questions_map_matches_jax(pipes):  # noqa: F811
    qmap = {"a strange prompt": ["Is there a cup?", "Is it blue?"],
            TWO_COLOUR: ["Is there a cube?"]}
    kw = dict(n_samples=2, topk=1, guidance_scale=0.0, timesteps=1, eval_text_len=6,
              style="rule", max_new_tokens=2, questions_map=qmap)
    got, want = _run_both(pipes, **kw)
    _assert_same_cot(got, want)
    assert len(got[1]) == (1 + 1 + 2) * 2


def test_vision_rater_not_double_templated(pipes, monkeypatch):  # noqa: F811
    """``understand`` applies the chat template itself: the vision rater
    hands it the raw user prompts, with the Qwen system prompt's ids."""
    _, tpipe = pipes
    seen = []
    real = type(tpipe).understand

    def spy(self, pixels, questions, generator, **kw):
        seen.append((list(questions), kw["system_prompt_ids"]))
        return real(self, pixels, questions, generator, **kw)
    monkeypatch.setattr(type(tpipe), "understand", spy)
    res, _, _ = COT.run_cot(tpipe, ["a photo of a cup"], 3, n_samples=2, topk=1,
                            guidance_scale=0.0, timesteps=1, eval_text_len=6, style="rule",
                            max_new_tokens=2, use_vision_tower=True)
    assert seen, "the vision rater never called understand()"
    sys_ids = np.asarray([tpipe.prompting._tokenize(COT.QWEN_SYSTEM_PROMPT)[0]])
    for questions, ids in seen:
        assert questions == ["Is there a cup?  Please answer yes or no."] * 2
        np.testing.assert_array_equal(ids, sys_ids)
    assert len(res[0]["ratings"]) == 2


def test_run_cot_sharded_matches_single_process(pipes):  # noqa: F811
    """Two shards (gather=False), merged, equal the single-process run: each
    prompt's generators come from its global index."""
    _, tpipe = pipes
    prompts = ["a photo of a cup", "a photo of a dog", "a photo of a red cat"]
    kw = dict(n_samples=2, topk=1, guidance_scale=2.0, timesteps=2, eval_text_len=6,
              style="rule", max_new_tokens=2)
    res1, table1, _ = COT.run_cot(tpipe, prompts, 5, **kw)
    res_a, table_a, _ = COT.run_cot(tpipe, prompts, 5, process_index=0, process_count=2,
                                    gather=False, **kw)
    res_b, table_b, _ = COT.run_cot(tpipe, prompts, 5, process_index=1, process_count=2,
                                    gather=False, **kw)
    assert [r["index"] for r in res_a] == [0, 2] and [r["index"] for r in res_b] == [1]
    key = lambda r: (r["image_id"], r["question"])  # noqa: E731
    assert sorted(table_a + table_b, key=key) == sorted(table1, key=key)
    by_idx = {r["index"]: r for r in res_a + res_b}
    for r in res1:
        np.testing.assert_array_equal(r["candidates"], by_idx[r["index"]]["candidates"])
    # a different seed samples other candidates
    res2, _, _ = COT.run_cot(tpipe, prompts[:1], 6, **kw)
    assert not np.array_equal(res2[0]["candidates"], res1[0]["candidates"])


_GATHER_WORKER = """
import json, sys, torch
from unigen_tpu_torch.evaluation import cot
from unigen_tpu_torch.launch import build_pipeline
rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
torch.distributed.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                                     world_size=2)
try:
    p = build_pipeline("tiny", device="cpu", seed=4)
    res, table, stats = cot.run_cot(p, json.loads(sys.argv[4]), 5, **json.loads(sys.argv[5]))
finally:
    torch.distributed.destroy_process_group()
with open(out, "w") as f:
    json.dump({"index": [r["index"] for r in res], "table": table, "stats": stats,
               "selected": [r["selected"].tolist() for r in res]}, f)
"""


def test_run_cot_gathers_over_a_process_group(tmp_path):
    """Two processes of a gloo group each rate their shard, gather the
    tables with ``all_gather_object`` and select: both hold the
    single-process table, stats and selections."""
    import json
    import socket
    import subprocess
    import sys
    from unigen_tpu_torch.launch import build_pipeline
    prompts = ["a photo of a cup", "a photo of a red cube and a blue sphere", "a photo of a dog"]
    kw = dict(n_samples=2, topk=1, guidance_scale=2.0, timesteps=2, eval_text_len=6,
              style="rule", max_new_tokens=2)
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    procs = [subprocess.Popen([sys.executable, "-c", _GATHER_WORKER, str(rank), str(port),
                               str(tmp_path / f"rank{rank}.json"), json.dumps(prompts),
                               json.dumps(kw)], cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for rank in (0, 1)]
    for proc in procs:
        _, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, err
    res1, table1, stats1 = COT.run_cot(build_pipeline("tiny", device="cpu", seed=4), prompts, 5,
                                       **kw)
    ranks = [json.loads((tmp_path / f"rank{rank}.json").read_text()) for rank in (0, 1)]
    assert [r["index"] for r in ranks] == [[0, 2], [1]]
    assert ranks[0]["table"] == ranks[1]["table"] and ranks[0]["stats"] == ranks[1]["stats"]
    key = lambda r: (r["image_id"], r["question"])  # noqa: E731
    assert sorted(ranks[0]["table"], key=key) == sorted(table1, key=key)
    assert sorted(ranks[0]["stats"], key=lambda s: s["image_id"]) == \
        sorted(stats1, key=lambda s: s["image_id"])
    for r, sel in zip(res1, (ranks[0]["selected"][0], ranks[1]["selected"][0],
                             ranks[0]["selected"][1])):
        np.testing.assert_array_equal(r["selected"], np.asarray(sel, np.uint8))


def _files(root):
    return sorted(str(p.relative_to(root)) for p in pathlib.Path(root).rglob("*") if p.is_file())


def _jsonl(path):
    from unigen_tpu_torch.evaluation.geneval import load_metadata_jsonl
    return load_metadata_jsonl(str(path))


def test_cot_main_writes_the_script_layout(pipes, tmp_path, monkeypatch):  # noqa: F811
    """``scripts/inference_cot.py`` (config overrides, the JAX tiny pipeline)
    and ``python -m unigen_tpu_torch.evaluation.cot --device cpu`` (the
    port's tiny pipeline) write the same files, rating rows with the same
    image ids and questions, and stats with the same keys."""
    from unigen_tpu import launch as jlaunch
    md = tmp_path / "md.jsonl"
    md.write_text('{"prompt": "a photo of a red cube and a blue sphere"}\n'
                  '{"prompt": "a photo of a cup", "tag": "single_object"}\n')
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text("model:\n  unigen:\n    w_und_encoder: false\n  max_new_tokens: 2\n"
                   "training:\n  guidance_scale: 2.0\n")
    spec = importlib.util.spec_from_file_location("inference_cot_script",
                                                  ROOT / "scripts" / "inference_cot.py")
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    monkeypatch.setattr(jlaunch, "build_pipeline", lambda config: pipes[0])
    monkeypatch.setattr("sys.argv", [
        "inference_cot.py", f"config={cfg}", f"inference.metadata_file={md}",
        f"inference.output_dir={tmp_path / 'jax'}", "inference.n_samples=3",
        "inference.topk=2", "inference.generation_timesteps=2", "inference.eval_text_len=8"])
    script.main()
    res, table, stats = COT.main([
        "--metadata-file", str(md), "--output-dir", str(tmp_path / "torch"), "--n-samples", "3",
        "--topk", "2", "--guidance-scale", "2", "--steps", "2", "--text-len", "8",
        "--max-new-tokens", "2", "--model", "tiny", "--device", "cpu"])
    assert _files(tmp_path / "torch") == _files(tmp_path / "jax")
    assert "t2i_samples_step2_scale2_selected_prompt_rule/00001/samples/00001.png" in \
        _files(tmp_path / "torch")
    for name in ("rating_table_rule.jsonl", "rating_stats_rule.jsonl"):
        got, want = _jsonl(tmp_path / "torch" / name), _jsonl(tmp_path / "jax" / name)
        assert len(got) == len(want) and [sorted(r) for r in got] == [sorted(r) for r in want]
    rows = _jsonl(tmp_path / "torch" / "rating_table_rule.jsonl")
    assert [(r["image_id"], r["question"]) for r in rows] == \
        [(r["image_id"], r["question"]) for r in _jsonl(tmp_path / "jax" / "rating_table_rule.jsonl")]
    assert rows == table and len(rows) == (4 + 1) * 3
    for d in ("t2i_samples_step2_scale2", "t2i_samples_step2_scale2_selected_prompt_rule"):
        assert _jsonl(tmp_path / "torch" / d / "00001" / "metadata.jsonl") == \
            [{"prompt": "a photo of a cup", "tag": "single_object"}]
    from unigen_tpu_torch.evaluation.geneval import load_png
    np.testing.assert_array_equal(
        load_png(str(tmp_path / "torch" / "t2i_samples_step2_scale2" / "00000" / "samples"
                     / "00002.png")), res[0]["candidates"][2])


def test_cot_main_raises_without_cuda(monkeypatch, tmp_path):
    md = tmp_path / "md.jsonl"
    md.write_text('{"prompt": "a cat"}\n')
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        COT.main(["--metadata-file", str(md), "--output-dir", str(tmp_path / "out"),
                  "--model", "tiny"])
