"""The port's microbatching image server and DPG-bench entry point.

* ``serving.ImageServingEngine`` on the tiny pipeline: a full microbatch
  equals the direct ``generate_images`` call under the batch's derived
  generator, a partial batch's rows are unchanged by the padding, successive
  batches draw distinct noise, failed and closed engines reject submissions
  (the checks of tests/test_image_serving.py). The same checks run on the
  card with ``-m cuda``, where the engine thread must also queue its kernels
  on the caller's stream. Every wait in these tests has a timeout.
* ``evaluation.dpg`` against the JAX package: ``make_grid_2x2``, the grids of
  ``run_dpg`` for the same candidates, and ``prepare_dpg_metadata`` byte for
  byte against ``scripts/prepare_dpg_metadata.py``.
* The CoT, DPG and serving modules in a process where ``jax`` cannot be
  imported.

JAX is imported inside the tests that compare against it, so the card's
run of this file (``--noconftest -m cuda``) needs none.
"""
import contextlib
import dataclasses
import importlib.util
import os
import pathlib
import subprocess
import sys
import threading
import time
import zlib

import numpy as np
import pytest
import torch

from unigen_tpu_torch.evaluation import dpg as DPG
from unigen_tpu_torch.evaluation.geneval import load_png
from unigen_tpu_torch.launch import build_pipeline
from unigen_tpu_torch.ops import _cuda
from unigen_tpu_torch.ops.sampling import derived_generator
from unigen_tpu_torch.pipeline import pixels_to_uint8
from unigen_tpu_torch.serving import ImageServingEngine

ROOT = pathlib.Path(__file__).resolve().parent.parent
PROTOCOL = dict(guidance_scale=2.0, timesteps=3, temperature=1.0, max_text_len=8)
WAIT_S = 120.0         # the longest any future or join may take in these tests

DEVICES = [pytest.param("cpu"), pytest.param("cuda", marks=pytest.mark.cuda)]


@pytest.fixture(scope="module", params=DEVICES)
def pipe(request):
    """The tiny fp32 pipeline on the CPU, or on the card (skipped without one)."""
    if request.param == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py's image_serving phase runs the engine "
                    "on the card")
    return build_pipeline("tiny", device=request.param, seed=4)


@contextlib.contextmanager
def engine(p, **kw):
    """An engine that is closed, with a timeout, when the block ends; its
    scheduler thread must have stopped by then."""
    eng = ImageServingEngine(p, **dict(PROTOCOL, **kw))
    try:
        yield eng
    finally:
        eng.close(timeout=WAIT_S)
        assert not eng._thread.is_alive(), "the scheduler thread did not stop"


def _direct(p, prompts, batch_index=0, seed=0):
    gen = derived_generator(seed, batch_index, device=p.device)
    return pixels_to_uint8(p.generate_images(list(prompts), gen, **PROTOCOL))


def test_full_batch_matches_direct_call(pipe):
    prompts = ["a red cat", "a dog", "blue sky"]
    with engine(pipe, batch=3, max_wait_s=5.0) as eng:
        assert eng.healthy
        futs = [eng.submit(p) for p in prompts]
        got = [f.result(timeout=WAIT_S) for f in futs]
        assert eng.batches_run == 1 and eng.requests_completed == 3
    assert not eng.healthy
    want = _direct(pipe, prompts)
    for f, g, w in zip(futs, got, want):
        assert g.dtype == np.uint8 and g.shape == (8, 8, 3) and np.array_equal(g, w)
        assert f.done() and f.done_t >= f.submit_t


def test_partial_batch_pads_without_changing_rows(pipe):
    """2 requests into a batch-4 engine: the rows equal the direct padded
    call's; the pad prompts never leak into real outputs."""
    prompts = ["a green cube", "the moon"]
    with engine(pipe, batch=4, max_wait_s=0.5) as eng:
        futs = [eng.submit(p) for p in prompts]
        got = [f.result(timeout=WAIT_S) for f in futs]
    want = _direct(pipe, prompts + ["", ""])
    for g, w in zip(got, want[:2]):
        assert np.array_equal(g, w)


def test_successive_batches_use_distinct_noise(pipe):
    """The same prompt in two microbatches gives two images (each batch's
    generator is derived from the batch counter); a fresh engine reproduces
    batch 0, and batch 1 equals the direct call under batch 1's generator."""
    with engine(pipe, batch=1, max_wait_s=0.01) as eng:
        a = eng.submit("a red cat").result(timeout=WAIT_S)
        b = eng.submit("a red cat").result(timeout=WAIT_S)
    assert not np.array_equal(a, b)
    assert np.array_equal(b, _direct(pipe, ["a red cat"], batch_index=1)[0])
    with engine(pipe, batch=1, max_wait_s=0.01) as eng:
        a2 = eng.submit("a red cat").result(timeout=WAIT_S)
    assert np.array_equal(a, a2)


def test_failed_engine_rejects_submissions(pipe):
    """A failing batch fails its futures, closes the engine and ends the
    scheduler thread (which re-raises); later submissions raise."""
    broken = dataclasses.replace(pipe)

    def boom(*a, **k):
        raise RuntimeError("synthetic sampler failure")
    broken.generate_images = boom
    eng = ImageServingEngine(broken, batch=2, max_wait_s=0.01, **PROTOCOL)
    fut = eng.submit("a red cat")
    with pytest.raises(RuntimeError, match="synthetic sampler failure"):
        fut.result(timeout=WAIT_S)
    eng._thread.join(WAIT_S)
    assert not eng._thread.is_alive() and not eng.healthy
    with pytest.raises(RuntimeError, match="closed"):
        eng.submit("late")
    eng.close(timeout=WAIT_S)


def test_closed_engine_rejects_submissions(pipe):
    with engine(pipe, batch=2, max_wait_s=0.01) as eng:
        pass
    with pytest.raises(RuntimeError, match="closed"):
        eng.submit("late")


def test_close_drains_queued_requests(pipe):
    """Requests queued before ``close`` are served, not dropped."""
    eng = ImageServingEngine(pipe, batch=2, max_wait_s=0.01, **PROTOCOL)
    futs = [eng.submit(p) for p in ("a", "b", "c")]
    eng.close(timeout=WAIT_S)
    assert not eng._thread.is_alive()
    assert all(f.result(timeout=WAIT_S).shape == (8, 8, 3) for f in futs)
    assert eng.requests_completed == 3


def _prompt_pixels(prompts):
    """[len, 8, 8, 3] floats in [-1, 1] that depend on each prompt alone."""
    return np.stack([np.random.default_rng(zlib.crc32(p.encode())).uniform(-1, 1, (8, 8, 3))
                     for p in prompts]).astype(np.float32)


def _scripted_run(engine_cls, pipe, to_array, batch_index, batch, submit_while_held, seed=5):
    """Drives an engine whose ``generate_images`` is replaced by one that
    records (batch index, padded prompts, protocol), returns
    ``_prompt_pixels`` and raises on a batch that holds "boom". The first
    batch holds the scheduler until the rest of the requests are queued,
    so the batching depends on the engine alone; then the engine is closed
    with that backlog. Returns the calls, each request's outcome, a late
    submission's outcome and the engine's counters."""
    held, release = threading.Event(), threading.Event()
    calls = []

    def generate_images(prompts, key, **kw):
        calls.append((batch_index(key), list(prompts), kw))
        if len(calls) == 1:
            held.set()
            assert release.wait(WAIT_S)
        if "boom" in prompts:
            raise RuntimeError(f"synthetic failure in call {len(calls) - 1}")
        return to_array(_prompt_pixels(prompts))
    p = dataclasses.replace(pipe)
    p.generate_images = generate_images
    eng = engine_cls(p, batch=batch, max_wait_s=0.2, seed=seed, **PROTOCOL)
    futs = [eng.submit("first")]
    assert held.wait(WAIT_S)
    futs += [eng.submit(s) for s in submit_while_held]
    release.set()
    eng.close(timeout=WAIT_S)
    assert not eng._thread.is_alive()
    outcomes = []
    for f in futs:
        try:
            outcomes.append(("image", f.result(timeout=WAIT_S)))
        except RuntimeError as e:
            outcomes.append(("error", str(e)))
    try:
        eng.submit("late")
        late = "accepted"
    except RuntimeError as e:
        late = str(e)
    return calls, outcomes, late, (eng.batches_run, eng.requests_completed, eng.healthy)


@pytest.fixture(scope="module")
def jax_pipes():
    from test_torch_pipeline_more import make_pipes
    return make_pipes()


@pytest.mark.parametrize("batch, queued, batches, failed", [
    (3, list("bcdefgh"), [["first", "", ""], list("bcd"), list("efg"), ["h", "", ""]], 0),
    (2, ["boom", "y", "z", "w"], [["first", ""], ["boom", "y"]], 4),
    (4, [], [["first", "", "", ""]], 0),
], ids=["backlog-drained-at-close", "failing-batch-then-death-drain", "single-partial"])
def test_engine_batches_like_jax(jax_pipes, batch, queued, batches, failed):
    """The port's engine and JAX's, on the same request sequence with the
    same recording ``generate_images``: the same batches (members, padding,
    order, batch counter, protocol), the same uint8 image or error for
    every request, the same counters and the same refusal after close."""
    import jax
    import jax.numpy as jnp
    from unigen_tpu.serving.images import ImageServingEngine as JEngine
    jpipe, tpipe = jax_pipes
    seed = 5
    jkeys = [np.asarray(jax.random.key_data(jax.random.fold_in(jax.random.key(seed), i)))
             for i in range(8)]
    tseeds = [derived_generator(seed, i).initial_seed() for i in range(8)]

    def j_index(key):
        return next(i for i, k in enumerate(jkeys)
                    if np.array_equal(k, np.asarray(jax.random.key_data(key))))
    jcalls, jout, jlate, jcounters = _scripted_run(JEngine, jpipe, jnp.asarray, j_index, batch,
                                                   queued, seed)
    tcalls, tout, tlate, tcounters = _scripted_run(
        ImageServingEngine, tpipe, torch.from_numpy, lambda g: tseeds.index(g.initial_seed()),
        batch, queued, seed)
    assert tcalls == jcalls and tlate == jlate and tcounters == jcounters
    assert [k for k, _ in tout] == [k for k, _ in jout]
    for (kind, t), (_, j) in zip(tout, jout):
        if kind == "image":
            assert t.dtype == j.dtype == np.uint8 and t.shape == (8, 8, 3) and np.array_equal(t, j)
        else:
            assert t == j
    # the scenario reaches the batches it means to
    assert [c[1] for c in jcalls] == batches
    assert [c[0] for c in jcalls] == list(range(len(batches)))
    assert [k for k, _ in jout].count("error") == failed and jlate == "engine is closed"


@pytest.mark.cuda
def test_engine_thread_queues_on_the_callers_stream(monkeypatch):
    """The kernels the scheduler thread launches go to the stream the
    caller's direct call uses."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    p = build_pipeline("tiny", device="cuda", seed=4)
    seen = []
    real = _cuda.stream_of

    def spy(t):
        seen.append((threading.current_thread().name, real(t)))
        return seen[-1][1]
    monkeypatch.setattr(_cuda, "stream_of", spy)
    with engine(p, batch=2, max_wait_s=0.01) as eng:
        got = eng.submit("a red cat").result(timeout=WAIT_S)
    ours = {s for name, s in seen if name == "unigen-image-serving"}
    assert ours == {torch.cuda.current_stream().cuda_stream}
    assert np.array_equal(got, _direct(p, ["a red cat", ""])[0])


# ----------------------------------------------------------------------- dpg --

@pytest.mark.parametrize("shape", [(4, 2, 2, 3), (4, 8, 8, 3), (5, 3, 7, 3)])
def test_make_grid_2x2_matches_jax(shape):
    from unigen_tpu.evaluation.dpg import make_grid_2x2 as j_grid
    imgs = np.random.default_rng(1).integers(0, 256, shape, dtype=np.uint8)
    got = DPG.make_grid_2x2(imgs)
    np.testing.assert_array_equal(got, j_grid(imgs))
    assert got.shape == (2 * shape[1], 2 * shape[2], 3)
    np.testing.assert_array_equal(got[shape[1]:, :shape[2]], imgs[2])


ITEMS = [{"item_id": "p1", "text": "a cat"}, {"item_id": "q_2", "text": "a dog on a sofa"},
         {"item_id": "r3", "text": "three red balls"}]


def _files(root):
    return sorted(str(p.relative_to(root)) for p in pathlib.Path(root).rglob("*") if p.is_file())


def test_run_dpg_grids_match_jax(tmp_path):
    """Both pipelines' ``generate_images`` fed the same candidates a prompt:
    the same grid files, pixel for pixel."""
    import jax
    import jax.numpy as jnp
    from PIL import Image
    from unigen_tpu.evaluation.dpg import run_dpg as j_run_dpg
    from test_torch_pipeline_more import make_pipes
    jpipe, tpipe = make_pipes()

    def fed(p, to_array):
        p = dataclasses.replace(p)
        calls = []

        def generate_images(prompts, key, **kw):
            calls.append((list(prompts), kw))
            seed = [it["text"] for it in ITEMS].index(prompts[0])
            px = np.random.default_rng(seed).uniform(-1, 1, (len(prompts), 8, 8, 3))
            return to_array(px.astype(np.float32))
        p.generate_images = generate_images
        return p, calls
    (jp, jcalls), (tp, tcalls) = fed(jpipe, jnp.asarray), fed(tpipe, torch.from_numpy)
    kw = dict(n_samples=4, guidance_scale=2.0, timesteps=2, eval_text_len=6, process_index=0,
              process_count=1)
    want = j_run_dpg(jp, ITEMS, str(tmp_path / "jax"), jax.random.key(0), **kw)
    got = DPG.run_dpg(tp, ITEMS, str(tmp_path / "torch"), None, **kw)
    assert tcalls == jcalls
    assert [os.path.relpath(g, tmp_path / "torch") for g in got] == \
        [os.path.relpath(w, tmp_path / "jax") for w in want] == ["p1.png", "q_2.png", "r3.png"]
    assert _files(tmp_path / "torch") == _files(tmp_path / "jax")
    for g, w in zip(got, want):
        with Image.open(w) as im:
            ref = np.asarray(im.convert("RGB"))
        assert ref.shape == (16, 16, 3)
        np.testing.assert_array_equal(load_png(g), ref)


def test_run_dpg_grids_are_the_batch_pixels(tmp_path):
    """Real generation: each grid is ``make_grid_2x2`` of its prompt's batch,
    which the same generator seed reproduces; rank 1 of 2 writes its shard."""
    p = build_pipeline("tiny", device="cpu", seed=4)
    kw = dict(guidance_scale=2.0, timesteps=2)
    out = DPG.run_dpg(p, ITEMS[:2], str(tmp_path / "a"), torch.Generator().manual_seed(3),
                      eval_text_len=6, **kw)
    gen = torch.Generator().manual_seed(3)
    for path, item in zip(out, ITEMS[:2]):
        batch = p.generate_images([item["text"]] * 4, gen, max_text_len=6, **kw)
        np.testing.assert_array_equal(load_png(path), DPG.make_grid_2x2(pixels_to_uint8(batch)))
    shard = DPG.run_dpg(p, ITEMS, str(tmp_path / "b"), None, eval_text_len=6, process_index=1,
                        process_count=2, **kw)
    assert [os.path.basename(s) for s in shard] == ["q_2.png"]


def _prepare_script():
    spec = importlib.util.spec_from_file_location("prepare_dpg_metadata_script",
                                                  ROOT / "scripts" / "prepare_dpg_metadata.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CSV = ("item_id,text,question_for_vqa,extra\n"
       "7,A cat on a red sofa.,Is there a cat?,x\n"
       "7,A cat on a red sofa.,Is the sofa red?,x\n"
       "12, Two dogs \"in\" the snow ,Are there two dogs?,y\n"
       ",missing id,Is there?,z\n"
       "13,,no text,w\n"
       "14,A lamp,,v\n")


@pytest.mark.parametrize("layout", ["txt_dir", "csv", "csv_questions"])
def test_prepare_dpg_metadata_matches_script(tmp_path, layout):
    if layout == "txt_dir":
        src = tmp_path / "prompts"
        src.mkdir()
        for stem, text in (("b_2", "two dogs\n"), ("a1", "  a cat  "), ("c3", "a lamp")):
            (src / f"{stem}.txt").write_text(text)
        (src / "notes.md").write_text("skipped")
    else:
        src = tmp_path / "dpg.csv"
        src.write_text(CSV)
    with_q = layout == "csv_questions"
    outs = {}
    for who, fn in (("port", DPG.prepare_dpg_metadata), ("script", _prepare_script().main)):
        d = tmp_path / who
        d.mkdir()
        fn(str(src), str(d / "out.jsonl"), str(d / "q.jsonl") if with_q else None)
        outs[who] = {f: (d / f).read_bytes() for f in _files(d)}
    assert outs["port"] == outs["script"]
    assert ("q.jsonl" in outs["port"]) == with_q
    assert outs["port"]["out.jsonl"].count(b"\n") == 3


def test_dpg_main_generate_and_prepare(tmp_path):
    src = tmp_path / "prompts"
    src.mkdir()
    (src / "x1.txt").write_text("a cat")
    (src / "x2.txt").write_text("a dog")
    DPG.main(["prepare", str(src), str(tmp_path / "dpg.jsonl")])
    written = DPG.main(["generate", "--prompts-file", str(tmp_path / "dpg.jsonl"),
                        "--output-dir", str(tmp_path / "out"), "--model", "tiny",
                        "--device", "cpu", "--steps", "2", "--text-len", "8"])
    assert [os.path.basename(w) for w in written] == ["x1.png", "x2.png"]
    assert load_png(written[1]).shape == (16, 16, 3)


def test_dpg_main_raises_without_cuda(monkeypatch, tmp_path):
    (tmp_path / "dpg.jsonl").write_text('{"item_id": "a", "text": "a cat"}\n')
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DPG.main(["generate", "--prompts-file", str(tmp_path / "dpg.jsonl"),
                  "--output-dir", str(tmp_path / "out"), "--model", "tiny"])


def test_slice_modules_run_with_jax_blocked(tmp_path):
    """cot, dpg and serving import and run on the tiny CPU pipeline in a
    process in which importing ``jax`` raises."""
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'unigen_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import numpy as np, torch\n"
        "from unigen_tpu_torch.evaluation import cot, dpg\n"
        "from unigen_tpu_torch.serving import ImageServingEngine\n"
        "from unigen_tpu_torch.launch import build_pipeline\n"
        "p = build_pipeline('tiny', device='cpu', vision=True)\n"
        "res, table, _ = cot.run_cot(p, ['a photo of a cup'], 0, n_samples=2, topk=1,\n"
        "                            timesteps=1, max_new_tokens=2, use_vision_tower=True)\n"
        "assert res[0]['selected'].shape == (1, 8, 8, 3) and len(table) == 2\n"
        f"out = {str(tmp_path / 'dpg')!r}\n"
        "assert len(dpg.run_dpg(p, [{'item_id': 'a', 'text': 'a cat'}], out, None,\n"
        "                       timesteps=1)) == 1\n"
        "with ImageServingEngine(p, batch=2, timesteps=1, max_wait_s=0.01) as eng:\n"
        "    assert eng.submit('a cat').result(timeout=120).shape == (8, 8, 3)\n"
        "bad = [m for m in sys.modules if sys.modules[m] is not None and (m == 'jax'\n"
        "       or m.startswith(('jax.', 'jaxlib', 'unigen_tpu.')) or m == 'unigen_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    t0 = time.monotonic()
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok") and time.monotonic() - t0 < 300
