"""The SFT and DPO entry points of the port on the tiny configs, on the CPU.

tests/test_scripts.py's entry smokes on the port
(``configs/tiny/smoke_{sft,dpo}.yaml`` with ``device=cpu``): checkpoints
and resume to ``checkpoint-4``, the mmu-only CoT-V run (``common_length``
None), LoRA with ``merge_on_save`` (the export without adapters, the state
with them), the DPO precompute pass, and the PT2 -> SFT -> DPO handoff
through ``model.unigen.pretrained_model_path``.
"""
import json
import logging
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from unigen_tpu_torch.training import train as PT2
from unigen_tpu_torch.training import train_dpo as DPO
from unigen_tpu_torch.training import train_sft as SFT
from unigen_tpu_torch.training.optimizer import named_leaves
from unigen_tpu_torch.utils.configuration import initialize_config
from unigen_tpu_torch.utils.persistence import load_state_dict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = {name: os.path.join(REPO, "configs", "tiny", f"smoke_{name}.yaml")
         for name in ("pt2", "sft", "dpo")}


def _args(name, out, *extra):
    return [f"config={SMOKE[name]}", f"experiment.output_dir={out}", "device=cpu", *extra]


def _config(name, out, *extra):
    return initialize_config(SMOKE[name], _args(name, out, *extra)[1:])


def _logs(out):
    with open(os.path.join(out, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


class _Lines(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())

    def take(self) -> str:
        out, self.lines = "\n".join(self.lines), []
        return out


@pytest.fixture
def logs():
    """The entries' log messages (their loggers do not propagate)."""
    handler = _Lines()
    loggers = [logging.getLogger(n) for n in ("train_sft", "train_dpo")]
    for lg in loggers:
        lg.addHandler(handler)
    yield handler
    for lg in loggers:
        lg.removeHandler(handler)


def _names(out, step, sub):
    return list(load_state_dict(os.path.join(out, f"checkpoint-{step}", sub)))


def test_sft_entry_checkpoints_and_resumes(tmp_path, logs):
    """2 steps and ``checkpoint-2/{state, unwrapped_model}`` (the mode logged
    from the first batch: the packed common length); a relaunch with 4 steps
    resumes from checkpoint-2 and ends at checkpoint-4."""
    out = str(tmp_path / "sft")
    assert SFT.main(_args("sft", out)) == 0
    for sub in ("state", "unwrapped_model"):
        assert os.path.isdir(os.path.join(out, "checkpoint-2", sub))
    assert "SFT step mode: common_length=71 (mmu 71, t2i/lm [35, 35])" in logs.take()
    assert [e["step"] for e in _logs(out)] == [1, 2]
    assert all(np.isfinite(e["loss"]) and np.isfinite(e["grad_norm"]) for e in _logs(out))
    assert SFT.main(_args("sft", out, "training.max_train_steps=4",
                          "experiment.resume_from_checkpoint=latest")) == 0
    assert "resuming from checkpoint" in logs.take()
    assert os.path.isdir(os.path.join(out, "checkpoint-4"))
    assert [e["step"] for e in _logs(out)] == [1, 2, 3, 4]


def test_sft_entry_mmu_only(tmp_path, logs):
    """The CoT-V post-SFT stage (t2i and lm batches 0): the separate mode."""
    out = str(tmp_path / "cotv")
    assert SFT.main(_args("sft", out, "training.batch_size_t2i=0",
                          "training.batch_size_lm=0")) == 0
    assert "common_length=None" in logs.take()
    assert os.path.isdir(os.path.join(out, "checkpoint-2", "unwrapped_model"))
    assert all(e["avg_masking_rate"] == 0 and "loss_t2i" not in e for e in _logs(out))


def test_sft_entry_lora_merge_on_save(tmp_path, logs):
    """LoRA rank 4 with ``merge_on_save``: the adapters and the projector
    train, nothing else moves; the final export holds merged weights and no
    adapter leaf, the trainer state keeps them."""
    out = str(tmp_path / "lora")
    config = _config("sft", out, "model.lora.rank=4", "model.lora.alpha=8",
                     "model.lora.merge_on_save=true")
    run = SFT.SFTRun(config)
    assert "LoRA rank 4" in logs.take()
    before = {p: t.detach().clone() for p, t in named_leaves(run.state.params)}
    state = run.train()
    assert "merged LoRA adapters" in logs.take()
    moved = {p: not torch.equal(t.detach(), before[p]) for p, t in named_leaves(state.params)}
    for p, t in named_leaves(state.params):
        trained = p.endswith(("_lora_a", "_lora_b")) or p.startswith("mm_projector")
        assert t.requires_grad == trained, p
        assert trained or not moved[p], p
    assert all(moved[p] for p in moved if p.endswith("_lora_b") or p.startswith("mm_projector"))
    unwrapped, saved = _names(out, 2, "unwrapped_model"), _names(out, 2, "state")
    assert any("/mlp/" in n for n in unwrapped)
    assert not any("lora_" in n for n in unwrapped)
    assert any("lora_" in n for n in saved)
    with pytest.raises(ValueError, match="int8-only base"):
        run._lora({"llm": {"layers": [{"q": {"kernel_int8": None}}]}})


def test_dpo_entry_resumes_and_precomputes(tmp_path, logs):
    """2 DPO steps, then a relaunch to 4 that resumes from checkpoint-2 and
    skips the schedule to step 2; the precompute pass (the schedule replayed
    with the prompting RNG re-seeded and the same draws) gives the online
    run's losses exactly, and a batch that does not replay raises."""
    out = str(tmp_path / "dpo")
    assert DPO.main(_args("dpo", out)) == 0
    assert os.path.isdir(os.path.join(out, "checkpoint-2", "state"))
    assert DPO.main(_args("dpo", out, "training.max_train_steps=4",
                          "experiment.resume_from_checkpoint=latest")) == 0
    assert "resuming from checkpoint" in logs.take()
    assert os.path.isdir(os.path.join(out, "checkpoint-4"))
    assert [e["step"] for e in _logs(out)] == [1, 2, 3, 4]

    pre_out = str(tmp_path / "pre")
    run = DPO.DPORun(_config("dpo", pre_out, "training.cond_dropout_prob=0.5"))
    ref = DPO.DPORun(_config("dpo", str(tmp_path / "ref"), "training.cond_dropout_prob=0.5"))
    cache = run.precompute()
    assert len(cache) == 2 and run.ref_params is None and run.dcfg.precomputed_ref
    run.train()
    ref.train()
    keys = ("loss", "reward_accuracy", "policy_chosen_logps", "grad_norm")
    assert [[e[k] for k in keys] for e in _logs(pre_out)] == \
        [[e[k] for k in keys] for e in _logs(str(tmp_path / "ref"))]
    bad = DPO.DPORun(_config("dpo", str(tmp_path / "bad")))
    bad.precompute()
    bad.ref_cache[1] = ((0, 0.0, 0.0), bad.ref_cache[1][1])
    with pytest.raises(RuntimeError, match="step 1: batch does not match"):
        bad.train()


def test_pt2_sft_dpo_handoff(tmp_path):
    """PT2 -> SFT -> DPO: each stage starts from the previous stage's
    ``checkpoint-2`` (its exported weights equal the state it trained)."""
    pt2, sft, dpo = (str(tmp_path / s) for s in ("pt2", "sft", "dpo"))
    wide = ("model.unigen.w_und_encoder=true", "model.unigen.mm_input_dim=32")
    assert PT2.main(_args("pt2", pt2, *wide)) == 0
    run = SFT.SFTRun(_config("sft", sft, f"model.unigen.pretrained_model_path={pt2}/checkpoint-2"))
    pt2_params = load_state_dict(os.path.join(pt2, "checkpoint-2", "unwrapped_model"))
    assert torch.equal(run.state.params["llm"]["embed"].detach(), pt2_params["llm/embed/weight"])
    state = run.train()
    d = DPO.DPORun(_config("dpo", dpo, *wide,
                           f"model.unigen.pretrained_model_path={sft}/checkpoint-2"))
    for (p, a), (_, b) in zip(named_leaves(d.state.params), named_leaves(state.params)):
        assert torch.equal(a.detach(), b.detach()), p
    d.train()
    assert os.path.isdir(os.path.join(dpo, "checkpoint-2", "unwrapped_model"))


def test_entries_need_a_card_or_device_cpu(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    for module, name in (("train_sft", "sft"), ("train_dpo", "dpo")):
        r = subprocess.run([sys.executable, "-m", f"unigen_tpu_torch.training.{module}",
                            f"config={SMOKE[name]}", f"experiment.output_dir={tmp_path}"],
                           cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
        assert r.returncode != 0 and "no CUDA device" in r.stderr, module
    assert not os.listdir(tmp_path)
    for main, name in ((SFT.main, "sft"), (DPO.main, "dpo")):
        with pytest.raises(ValueError, match="dataset.params"):
            main(_args(name, str(tmp_path), "dataset.synthetic=false"))


# ------------------------------------------------------ the real-data flows --

def _write_data(root, res=8, siglip=384, n_shards=2, per_shard=5, pairs=5):
    """Tar shards (PNG at ``res``, json / txt captions, a broken sample a
    shard), a parquet file, LLaVA conversations with PNGs at ``siglip`` px
    and DPO pairs (a broken rejected image); the images at their target
    size, so the port's and JAX's pixels are equal."""
    import tarfile
    from test_torch_data import _add, _image, _pil_png
    os.makedirs(root, exist_ok=True)
    shards = {}
    for flow in ("t2i", "mmu"):
        shards[flow] = []
        for s in range(n_shards):
            path = os.path.join(root, f"{flow}-{s}.tar")
            with tarfile.open(path, "w") as tf:
                for i in range(per_shard):
                    key, idx = f"{s}{i:04d}", 10 * s + i
                    _add(tf, f"{key}.png", _pil_png(_image(res, res, idx)))
                    meta = {"prompt": f"The image shows a cat {idx}", "short_caption": f"cat {idx}"}
                    _add(tf, f"{key}.json", json.dumps(meta).encode())
                _add(tf, f"{s}9999.png", b"broken")
                _add(tf, f"{s}9999.txt", b"the broken sample's caption")
            shards[flow].append(path)
    files = {"shards": shards}
    try:
        import pyarrow as pa
        import pyarrow.parquet as pq
        files["parquet"] = os.path.join(root, "lm.parquet")
        pq.write_table(pa.table({"content": [f"document {i} " * (i + 1) for i in range(9)]}),
                       files["parquet"])
    except ImportError:
        pass
    images = os.path.join(root, "images")
    os.makedirs(images, exist_ok=True)
    for i in range(3):
        with open(os.path.join(images, f"v{i}.png"), "wb") as f:
            f.write(_pil_png(_image(siglip, siglip, 50 + i)))
    with open(os.path.join(root, "llava.jsonl"), "w") as f:
        for i in range(4):
            f.write(json.dumps({"image": f"v{i % 3}.png", "conversations": [
                {"from": "human", "value": f"<image>\nWhat is {i}?"},
                {"from": "gpt", "value": f"Thing {i}."}]}) + "\n")
    for i in range(pairs):
        for side in ("c", "r"):
            with open(os.path.join(images, f"{side}{i}.png"), "wb") as f:
                f.write(b"broken" if (i, side) == (2, "r") else
                        _pil_png(_image(res, res, 70 + 2 * i + (side == "r"))))
    with open(os.path.join(root, "pairs.jsonl"), "w") as f:
        for i in range(pairs):
            f.write(json.dumps({"prompt": f"prompt {i}", "chosen": f"c{i}.png",
                                "rejected": f"r{i}.png"}) + "\n")
    files.update(llava=os.path.join(root, "llava.jsonl"), images=images,
                 pairs=os.path.join(root, "pairs.jsonl"))
    return files


@pytest.fixture(scope="module")
def jax_native_lib(tmp_path_factory):
    from test_torch_data import build_jax_native
    return build_jax_native(tmp_path_factory.mktemp("jax_native"))


def _same(got, want):
    assert type(got) is type(want)
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _same(got[k], want[k])
    elif isinstance(want, np.ndarray):
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want


def test_pt2_entry_reads_files(tmp_path, monkeypatch, jax_native_lib):
    """``training/train.py``'s real flow on the tiny PT2 config gives the
    batches of ``scripts/train.py::real_flows`` (its own function, JAX's
    loaders), then the entry takes 2 steps on them."""
    pytest.importorskip("pyarrow")
    import importlib.util
    from test_torch_data import use_jax_native
    use_jax_native(monkeypatch, jax_native_lib)
    files = _write_data(str(tmp_path / "data"))
    data = (f"dataset.params.train_t2i_shards_path_or_url=[{','.join(files['shards']['t2i'])}]",
            f"dataset.params.train_mmu_shards_path_or_url=[{','.join(files['shards']['mmu'])}]",
            f"dataset.params.train_lm_shards_path_or_url=[{files['parquet']}]",
            "dataset.params.add_caption_prompt=true", "dataset.synthetic=false")
    out = str(tmp_path / "pt2")
    config = _config("pt2", out, *data)
    spec = importlib.util.spec_from_file_location(
        "jax_train_script", os.path.join(REPO, "scripts", "train.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    want, got = script.real_flows(config, None), PT2.real_flows(config)
    for _ in range(5):
        _same(next(got), next(want))
    assert PT2.main(_args("pt2", out, *data)) == 0
    assert [e["step"] for e in _logs(out)] == [1, 2]
    assert all(np.isfinite(e["loss"]) for e in _logs(out))


def test_sft_entry_reads_files(tmp_path, monkeypatch, jax_native_lib):
    """``train_sft.real_batches`` on the tiny SFT config (its tower at JAX's
    384 px) gives the batches of the objects scripts/train_sft.py:155-171
    builds. With the config's own 28 px tower the port resizes to 28 px
    (JAX's entry would hand that tower 384 px), and the entry takes 2 steps
    on those batches; with the NaFlex tower it patchifies; the mmu-only
    CoT-V shape builds no t2i flow."""
    from unigen_tpu.data.combined import combined_loader
    from unigen_tpu.data.llava import LlavaDataset
    from unigen_tpu.data.text2image import Text2ImageDataset
    from unigen_tpu_torch.launch import (build_prompting_from_config, load_tokenizer,
                                         vision_tower_config)
    from test_torch_data import use_jax_native
    use_jax_native(monkeypatch, jax_native_lib)
    files = _write_data(str(tmp_path / "data"))
    data = (f"dataset.params.train_t2i_shards_path_or_url=[{','.join(files['shards']['t2i'])}]",
            f"dataset.params.llava_data_paths=[{files['llava']}]",
            f"dataset.params.llava_image_root={files['images']}", "dataset.synthetic=false")
    out = str(tmp_path / "sft")
    config = _config("sft", out, *data, "model.vision_tower.image_size=384")
    prompting = build_prompting_from_config(config, load_tokenizer(config))
    tr, tok = config.training, prompting.text_tokenizer

    def jax_batches():
        flows = {"t2i": ({"images": b["images"], "texts": b["input_ids"]}
                         for b in Text2ImageDataset(files["shards"]["t2i"],
                                                    per_device_batch_size=tr.batch_size_t2i,
                                                    resolution=8)),
                 "mmu": iter(LlavaDataset([files["llava"]], files["images"], tok,
                                          per_device_batch_size=tr.batch_size_mmu,
                                          visual_mode="siglip"))}
        for b in combined_loader(flows):
            yield {"t2i": b["t2i"], "mmu": b["mmu"], "lm": {"texts": [""] * tr.batch_size_lm}}
    got = SFT.real_batches(config, prompting, vision_tower_config(config))
    want = jax_batches()
    for _ in range(4):
        _same(next(got), next(want))
    small = _config("sft", out, *data)
    assert next(SFT.real_batches(small, prompting, vision_tower_config(small)))[
        "mmu"]["images"].shape == (tr.batch_size_mmu, 28, 28, 3)
    assert SFT.main(_args("sft", out, *data)) == 0
    assert [e["step"] for e in _logs(out)] == [1, 2]
    assert all(np.isfinite(e["loss"]) for e in _logs(out))
    naflex = _config("sft", out, *data, "model.vision_tower.name=siglip2-naflex-smoke",
                     "model.vision_tower.patch_size=4")
    mmu = next(SFT.real_batches(naflex, prompting, vision_tower_config(naflex)))["mmu"]
    vs = vision_tower_config(naflex)
    assert mmu["images"].shape == (tr.batch_size_mmu, vs.num_patches, 3 * 16)
    assert mmu["spatial_shapes"].tolist() == [[16, 16]] * tr.batch_size_mmu
    cotv = _config("sft", out, *data[1:], "training.batch_size_t2i=0",
                   "training.batch_size_lm=0", "model.vision_tower.image_size=384")
    fb = next(SFT.real_batches(cotv, prompting, vision_tower_config(cotv)))
    assert fb["t2i"]["images"].shape == (0, 8, 8, 3) and fb["t2i"]["texts"] == []


def test_dpo_entry_reads_files(tmp_path):
    """``train_dpo.real_pairs`` over 2 epochs gives JAX's ``DPODataset``
    batches built as scripts/train_dpo.py:100-107 builds it (the pair with
    a broken image skipped, the second epoch reshuffled); the entry then
    precomputes the reference and trains 3 steps on them, the two passes
    held to the same batches."""
    from unigen_tpu.data.dpo_data import DPODataset
    files = _write_data(str(tmp_path / "data"))
    data = (f"dataset.params.dpo_data_path={files['pairs']}",
            f"dataset.params.dpo_image_root={files['images']}", "dataset.synthetic=false",
            "training.num_epoch=2")
    out = str(tmp_path / "dpo")
    config = _config("dpo", out, *data)
    ds = DPODataset([files["pairs"]], files["images"],
                    per_device_batch_size=config.training.batch_size_t2i, resolution=8)
    want = [b for _ in range(2) for b in ds]
    got = list(DPO.real_pairs(config))
    assert len(got) == len(want) == 4
    for a, b in zip(got, want):
        _same(a, b)
    assert got[0]["batch_prompt_list"] != got[2]["batch_prompt_list"]
    assert DPO.main(_args("dpo", out, *data, "training.precompute_ref=true",
                          "training.max_train_steps=3")) == 0
    assert [e["step"] for e in _logs(out)] == [1, 2, 3]
    assert all(np.isfinite(e["loss"]) for e in _logs(out))
