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
        with pytest.raises(NotImplementedError, match="item 12"):
            main(_args(name, str(tmp_path), "dataset.synthetic=false"))
