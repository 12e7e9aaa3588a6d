"""The port's Trainer, checkpoints and train entry, on the CPU.

The JAX trainer tests (tests/test_trainer.py) on the port, the checkpoint
round trip and rotation (tests/test_training.py::test_checkpoint_roundtrip),
resume, the stage handoff (``checkpoint-<step>/unwrapped_model`` read back
by ``launch.build_pipeline(config)``) and ``python -m
unigen_tpu_torch.training.train`` on ``configs/tiny/smoke_pt2.yaml``.
"""
import json
import os
import subprocess
import sys
import time
import types

import numpy as np
import pytest
import torch

from test_prompting import MockTokenizer, SPECIALS
from unigen_tpu_torch import launch as TL
from unigen_tpu_torch import weights as W
from unigen_tpu_torch.models.magvit import MagvitConfig
from unigen_tpu_torch.models.unigen import UniGenConfig
from unigen_tpu_torch.prompting import UniPrompting
from unigen_tpu_torch.training import lr_schedules as LRS
from unigen_tpu_torch.training import train as TRAIN
from unigen_tpu_torch.training.optimizer import make_optimizer, named_leaves
from unigen_tpu_torch.training.train_step import TrainStepConfig
from unigen_tpu_torch.training.trainer import Trainer, TrainerConfig
from unigen_tpu_torch.utils import checkpoint as CK
from unigen_tpu_torch.utils.configuration import initialize_config
from unigen_tpu_torch.utils.persistence import load_state_dict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(REPO, "configs", "tiny", "smoke_pt2.yaml")


def _flows(b, res, n_batches, before=None):
    rng = np.random.default_rng(0)
    for i in range(n_batches):
        if before is not None:
            before(i)
        yield {
            "t2i_flow": {"images": rng.normal(size=(b, res, res, 3)).astype(np.float32),
                         "input_ids": ["a cat", "a dog"][:b] * (b // min(b, 2))},
            "lm_flow": {"input_ids": [f"doc {i}"] * b},
            "mmu_flow": {"images": rng.normal(size=(b, res, res, 3)).astype(np.float32),
                         "input_ids": ["what is it?"] * b},
        }


def _models(tok):
    cfg = UniGenConfig.tiny(text_vocab_len=len(tok))
    vq_cfg = MagvitConfig.tiny(resolution=8, z_channels=5)
    gen = torch.Generator().manual_seed(0)
    return cfg, vq_cfg, W.init_unigen(cfg, gen, "cpu"), W.init_magvit(vq_cfg, gen, "cpu")


def _build(tmp_path, max_steps=3, ema_decay=0.0, bt=2, bl=2, bm=2, **trainer_kw):
    tok = MockTokenizer()
    prompting = UniPrompting(tok, special_tokens=SPECIALS, max_seq_len=40,
                             cond_dropout_prob=0.1)
    cfg, vq_cfg, params, vq_params = _models(tok)
    tx = make_optimizer(params, 1e-3, LRS.get_scheduler("constant"))
    tcfg = TrainStepConfig(batch_size_t2i=bt, batch_size_lm=bl, batch_size_mmu=bm,
                           pad_id=prompting.pad_id, soi_id=prompting.sptids_dict["<|soi|>"],
                           eoi_id=prompting.sptids_dict["<|eoi|>"])
    kw = dict(output_dir=str(tmp_path), max_train_steps=max_steps, log_every=1, save_every=2,
              seed=0, ema_decay=ema_decay)
    kw.update(trainer_kw)
    return Trainer(cfg, vq_cfg, tcfg, TrainerConfig(**kw), prompting, tx, params, vq_params)


def _logs(path):
    with open(os.path.join(path, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_trainer_runs_saves_and_resumes(tmp_path):
    trainer = _build(tmp_path, max_steps=3)
    state = trainer.train(_flows(2, 8, 10))
    assert int(state.step) == 3
    ckpts = [d for d in os.listdir(tmp_path) if d.startswith("checkpoint")]
    assert "checkpoint-2" in ckpts and "checkpoint-3" in ckpts
    assert os.path.isdir(os.path.join(tmp_path, "checkpoint-3", "unwrapped_model"))
    logs = _logs(tmp_path)
    assert any("loss" in entry and np.isfinite(entry["loss"]) for entry in logs)
    assert any(entry.get("samples_per_sec_per_device", 0) > 0 for entry in logs)

    # a fresh trainer resumes from checkpoint-3, its state equal, and goes on to 5
    trainer2 = _build(tmp_path, max_steps=5)
    assert trainer2.global_step == 3
    for (path, a), (_, b) in zip(named_leaves(state), named_leaves(trainer2.state)):
        assert torch.equal(a, b), path
    assert trainer2.state.params["llm"]["embed"].requires_grad
    state2 = trainer2.train(_flows(2, 8, 10))
    assert int(state2.step) == 5 and int(state2.opt_state.count) == 5


def test_visualize_every_raises(tmp_path):
    """``visualize_every`` no longer raises (the name is the test's from when
    it did): every third step writes the triptych grid of its t2i batch and
    logs its path; test_torch_visualization.py holds the grids to JAX's."""
    from unigen_tpu_torch.data.decode import read_image
    trainer = _build(tmp_path, max_steps=3, visualize_every=3, save_every=0)
    trainer.train(_flows(2, 8, 10))
    assert os.listdir(tmp_path / "visualizations") == ["predictions_step3.png"]
    logged = [e for e in _logs(tmp_path) if "visualization" in e]
    assert [(e["step"], os.path.basename(e["visualization"])) for e in logged] == \
        [(3, "predictions_step3.png")]
    grid = read_image(str(tmp_path / "visualizations" / "predictions_step3.png"))
    assert grid.shape == (8, 2 * 24, 3) and grid.dtype == np.uint8


def test_trainer_throughput_is_window_averaged(tmp_path, monkeypatch):
    """The timing meters reset at every log window: a slow first window (its
    data flow takes 100 s a batch on the trainer's clock) does not weigh on
    the later windows' averages."""
    from unigen_tpu_torch.training import trainer as trainer_mod
    offset = [0.0]
    monkeypatch.setattr(trainer_mod, "time", types.SimpleNamespace(
        time=lambda: time.time() + offset[0]))

    def slow_start(i):
        if i < 2:
            offset[0] += 100.0
    trainer = _build(tmp_path, max_steps=6, log_every=2)
    trainer.train(_flows(2, 8, 10, before=slow_start))
    logs = [entry for entry in _logs(tmp_path) if "batch_time" in entry]
    assert len(logs) >= 3
    # without the reset the last window would average 200 s over 6 steps
    assert logs[0]["batch_time"] > 100 and logs[-1]["batch_time"] < 10
    assert logs[-1]["samples_per_sec_per_device"] > 10 * logs[0]["samples_per_sec_per_device"]


def test_trainer_ema_tracks_and_survives_resume(tmp_path):
    trainer = _build(tmp_path, max_steps=2, ema_decay=0.999)
    assert trainer.state.ema is not None
    ema0 = [t.clone() for _, t in named_leaves(trainer.state.ema.params)]
    state = trainer.train(_flows(2, 8, 10))
    assert int(state.ema.step) == 2
    ema2 = [t.clone() for _, t in named_leaves(state.ema.params)]
    p2 = [t.detach() for _, t in named_leaves(state.params)]
    assert any(not torch.equal(a, b) for a, b in zip(ema0, ema2)), "EMA never updated"
    assert any(not torch.equal(a, b) for a, b in zip(ema2, p2)), "EMA equals the params"
    # the portable export holds the EMA weights, not the raw params
    exported = load_state_dict(os.path.join(tmp_path, "checkpoint-2", "unwrapped_model"))
    assert torch.equal(exported["llm/embed/weight"], state.ema.params["llm"]["embed"])
    # resume restores the EMA bitwise and keeps advancing it
    trainer2 = _build(tmp_path, max_steps=4, ema_decay=0.999)
    assert trainer2.global_step == 2
    for a, (_, b) in zip(ema2, named_leaves(trainer2.state.ema.params)):
        assert torch.equal(a, b)
    state2 = trainer2.train(_flows(2, 8, 10))
    assert int(state2.ema.step) == 4


def test_trainer_llava_und_type(tmp_path):
    """mmu_conv (pre-tokenized conversations) flow through the trainer."""
    tok = MockTokenizer()
    prompting = UniPrompting(tok, special_tokens=SPECIALS, max_seq_len=40,
                             cond_dropout_prob=0.0)
    cfg, vq_cfg, params, vq_params = _models(tok)
    tx = make_optimizer(params, 1e-3, LRS.get_scheduler("constant"))
    tcfg = TrainStepConfig(batch_size_t2i=0, batch_size_lm=0, batch_size_mmu=2,
                           pad_id=prompting.pad_id, soi_id=prompting.sptids_dict["<|soi|>"],
                           eoi_id=prompting.sptids_dict["<|eoi|>"])
    trainer = Trainer(cfg, vq_cfg, tcfg, TrainerConfig(
        output_dir=str(tmp_path), max_train_steps=1, log_every=1, save_every=100, seed=0,
        und_type="llava", resume_from_checkpoint=None), prompting, tx, params, vq_params)
    rng = np.random.default_rng(0)
    width = prompting.max_seq_len - cfg.num_vq_tokens - 3
    ids = rng.integers(3, 100, size=(2, width))
    ids[:, -1] = 501  # eos so the eos-scan finds a stop
    labels = np.where(rng.random((2, width)) < 0.5, ids, -100)

    def flow():
        yield {"mmu_flow": {"images": rng.normal(size=(2, 8, 8, 3)).astype(np.float32),
                            "input_ids": ids, "labels": labels}}

    state = trainer.train(flow())
    assert int(state.step) == 1
    assert np.isfinite(_logs(tmp_path)[-1]["grad_norm"])


def test_checkpoint_roundtrip_and_rotation(tmp_path):
    trainer = _build(tmp_path / "train", max_steps=1, save_every=0, resume_from_checkpoint=None)
    state = trainer.train(_flows(2, 8, 1))
    out = str(tmp_path / "run")
    export = trainer._export_params()
    CK.save_checkpoint(state, out, step=10, total_limit=2, unwrapped_params=export)
    CK.save_checkpoint(state, out, step=20, total_limit=2)
    CK.save_checkpoint(state, out, step=30, total_limit=2)
    dirs = sorted(os.listdir(out))
    assert "checkpoint-10" not in dirs and len(dirs) == 2
    latest = CK.latest_checkpoint(out)
    assert CK.resume_step(latest) == 30
    restored = CK.restore_checkpoint(latest, state)
    assert type(restored) is type(state) and type(restored.opt_state) is type(state.opt_state)
    for (path, a), (_, b) in zip(named_leaves(state), named_leaves(restored)):
        assert torch.equal(a, b) and a.dtype == b.dtype, path
    assert int(restored.step) == int(state.step) == 1


def _smoke_config(out, *extra):
    return initialize_config(SMOKE, [f"experiment.output_dir={out}", "device=cpu", *extra])


def test_train_entry_smoke_and_stage_handoff(tmp_path):
    """The entry on the tiny config: 2 steps and ``checkpoint-2/{state,
    unwrapped_model}``; its losses equal a Trainer built and driven here;
    ``build_pipeline(config)`` loads the exported weights."""
    out = str(tmp_path / "pt2")
    assert TRAIN.main([f"config={SMOKE}", f"experiment.output_dir={out}", "device=cpu"]) == 0
    for sub in ("state", "unwrapped_model"):
        assert os.path.isdir(os.path.join(out, "checkpoint-2", sub))

    direct_out = str(tmp_path / "direct")
    config = _smoke_config(direct_out)
    prompting = TL.build_prompting_from_config(config, TL.load_tokenizer(config))
    params, cfg = TL.build_unigen(config, prompting, device="cpu")
    vq_params, vq_cfg = TL.build_vq(config, device="cpu")
    tx = make_optimizer(params, 1e-3, LRS.get_scheduler("constant"), weight_decay=0.01,
                        max_grad_norm=1.0)
    tcfg = TrainStepConfig(batch_size_t2i=2, batch_size_lm=1, batch_size_mmu=2,
                           max_grad_norm=1.0, pad_id=prompting.pad_id,
                           soi_id=prompting.sptids_dict["<|soi|>"],
                           eoi_id=prompting.sptids_dict["<|eoi|>"])
    state = Trainer(cfg, vq_cfg, tcfg, TrainerConfig(
        output_dir=direct_out, max_train_steps=2, log_every=1, save_every=2,
        checkpoints_total_limit=2), prompting, tx, params, vq_params).train(
        TRAIN.synthetic_flows(config))
    keys = ("loss", "loss_t2i", "loss_lm", "loss_mmu", "grad_norm", "avg_masking_rate")
    got, want = _logs(out), _logs(direct_out)
    assert [[e[k] for k in keys] for e in got] == [[e[k] for k in keys] for e in want]
    assert all(np.isfinite(e["grad_norm"]) for e in got)

    handoff = _smoke_config(str(tmp_path / "next"),
                            f"model.unigen.pretrained_model_path={out}/checkpoint-2")
    pipe = TL.build_pipeline(handoff, device="cpu")
    for (path, a), (_, b) in zip(named_leaves(pipe.params), named_leaves(state.params)):
        assert torch.equal(a, b.detach()), path


def test_train_entry_needs_a_card_or_device_cpu(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, "-m", "unigen_tpu_torch.training.train",
                        f"config={SMOKE}", f"experiment.output_dir={tmp_path}"],
                       cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and "no CUDA device" in r.stderr
    assert not os.listdir(tmp_path)
    with pytest.raises(ValueError, match="dataset.params"):
        TRAIN.main([f"config={SMOKE}", f"experiment.output_dir={tmp_path}", "device=cpu",
                    "dataset.synthetic=false"])
