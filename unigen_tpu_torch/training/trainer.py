"""Unified pretraining orchestration.

Port of ``unigen_tpu/training/trainer.py``. Host side per step: take the
three task flows (t2i / lm / mmu), assemble prompt templates with
placeholder image blocks through ``UniPrompting``, move them to the device
and call the train step (``train_step.py``), which does the rest there.

Periodic work as in JAX: metric logging with timing meters (the meters of
step N are read after step N + 1 is enqueued, so the host's batch building
overlaps the device's step; throughput is averaged over the log window),
checkpoint save and rotation with the portable export
(``utils/checkpoint.py``), resume from the latest checkpoint, and every
``visualize_every`` steps the [original | VQ reconstruction | prediction]
triptychs of the current t2i batch (``visualization.py``), written to
``output_dir/visualizations/predictions_step{N}.png``. The entries leave
``visualize_every`` at 0, as JAX's ``scripts/train.py`` does.

With a ``mesh`` (``parallel.make_mesh``) every rank builds the Trainer on
the same global batches: the parameters are sharded by
``parallel.unigen_specs`` (``fsdp=True`` adds ZeRO-3), the step runs
sharded, every rank saves its shards and rank 0 the gathered portable
export, and a resume cuts this mesh's shards from whatever mesh saved.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Callable, Dict, Iterator, Optional

import numpy as np
import torch

from .. import weights as W
from ..models.magvit import MagvitConfig
from ..models.unigen import UniGenConfig
from ..prompting import UniPrompting
from ..utils import checkpoint as CK
from ..parallel import gather_params, shard_params, unigen_specs
from ..utils.logging import AverageMeter, MetricLogger, get_logger
from ..utils.multihost import process_index
from .ema import EMAConfig
from .optimizer import AdamW
from .train_step import (TrainState, TrainStepConfig, init_train_state, make_train_step,
                         param_specs)

logger = get_logger(__name__)


@dataclasses.dataclass
class TrainerConfig:
    output_dir: str
    max_train_steps: int
    log_every: int = 50
    save_every: int = 2000
    generate_every: int = 0
    visualize_every: int = 0
    checkpoints_total_limit: Optional[int] = None
    resume_from_checkpoint: Optional[str] = "latest"
    seed: int = 10084
    und_type: str = "captioning"     # 'captioning' (mmu task) | 'llava' (mmu_conv)
    # > 0 keeps an EMA of the params in the step; the portable export then
    # holds the EMA weights, the state both
    ema_decay: float = 0.0


class Trainer:
    def __init__(self, cfg: UniGenConfig, vq_cfg: MagvitConfig, tcfg: TrainStepConfig,
                 trainer_cfg: TrainerConfig, prompting: UniPrompting, tx: AdamW,
                 params: Any, vq_params: Any,
                 metric_logger: Optional[MetricLogger] = None,
                 generate_callback: Optional[Callable[[Any, int], None]] = None,
                 mesh=None, fsdp: bool = False):
        self.cfg, self.vq_cfg, self.tcfg, self.tr = cfg, vq_cfg, tcfg, trainer_cfg
        self.prompting = prompting
        self.tx = tx
        self.vq_params = vq_params
        self.metrics = metric_logger or MetricLogger(trainer_cfg.output_dir)
        self.generate_callback = generate_callback
        ema_cfg = EMAConfig(decay=trainer_cfg.ema_decay) if trainer_cfg.ema_decay > 0 else None
        self.step_fn = make_train_step(cfg, vq_cfg, tx, tcfg, ema_cfg)
        sharding = None
        if mesh is not None:
            params, sharding = shard_params(params, unigen_specs(params, cfg, mesh, fsdp), mesh)
        self.state: TrainState = init_train_state(params, tx, ema_cfg, sharding)
        self.device = self.state.step.device
        self.global_step = 0
        self._maybe_resume()

    # ------------------------------------------------------------- resume --

    def _maybe_resume(self):
        if not self.tr.resume_from_checkpoint:
            return
        path = (CK.latest_checkpoint(self.tr.output_dir)
                if self.tr.resume_from_checkpoint == "latest"
                else self.tr.resume_from_checkpoint)
        if path and os.path.isdir(os.path.join(path, "state")):
            logger.info(f"Resuming from checkpoint {path}")
            self.state = CK.restore_checkpoint(path, self.state)
            self.global_step = CK.resume_step(path)

    def _export_params(self):
        """The portable weights, in the JAX layout: the EMA average when it is
        kept, else the params."""
        params = self.state.ema.params if self.state.ema is not None else self.state.params
        if self.state.sharding is not None:
            params = gather_params(params, self.state.sharding)
        with torch.no_grad():
            return W.unigen_to_jax(params, self.cfg)

    def _save(self):
        CK.save_checkpoint(self.state, self.tr.output_dir, self.global_step,
                           total_limit=self.tr.checkpoints_total_limit,
                           unwrapped_params=self._export_params())

    # -------------------------------------------------- host batch building --

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a)).to(self.device, non_blocking=True)

    def build_device_batch(self, flow_batch: Dict[str, Dict]) -> Dict[str, torch.Tensor]:
        """Task flows -> fixed-shape template tensors on the device."""
        n = self.cfg.num_vq_tokens
        out: Dict[str, torch.Tensor] = {}
        if self.tcfg.batch_size_t2i > 0:
            t2i = flow_batch["t2i_flow"]
            placeholder = np.zeros((len(t2i["input_ids"]), n), np.int64)
            ids, _, labels = self.prompting((t2i["input_ids"], placeholder, placeholder), "t2i")
            out["t2i_template"] = self._tensor(ids)
            out["t2i_labels"] = self._tensor(labels)
            out["t2i_pixels"] = self._tensor(t2i["images"])
        if self.tcfg.batch_size_lm > 0:
            ids, _, labels = self.prompting((flow_batch["lm_flow"]["input_ids"],
                                             self.prompting.max_seq_len), "lm")
            out["lm_ids"] = self._tensor(ids)
            out["lm_labels"] = self._tensor(labels)
        if self.tcfg.batch_size_mmu > 0:
            mmu = flow_batch["mmu_flow"]
            placeholder = np.zeros((mmu["images"].shape[0], n), np.int64)
            if self.tr.und_type == "captioning":
                ids, _, labels = self.prompting((placeholder, mmu["input_ids"]), "mmu")
            else:  # llava conversations, pre-tokenized ids / labels
                want = self.prompting.max_seq_len - n - 3
                if mmu["input_ids"].shape[1] != want:
                    raise ValueError(
                        f"llava mmu conversations must be padded to max_seq_len - "
                        f"num_vq_tokens - 3 = {want} tokens (got {mmu['input_ids'].shape[1]}) "
                        "so the fused batch is rectangular")
                ids, _, labels = self.prompting(
                    (placeholder, mmu["input_ids"], mmu["labels"], None), "mmu_conv")
            out["mmu_template"] = self._tensor(ids)
            out["mmu_labels"] = self._tensor(labels)
            out["mmu_pixels"] = self._tensor(mmu["images"])
        return out

    # ----------------------------------------------------------- visualize --

    def _visualize(self, batch: Dict[str, torch.Tensor], generator) -> np.ndarray:
        """[original | VQ recon | model prediction] triptychs of the current
        t2i batch (masking draws from ``generator``), saved as a grid PNG and
        logged to metrics.jsonl (reference train.py:859-875); returns them."""
        from . import visualization as VZ
        ids = VZ.masked_t2i_inputs(
            self.vq_params, self.vq_cfg, self.cfg, batch["t2i_template"], batch["t2i_pixels"],
            generator, mask_schedule=self.tcfg.mask_schedule,
            min_masking_rate=self.tcfg.min_masking_rate)
        trip = VZ.visualize_predictions(
            self.state.params, self.cfg, self.vq_params, self.vq_cfg, batch["t2i_pixels"], ids,
            self.tcfg.pad_id, self.tcfg.soi_id, self.tcfg.eoi_id, specs=param_specs(self.state))
        if process_index() == 0:
            vis_dir = os.path.join(self.tr.output_dir, "visualizations")
            os.makedirs(vis_dir, exist_ok=True)
            path = os.path.join(vis_dir, f"predictions_step{self.global_step}.png")
            VZ.save_image_grid(trip, path)
            self.metrics.log({"visualization": path}, self.global_step)
        return trip

    # ---------------------------------------------------------------- train --

    def train(self, combined_flow: Iterator[Dict[str, Dict]]) -> TrainState:
        generator = torch.Generator(device=self.device)
        generator.manual_seed(self.tr.seed)
        batch_time, data_time = AverageMeter(), AverageMeter()
        meters = {k: AverageMeter() for k in ("loss", "loss_t2i", "loss_lm", "loss_mmu")}
        end = time.time()
        per_step_samples = (self.tcfg.batch_size_t2i + self.tcfg.batch_size_lm
                            + self.tcfg.batch_size_mmu)
        # one-step-deferred meter updates: reading step N's metrics blocks on
        # the device, so it waits until step N + 1's batch is built and queued
        pending = None

        def _flush(metrics):
            for k, m in meters.items():
                if k in metrics:
                    m.update(metrics[k])

        for flow_batch in combined_flow:
            if self.global_step >= self.tr.max_train_steps:
                break
            batch = self.build_device_batch(flow_batch)
            data_time.update(time.time() - end)
            if pending is not None:
                _flush(pending)
            self.state, metrics = self.step_fn(self.state, self.vq_params, batch, generator)
            pending = metrics
            self.global_step += 1
            batch_time.update(time.time() - end)
            end = time.time()

            if self.global_step % self.tr.log_every == 0:
                logs = {k: m.avg for k, m in meters.items()}
                logs.update({
                    "avg_masking_rate": float(metrics["avg_masking_rate"]),
                    "grad_norm": float(metrics["grad_norm"]),
                    # the window's average: the meters reset with each log
                    "samples_per_sec_per_device": per_step_samples / max(batch_time.avg, 1e-9),
                    "data_time": data_time.avg,
                    "batch_time": batch_time.avg,
                })
                if process_index() == 0:   # the metrics are the batch group's on every rank
                    self.metrics.log(logs, self.global_step)
                    logger.info(f"step {self.global_step}: loss={logs['loss']:.4f} "
                                f"({logs['samples_per_sec_per_device']:.2f} samples/s/dev)")
                for m in (*meters.values(), batch_time, data_time):
                    m.reset()

            if self.tr.save_every and self.global_step % self.tr.save_every == 0:
                self._save()
            if (self.generate_callback and self.tr.generate_every
                    and self.global_step % self.tr.generate_every == 0):
                self.generate_callback(self.state.params, self.global_step)
            if (self.tr.visualize_every and self.tcfg.batch_size_t2i > 0
                    and self.global_step % self.tr.visualize_every == 0):
                self._visualize(batch, generator)

        # save_every == 0 disables checkpointing, the final save included
        if self.tr.save_every:
            self._save()
        return self.state
