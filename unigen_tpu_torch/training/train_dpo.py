"""The DPO entry point: image-preference tuning.

Counterpart of ``scripts/train_dpo.py``. Usage::

    python -m unigen_tpu_torch.training.train_dpo config=configs/unigen_1_5b/unigen_dpo.yaml \\
        dataset.synthetic=true [device=cpu]

Models from ``launch.build_unigen`` / ``build_vq`` (the SFT stage's
``checkpoint-N`` through ``model.unigen.pretrained_model_path`` when it
exists, else random); ``cuda`` unless ``device=cpu``, raising without a
card. ``dataset.synthetic=true`` draws JAX's synthetic pairs; else the
pairs are read from disk as ``scripts/train_dpo.py:100-107`` reads them
(``real_pairs``: ``data/dpo_data.py::DPODataset`` over
``dataset.params.dpo_data_path`` and the images under
``dataset.params.dpo_image_root``, ``training.num_epoch`` passes, each
reshuffled, read two batches ahead on a background thread).

The reference: with ``training.precompute_ref`` on a deterministic flow
(not the synthetic one, as in JAX) a forward-only pass over the whole
schedule computes every step's reference log-probs before training, each
with a fingerprint of its batch, and no second model is kept; else the
online reference, a frozen copy of the initial parameters. The schedule
(``step_schedule``) re-seeds the prompting's dropout RNG at each pass and
derives each step's chosen and rejected masking draws from (seed, step), so
both passes see the same batches and draws. Resume from the latest
checkpoint skips the schedule up to the resumed step. Checkpoints as the SFT
entry's (``save_every: 0`` writes none).
"""
from __future__ import annotations

import dataclasses
import os
import sys
import time
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import weights as W
from ..data.prefetch import prefetch
from ..device import resolve_device, to_device
from ..launch import build_prompting_from_config, build_unigen, build_vq, load_tokenizer
from ..ops import masking as MK
from ..ops.sampling import derived_generator
from ..utils import checkpoint as CK
from ..utils.configuration import initialize_config
from ..utils.logging import MetricLogger, get_logger
from . import lr_schedules as LRS
from .dpo import DPOConfig, make_dpo_step, make_ref_logps_fn
from .optimizer import make_optimizer
from .sft import init_sft_state

logger = get_logger("train_dpo")


def real_pairs(config) -> Iterator[Dict]:
    """Pair batches read from disk, ``training.num_epoch`` passes over one
    ``DPODataset`` (each pass reshuffled by the dataset's RNG)."""
    from ..data.dpo_data import DPODataset
    from .train import data_files
    params, tr = config.dataset.get("params") or {}, config.training
    ds = DPODataset(data_files(config, "dpo_data_path"), params.get("dpo_image_root", ""),
                    per_device_batch_size=tr.batch_size_t2i,
                    resolution=config.dataset.preprocessing.resolution)
    for _ in range(tr.get("num_epoch", 1)):
        yield from iter(ds)


def batch_fingerprint(batch: Dict, keys: Optional[Sequence[str]] = None) -> Tuple:
    """A cheap content check that a pass sees the other pass's batch k at
    step k (a loader that skips an unreadable image shifts every later
    batch): for each of ``keys`` (default every key, sorted), the sum of an
    integer tensor or the float64 sum of a float one, on its own device.
    Arrays are taken as tensors, so a host batch and its copy on the CPU
    give the same fingerprint."""
    out = []
    for k in sorted(keys if keys is not None else batch):
        t = batch[k]
        t = t if isinstance(t, torch.Tensor) else torch.as_tensor(np.asarray(t))
        out.append(float(t.double().sum()) if t.is_floating_point() else int(t.sum()))
    return tuple(out)


class DPORun:
    """The entry's state built from a run's config; ``train()`` runs the loop."""

    def __init__(self, config):
        self.config = config
        self.device = resolve_device(config.get("device"))
        self.prompting = build_prompting_from_config(config, load_tokenizer(config))
        params, self.cfg = build_unigen(config, self.prompting, None, self.device)
        self.vq_params, self.vq_cfg = build_vq(config, None, self.device)
        tr = config.training
        self.use_precomputed = bool(tr.get("precompute_ref", False)) \
            and not config.dataset.get("synthetic", False)
        # the frozen initial parameters (the state trains a copy): the online
        # reference, or the precompute pass's model, released after it
        self.ref_params = params
        schedule = LRS.get_scheduler(config.lr_scheduler.scheduler,
                                     num_warmup_steps=config.lr_scheduler.params.warmup_steps,
                                     num_training_steps=tr.get("max_train_steps", 10000))
        opt = config.optimizer.params
        self.tx = make_optimizer(params, float(opt.learning_rate), schedule,
                                 beta1=float(opt.beta1), beta2=float(opt.beta2),
                                 epsilon=float(opt.epsilon),
                                 weight_decay=float(opt.weight_decay),
                                 max_grad_norm=tr.get("max_grad_norm"))
        sp = self.prompting.sptids_dict
        self.dcfg = DPOConfig(beta=tr.get("beta", 0.1), dpo_coef=tr.get("dpo_coef", 1.0),
                              min_masking_rate=tr.get("min_masking_rate", 0.0),
                              pad_id=self.prompting.pad_id, soi_id=sp["<|soi|>"],
                              eoi_id=sp["<|eoi|>"], max_grad_norm=tr.get("max_grad_norm"),
                              remat=config.model.get("gradient_checkpointing", False),
                              precomputed_ref=self.use_precomputed)
        self.step = make_dpo_step(self.cfg, self.vq_cfg, self.tx, self.dcfg)
        self.state = init_sft_state(params, self.tx)
        self.resume_from = 0
        want = config.experiment.get("resume_from_checkpoint")
        if want:
            path = CK.latest_checkpoint(config.experiment.output_dir) if want == "latest" else want
            if path and os.path.isdir(os.path.join(path, "state")):
                logger.info(f"resuming from checkpoint {path}")
                self.state = CK.restore_checkpoint(path, self.state)
                self.resume_from = CK.resume_step(path)
        self.global_step = 0
        self.metrics_log = MetricLogger(config.experiment.output_dir)
        self.ref_cache: Optional[List] = None

    def pairs(self) -> Iterator[Dict]:
        """The flow of pair batches: JAX's synthetic ones with
        ``dataset.synthetic``, else the files' (``real_pairs``, read ahead on
        a background thread), from the start at each call."""
        if not self.config.dataset.get("synthetic", False):
            return prefetch(real_pairs(self.config))
        return self._synthetic_pairs()

    def _synthetic_pairs(self) -> Iterator[Dict]:
        rng = np.random.default_rng(0)
        res, b = self.config.dataset.preprocessing.resolution, self.config.training.batch_size_t2i
        while True:
            yield {"batch_prompt_list": ["a red cat"] * b,
                   "batch_chosen_image": rng.normal(size=(b, res, res, 3)).astype(np.float32),
                   "batch_rejected_image": rng.normal(size=(b, res, res, 3)).astype(np.float32)}

    def draws(self, step: int) -> Tuple[MK.MaskDraws, MK.MaskDraws]:
        """Step ``step``'s chosen and rejected masking draws, from (seed, step)."""
        gen = derived_generator(self.config.training.get("seed", 10084), step,
                                device=self.device)
        b, n = self.config.training.batch_size_t2i, self.cfg.num_vq_tokens
        return tuple(MK.draw_masking(gen, b, n, codebook_size=self.cfg.codebook_size,
                                     device=self.device) for _ in range(2))

    def step_schedule(self, pairs: Optional[Iterator[Dict]] = None):
        """(device batch, draws) a step, deterministic: the prompting's
        dropout RNG is re-seeded at the start of every pass."""
        tr = self.config.training
        self.prompting.rng = np.random.default_rng(tr.get("seed", 10084))
        max_steps = tr.get("max_train_steps", None)
        b, n = tr.batch_size_t2i, self.cfg.num_vq_tokens
        placeholder = np.zeros((b, n), np.int64)
        for gs, batch in enumerate(pairs if pairs is not None else self.pairs()):
            if max_steps and gs >= max_steps:
                return
            ids, _, labels = self.prompting((batch["batch_prompt_list"], placeholder,
                                             placeholder), "t2i")
            host = {"template": ids, "labels": labels,
                    "chosen_pixels": batch["batch_chosen_image"],
                    "rejected_pixels": batch["batch_rejected_image"]}
            yield {k: to_device(v, self.device) for k, v in host.items()}, self.draws(gs)

    def precompute(self, pairs: Optional[Iterator[Dict]] = None) -> List:
        """The reference log-probs of every step of the schedule from the
        initial parameters, with each batch's fingerprint; the step then
        takes them from the batch (``precomputed_ref``) and the reference
        model is released."""
        ref_fn = make_ref_logps_fn(self.cfg, self.vq_cfg, self.dcfg)
        t0 = time.time()
        self.ref_cache = [(batch_fingerprint(db), ref_fn(self.ref_params, self.vq_params, db,
                                                         draws))
                          for db, draws in self.step_schedule(pairs)]
        self.ref_params = None
        self.dcfg = dataclasses.replace(self.dcfg, precomputed_ref=True)
        self.step = make_dpo_step(self.cfg, self.vq_cfg, self.tx, self.dcfg)
        logger.info(f"precomputed reference logps for {len(self.ref_cache)} steps in "
                    f"{time.time() - t0:.1f}s (forward-only pass; the reference model is "
                    "now released)")
        return self.ref_cache

    def save(self):
        with torch.no_grad():
            export = W.unigen_to_jax(self.state.params, self.cfg)
        CK.save_checkpoint(self.state, self.config.experiment.output_dir, self.global_step,
                           unwrapped_params=export)

    def train(self, pairs_fn=None):
        """The loop (``pairs_fn()`` gives a fresh flow for each pass); returns
        the state."""
        if self.use_precomputed and self.ref_cache is None:
            self.precompute(pairs_fn() if pairs_fn else None)
        exp = self.config.experiment
        save_every, log_every = exp.get("save_every", 500), exp.get("log_every", 20)
        self.global_step = 0
        for batch, draws in self.step_schedule(pairs_fn() if pairs_fn else None):
            if self.global_step < self.resume_from:
                self.global_step += 1
                continue
            if self.ref_cache is not None:
                if self.global_step >= len(self.ref_cache):
                    raise RuntimeError(
                        f"training pass yielded more steps than the reference precompute pass "
                        f"({len(self.ref_cache)}): the dataset did not replay identically")
                fp, refs = self.ref_cache[self.global_step]
                if fp != batch_fingerprint(batch):
                    raise RuntimeError(
                        f"step {self.global_step}: batch does not match the reference precompute "
                        "pass: the dataset did not replay identically; rerun or disable "
                        "precompute_ref")
                batch = {**batch, **refs}
            self.state, metrics = self.step(self.state, self.ref_params, self.vq_params, batch,
                                            draws)
            self.global_step += 1
            if self.global_step % log_every == 0:
                self.metrics_log.log(metrics, self.global_step)
                logger.info(f"step {self.global_step}: dpo_loss={float(metrics['loss']):.4f} "
                            f"acc={float(metrics['reward_accuracy']):.3f}")
            if save_every and self.global_step % save_every == 0:
                self.save()
        if save_every:
            self.save()
        return self.state


def main(argv=None) -> int:
    overrides = sys.argv[1:] if argv is None else list(argv)
    cfg_path = next((o.split("=", 1)[1] for o in overrides if o.startswith("config=")), None)
    config = initialize_config(cfg_path, overrides)
    DPORun(config).train()
    return 0


if __name__ == "__main__":
    sys.exit(main())
