"""The unified pretraining entry point: a run's config -> models -> Trainer.

Counterpart of ``scripts/train.py``. Usage::

    python -m unigen_tpu_torch.training.train config=configs/unigen_1_5b/unigen_pt1.yaml \\
        training.max_train_steps=100 dataset.synthetic=true [device=cpu]

The config is read by ``utils/configuration.py`` and the models built by
``launch.build_unigen`` / ``build_vq`` (random from a seed where no
checkpoint is on disk, logged). It runs on ``cuda``; ``device=cpu`` is the
only way onto the CPU, and without a card the entry raises.
``dataset.synthetic=true`` draws the three task flows as
``scripts/train.py::synthetic_flows`` does (the same numpy draws). Else the
flows are read from disk as ``scripts/train.py::real_flows`` reads them
(``real_flows``): t2i and mmu from the tar shards of
``dataset.params.train_{t2i,mmu}_shards_path_or_url`` (``data/text2image.py``,
the native streamer), lm from the parquet files of
``dataset.params.train_lm_shards_path_or_url`` (``data/lm_data.py``, which
needs pyarrow), joined by ``data/combined.py::combined_loader`` and read two
batches ahead on a background thread (``data/prefetch.py``), so that the
decode overlaps the step, as the reference's DataLoader workers do.
"""
from __future__ import annotations

import sys
from typing import Dict, Iterator, List, Optional

import numpy as np

from ..device import resolve_device
from ..launch import build_prompting_from_config, build_unigen, build_vq, load_tokenizer
from ..utils import multihost
from ..utils.configuration import initialize_config
from . import lr_schedules as LRS
from .optimizer import make_optimizer
from .train_step import TrainStepConfig
from .trainer import Trainer, TrainerConfig

CAPTIONS = ("a photo of a red cat", "two dogs on grass", "a blue car",
            "a bowl of fruit on a table")


def synthetic_flows(config, n_batches: Optional[int] = None) -> Iterator[dict]:
    """Random t2i / lm / mmu batches of the configured sizes (the JAX
    entry's, draw for draw)."""
    rng = np.random.default_rng(0)
    res = config.dataset.preprocessing.resolution
    bt, bl, bm = (config.training.batch_size_t2i, config.training.batch_size_lm,
                  config.training.batch_size_mmu)
    i = 0
    while n_batches is None or i < n_batches:
        batch = {}
        if bt:
            batch["t2i_flow"] = {
                "images": rng.normal(size=(bt, res, res, 3)).astype(np.float32),
                "input_ids": [CAPTIONS[j % len(CAPTIONS)] for j in range(bt)]}
        if bl:
            batch["lm_flow"] = {"input_ids": [f"document {i}-{j} text" for j in range(bl)]}
        if bm:
            batch["mmu_flow"] = {
                "images": rng.normal(size=(bm, res, res, 3)).astype(np.float32),
                "input_ids": [CAPTIONS[(j + 1) % len(CAPTIONS)] for j in range(bm)]}
        yield batch
        i += 1


def data_files(config, key: str) -> List[str]:
    """``dataset.params.<key>`` as a list of paths (a string is one path);
    raises naming the key when it names none."""
    value = (config.dataset.get("params") or {}).get(key)
    files = [value] if isinstance(value, str) else list(value or [])
    if not files:
        raise ValueError(f"dataset.synthetic is not set and dataset.params.{key} names no "
                         "files: give the data's paths, or run with dataset.synthetic=true")
    return files


def task_flows(config) -> Dict[str, object]:
    """The datasets of ``scripts/train.py::real_flows``, one a task whose
    batch size is above 0: ``Text2ImageDataset`` for t2i and mmu (the mmu
    captions with the caption prompt when ``add_caption_prompt``),
    ``ParquetTextDataset`` for lm, its rows sharded by the rank and world
    size of ``torch.distributed`` when it is initialised."""
    from ..data.lm_data import ParquetTextDataset
    from ..data.text2image import Text2ImageDataset
    params, tr = config.dataset.get("params") or {}, config.training
    res = config.dataset.preprocessing.resolution
    flows = {}
    if tr.batch_size_t2i:
        flows["t2i_flow"] = Text2ImageDataset(
            data_files(config, "train_t2i_shards_path_or_url"),
            per_device_batch_size=tr.batch_size_t2i, resolution=res,
            short_caption_ratio=params.get("t2i_short_caption_ratio", 0.5))
    if tr.batch_size_lm:
        flows["lm_flow"] = ParquetTextDataset(
            data_files(config, "train_lm_shards_path_or_url"),
            per_device_batch_size=tr.batch_size_lm,
            process_index=multihost.process_index(), process_count=multihost.process_count())
    if tr.batch_size_mmu:
        flows["mmu_flow"] = Text2ImageDataset(
            data_files(config, "train_mmu_shards_path_or_url"),
            per_device_batch_size=tr.batch_size_mmu, resolution=res,
            add_caption_prompt=params.get("add_caption_prompt", False))
    return flows


def real_flows(config, prompting=None) -> Iterator[dict]:
    """The task flows read from disk (``task_flows``), joined by
    ``combined_loader``: ``scripts/train.py::real_flows`` (whose
    ``prompting`` argument is unused there too), read ahead on a background
    thread (``data/prefetch.py``)."""
    from ..data.combined import combined_loader
    from ..data.prefetch import prefetch
    return prefetch(combined_loader(task_flows(config)))


def build_trainer(config, dtype=None, mesh=None, fsdp: bool = False) -> Trainer:
    """The Trainer a run's config describes, on ``config.device`` (cuda by
    default); with a ``mesh`` (``parallel.make_mesh``) sharded on it."""
    device = resolve_device(config.get("device"))
    prompting = build_prompting_from_config(config, load_tokenizer(config))
    params, cfg = build_unigen(config, prompting, dtype, device)
    vq_params, vq_cfg = build_vq(config, dtype, device)
    tr = config.training
    schedule = LRS.get_scheduler(config.lr_scheduler.scheduler,
                                 num_warmup_steps=config.lr_scheduler.params.warmup_steps,
                                 num_training_steps=tr.max_train_steps)
    lr_mapper = config.model.get("lr_mapper", None)
    tunable = config.model.get("mm_tunable_parts", None)
    opt = config.optimizer.params
    tx = make_optimizer(
        params, float(opt.learning_rate), schedule, beta1=float(opt.beta1),
        beta2=float(opt.beta2), epsilon=float(opt.epsilon),
        weight_decay=float(opt.weight_decay), max_grad_norm=tr.get("max_grad_norm"),
        tunable_parts=tunable.split(",") if isinstance(tunable, str) else tunable,
        lr_mapper=dict(lr_mapper) if lr_mapper else None)
    tcfg = TrainStepConfig(
        batch_size_t2i=tr.batch_size_t2i, batch_size_lm=tr.batch_size_lm,
        batch_size_mmu=tr.batch_size_mmu,
        t2i_coeff=tr.get("t2i_coeff", 1.0), lm_coeff=tr.get("lm_coeff", 0.1),
        mmu_coeff=tr.get("mmu_coeff", 1.0),
        min_masking_rate=tr.get("min_masking_rate", 0.0),
        noise_type=tr.get("noise_type", "mask"),
        use_causal_mask=config.model.get("use_causal_mask", False),
        t2i_gen_mode=config.model.get("t2i_gen_mode", "mask"),
        max_grad_norm=tr.get("max_grad_norm"),
        pad_id=prompting.pad_id,
        soi_id=prompting.sptids_dict["<|soi|>"],
        eoi_id=prompting.sptids_dict["<|eoi|>"],
        grad_accum_steps=tr.get("gradient_accumulation_steps", 1),
        remat=config.model.get("gradient_checkpointing", False))
    trainer_cfg = TrainerConfig(
        output_dir=config.experiment.output_dir,
        max_train_steps=tr.max_train_steps,
        log_every=config.experiment.get("log_every", 50),
        save_every=config.experiment.get("save_every", 2000),
        checkpoints_total_limit=config.experiment.get("checkpoints_total_limit"),
        resume_from_checkpoint=config.experiment.get("resume_from_checkpoint"),
        seed=tr.get("seed", 10084),
        und_type=config.dataset.get("und_type", "captioning"),
        ema_decay=tr.get("ema_decay", 0.0))
    return Trainer(cfg, vq_cfg, tcfg, trainer_cfg, prompting, tx, params, vq_params,
                   mesh=mesh, fsdp=fsdp)


def main(argv=None) -> int:
    overrides = sys.argv[1:] if argv is None else list(argv)
    cfg_path = next((o.split("=", 1)[1] for o in overrides if o.startswith("config=")), None)
    config = initialize_config(cfg_path, overrides)
    synthetic = config.dataset.get("synthetic", False)
    flows = None if synthetic else real_flows(config)
    trainer = build_trainer(config)
    trainer.train(synthetic_flows(config) if synthetic else flows)
    return 0


if __name__ == "__main__":
    sys.exit(main())
