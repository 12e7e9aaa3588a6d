"""The SFT entry point: t2i + lm + SigLIP conversations (and, with
``model.lora.rank``, LoRA SFT).

Counterpart of ``scripts/train_sft.py``. Usage::

    python -m unigen_tpu_torch.training.train_sft config=configs/unigen_1_5b/unigen_sft.yaml \\
        dataset.synthetic=true [device=cpu]

The config and its overrides are read by ``utils/configuration.py``; the
models come from ``launch.build_unigen`` / ``build_vq`` /
``build_vision_tower`` (``model.unigen.pretrained_model_path``, the previous
stage's ``checkpoint-N``, when it exists, else random from a seed). It runs
on ``cuda``; ``device=cpu`` is the only way onto the CPU, and without a card
it raises. ``dataset.synthetic=true`` draws JAX's synthetic batches (the
same numpy draws, the conversations through ``data/llava.py``). Else
``real_batches`` reads the flows from disk as ``scripts/train_sft.py:155-171``
does: t2i from the tar shards of ``dataset.params.train_t2i_shards_path_or_url``
(``data/text2image.py``), the conversations from the JSON files of
``dataset.params.llava_data_paths`` and the images under
``dataset.params.llava_image_root`` (``data/llava.py::LlavaDataset``, collated
to 512 tokens), the lm rows empty strings. Two differences from JAX's entry:
the conversations' images go through the NaFlex processor when the tower is
SigLIP2-NaFlex and are resized to the SigLIP tower's own size otherwise
(JAX's always take the SigLIP processor at 384 px, the flagship tower's
size), and only the flows whose
batch size is above 0 are built (JAX's builds the t2i flow at
``batch_size_t2i: 0`` too, which never yields; the CoT-V post-SFT stage has
no t2i shards). The files' batches are read two ahead on a background
thread (``data/prefetch.py``).

Per step the host assembles the t2i / lm templates and the mmu ``part1``
(``[<|im_start|>, <|mmu|>, <|soi|>]``), ``part2`` (``<|eoi|>`` + the
conversation), the mmu labels and ``prompt_len`` (scripts/train_sft.py:
183-206). ``common_length`` is resolved from the first batch: the mmu splice
length when it covers the t2i / lm rows (one backbone call, packed rows),
else None (separate calls), and logged as JAX logs it.

With a SigLIP2-NaFlex tower (``model.vision_tower.name`` naming siglip2 and
naflex), which JAX's entry does not take, the synthetic conversations carry
uint8 images of three aspects (384 x 384, 256 x 512, 640 x 256) through
``data.transform.naflex_preprocess`` (patches padded to the tower's budget)
and the batch their patches, masks, spatial shapes and the resized position
embeddings (``SFTRun.device_batch``), the fields of ``SFTStep``'s NaFlex
branch.

``model.lora.{rank, alpha, targets, extra_tunable, merge_on_save, seed}``
puts adapters on the backbone (``training/lora.py``), trains them and
``extra_tunable`` (the projector by default), and with ``merge_on_save``
exports merged base weights; the targets must then have a float base
(checked at launch). Checkpoints: ``checkpoint-<step>/{state,
unwrapped_model}`` every ``experiment.save_every`` steps and at the end
(``save_every: 0`` writes none, as the port's Trainer); resume from
``experiment.resume_from_checkpoint`` (``latest``).
"""
from __future__ import annotations

import dataclasses
import os
import sys
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from .. import weights as W
from ..data.llava import collate_batch, preprocess_qwen
from ..data.prefetch import prefetch
from ..data.transform import naflex_preprocess
from ..device import resolve_device, to_device
from ..launch import (build_prompting_from_config, build_unigen, build_vision_tower, build_vq,
                      load_tokenizer)
from ..models import siglip2
from ..utils import checkpoint as CK
from ..utils.configuration import initialize_config
from ..utils.logging import MetricLogger, get_logger
from . import lora as LORA
from . import lr_schedules as LRS
from .optimizer import make_optimizer
from .sft import SFTStep, SFTStepConfig, init_sft_state, make_sft_train_step

logger = get_logger("train_sft")


def real_batches(config, prompting, vs_cfg) -> Iterator[Dict]:
    """The SFT flows read from disk (scripts/train_sft.py:155-171): t2i
    batches from ``Text2ImageDataset``, conversations from
    ``LlavaDataset`` (``siglip`` mode at the tower's image size, or
    ``naflex`` with the tower's patch size and budget), joined by
    ``combined_loader``; lm rows of empty strings. A task of batch size 0
    gets an empty batch and no dataset."""
    from ..data.combined import combined_loader
    from ..data.llava import LlavaDataset
    from ..data.text2image import Text2ImageDataset
    from .train import data_files
    params, tr = config.dataset.get("params") or {}, config.training
    res = config.dataset.preprocessing.resolution
    if not tr.batch_size_mmu:
        raise ValueError("SFT needs training.batch_size_mmu > 0")
    if isinstance(vs_cfg, siglip2.Siglip2Config):
        visual = dict(visual_mode="naflex", naflex_patch_size=vs_cfg.patch_size,
                      naflex_max_patches=vs_cfg.num_patches)
    else:
        visual = dict(visual_mode="siglip", siglip_image_size=vs_cfg.image_size)
    flows = {"mmu": iter(LlavaDataset(
        data_files(config, "llava_data_paths"), params.get("llava_image_root", ""),
        prompting.text_tokenizer, per_device_batch_size=tr.batch_size_mmu, **visual))}
    if tr.batch_size_t2i:
        flows["t2i"] = ({"images": b["images"], "texts": b["input_ids"]}
                        for b in Text2ImageDataset(
                            data_files(config, "train_t2i_shards_path_or_url"),
                            per_device_batch_size=tr.batch_size_t2i, resolution=res))
    no_t2i = {"images": np.zeros((0, res, res, 3), np.float32), "texts": []}
    for b in combined_loader(flows):
        yield {"t2i": b.get("t2i", no_t2i), "mmu": b["mmu"],
               "lm": {"texts": [""] * tr.batch_size_lm}}


# (H, W) of the NaFlex synthetic conversations' images, a row each in turn
NAFLEX_SYNTHETIC_SIZES = ((384, 384), (256, 512), (640, 256))


def synthetic_batches(config, prompting, vs_cfg) -> Iterator[Dict]:
    """JAX's synthetic SFT flows (the same numpy draws): captions, one
    document and a one-turn conversation a row, random pixels; the
    conversations collated to 64 tokens."""
    rng = np.random.default_rng(0)
    tr, res = config.training, config.dataset.preprocessing.resolution
    n_grid = tr.get("n_grid", 0)
    naflex = isinstance(vs_cfg, siglip2.Siglip2Config)
    vres = None if naflex else vs_cfg.image_size * (n_grid if n_grid else 1)
    bt, bl, bm = tr.batch_size_t2i, tr.batch_size_lm, tr.batch_size_mmu
    tok = prompting.text_tokenizer

    def image(i):
        if not naflex:
            return rng.normal(size=(vres, vres, 3)).astype(np.float32)
        h, w = NAFLEX_SYNTHETIC_SIZES[i % len(NAFLEX_SYNTHETIC_SIZES)]
        return naflex_preprocess(rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8),
                                 vs_cfg.patch_size, vs_cfg.num_patches)
    while True:
        conv = [{"from": "human", "value": "what is this?"}, {"from": "gpt", "value": "a cat"}]
        proc = preprocess_qwen([conv] * bm, tok)
        samples = [{"input_ids": proc["input_ids"][i], "labels": proc["labels"][i],
                    "image": image(i)} for i in range(bm)]
        mmu = collate_batch(samples, prompting.pad_id, max_length=64)
        yield {"t2i": {"images": rng.normal(size=(bt, res, res, 3)).astype(np.float32),
                       "texts": ["a red cat"] * bt},
               "lm": {"texts": ["some document"] * bl},
               "mmu": mmu}


def host_batch(prompting, num_vq_tokens: int, vs_cfg, n_grid: int,
               fb: Dict) -> Dict[str, np.ndarray]:
    """One flow batch -> the step's host arrays: the t2i / lm templates,
    the mmu part1 (the prompt head), part2 (``<|eoi|>`` + the conversation
    after its first token), labels (-100 up to and including ``<|eoi|>``)
    and prompt_len (scripts/train_sft.py:183-206); NaFlex conversations
    give their patches, masks and spatial shapes (``mmu_pixel_values``,
    ``mmu_pixel_attention_mask``, ``mmu_spatial_shapes``) and as many image
    tokens as patch slots."""
    pr, n = prompting, num_vq_tokens
    placeholder = np.zeros((len(fb["t2i"]["texts"]), n), np.int64)
    ids, _, labels = pr((fb["t2i"]["texts"], placeholder, placeholder), "t2i")
    lm_ids, _, lm_labels = pr((fb["lm"]["texts"], pr.max_seq_len), "lm")
    mmu = fb["mmu"]
    b = mmu["input_ids"].shape[0]
    head = [pr.sptids_dict[t] for t in
            (("<|mmu|>", "<|im_start|>", "<|soi|>") if pr.task_token_first
             else ("<|im_start|>", "<|mmu|>", "<|soi|>"))]
    part1 = np.tile(np.asarray(head, np.int64), (b, 1))
    part2 = np.concatenate([np.full((b, 1), pr.sptids_dict["<|eoi|>"]),
                            mmu["input_ids"][:, 1:]], axis=1)
    naflex = "spatial_shapes" in mmu
    p_tokens = mmu["images"].shape[1] if naflex else (vs_cfg.image_size // vs_cfg.patch_size) ** 2
    if n_grid:
        p_tokens *= 1 + n_grid ** 2
    mmu_labels = np.concatenate([np.full((b, 3 + p_tokens + 1), -100),
                                 mmu["labels"][:, 1:]], axis=1)
    prompt_len = np.full((b,), part1.shape[1] + p_tokens + part2.shape[1])
    out = {"t2i_template": ids, "t2i_labels": labels, "t2i_pixels": fb["t2i"]["images"],
           "lm_ids": lm_ids, "lm_labels": lm_labels, "mmu_part1": part1, "mmu_part2": part2,
           "mmu_labels": mmu_labels, "mmu_prompt_len": prompt_len}
    if naflex:
        out.update(mmu_pixel_values=mmu["images"], mmu_spatial_shapes=mmu["spatial_shapes"],
                   mmu_pixel_attention_mask=mmu["pixel_attention_mask"])
    else:
        out["mmu_pixels"] = mmu["images"]
    return out


class SFTRun:
    """The entry's state: models, optimizer, step and trainer state, built
    from a run's config; ``train()`` runs the loop."""

    def __init__(self, config):
        self.config = config
        self.device = resolve_device(config.get("device"))
        tokenizer = load_tokenizer(config)
        self.prompting = build_prompting_from_config(config, tokenizer)
        params, self.cfg = build_unigen(config, self.prompting, None, self.device)
        self.vq_params, self.vq_cfg = build_vq(config, None, self.device)
        self.vs_params, self.vs_cfg = build_vision_tower(config, None, self.device)
        if self.vs_cfg is None:
            raise ValueError("SFT needs model.vision_tower.name")
        params = self._lora(params)
        tr = config.training
        schedule = LRS.get_scheduler(config.lr_scheduler.scheduler,
                                     num_warmup_steps=config.lr_scheduler.params.warmup_steps,
                                     num_training_steps=tr.max_train_steps)
        opt = config.optimizer.params
        lr_mapper = config.model.get("lr_mapper", None)
        tunable = config.model.get("mm_tunable_parts", None)
        self.tx = make_optimizer(
            params, float(opt.learning_rate), schedule, beta1=float(opt.beta1),
            beta2=float(opt.beta2), epsilon=float(opt.epsilon),
            weight_decay=float(opt.weight_decay), max_grad_norm=tr.get("max_grad_norm"),
            tunable_parts=tunable.split(",") if isinstance(tunable, str) else tunable,
            lr_mapper=dict(lr_mapper) if lr_mapper else None)
        sp = self.prompting.sptids_dict
        self.tcfg = SFTStepConfig(
            batch_size_t2i=tr.batch_size_t2i, batch_size_lm=tr.batch_size_lm,
            batch_size_mmu=tr.batch_size_mmu,
            t2i_coeff=tr.get("t2i_coeff", 1.0), lm_coeff=tr.get("lm_coeff", 0.1),
            mmu_coeff=tr.get("mmu_coeff", 1.0), min_masking_rate=tr.get("min_masking_rate", 0.0),
            max_grad_norm=tr.get("max_grad_norm"), pad_id=self.prompting.pad_id,
            soi_id=sp["<|soi|>"], eoi_id=sp["<|eoi|>"], n_grid=tr.get("n_grid", 0),
            remat=config.model.get("gradient_checkpointing", False))
        self.step: Optional[SFTStep] = None
        self.state = init_sft_state(params, self.tx)
        self.global_step = 0
        want = config.experiment.get("resume_from_checkpoint")
        if want:
            path = CK.latest_checkpoint(config.experiment.output_dir) if want == "latest" else want
            if path and os.path.isdir(os.path.join(path, "state")):
                logger.info(f"resuming from checkpoint {path}")
                self.state = CK.restore_checkpoint(path, self.state)
                self.global_step = CK.resume_step(path)
        self.metrics_log = MetricLogger(config.experiment.output_dir)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(tr.get("seed", 10084))

    def _lora(self, params):
        """Adapters on the backbone when ``model.lora.rank`` > 0; the
        optimizer then trains them and ``extra_tunable``."""
        lora_cfg = self.config.model.get("lora", {}) or {}
        rank = int(lora_cfg.get("rank", 0) or 0)
        self.merge_on_save = False
        if rank <= 0:
            return params
        targets = tuple(lora_cfg.get("targets") or LORA.DEFAULT_TARGETS)
        self.merge_on_save = bool(lora_cfg.get("merge_on_save", False))
        if self.merge_on_save:
            layer = params["llm"]["layers"][0]
            for tgt in targets:
                if f"{LORA.target_name(tgt)}_w" not in layer:
                    raise ValueError(
                        f"model.lora.merge_on_save=true but target '{tgt}' has an int8-only base "
                        "(QLoRA): merging would change the quantization grid. Train with "
                        "merge_on_save=false and keep adapters on the runtime path, or use a "
                        "bf16 base.")
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(lora_cfg.get("seed", 7)))
        alpha = lora_cfg.get("alpha")
        params = dict(params, llm=LORA.add_lora(params["llm"], gen, rank,
                                                alpha=float(alpha) if alpha is not None else None,
                                                targets=targets))
        extra = lora_cfg.get("extra_tunable", ["mm_projector"])
        self.config.model.mm_tunable_parts = list(LORA.lora_tunable_parts()) + list(extra or [])
        logger.info(f"LoRA rank {rank}: {LORA.lora_param_count(params['llm']):,} adapter params; "
                    f"tunable = {self.config.model.mm_tunable_parts}")
        return params

    # ------------------------------------------------------------- batches --

    def batches(self) -> Iterator[Dict]:
        """The flows: JAX's synthetic batches with ``dataset.synthetic``,
        else the files' (``real_batches``), read ahead on a background
        thread."""
        if self.config.dataset.get("synthetic", False):
            return synthetic_batches(self.config, self.prompting, self.vs_cfg)
        return prefetch(real_batches(self.config, self.prompting, self.vs_cfg))

    def device_batch(self, fb: Dict) -> Dict[str, torch.Tensor]:
        """One flow batch -> the step's tensors on the device (NaFlex rows
        with their position embeddings resized to each image's grid)."""
        host = host_batch(self.prompting, self.cfg.num_vq_tokens, self.vs_cfg,
                          self.tcfg.n_grid, fb)
        batch = {k: to_device(v, self.device) for k, v in host.items()}
        if "mmu_spatial_shapes" in host:
            batch["mmu_pos_embeds"] = siglip2.resize_positional_embeddings(
                self.vs_params["pos_embed"], host["mmu_spatial_shapes"],
                host["mmu_pixel_values"].shape[1])
        return batch

    def resolve_step(self, batch: Dict[str, torch.Tensor]) -> SFTStep:
        """The step for the first batch's lengths: ``common_length`` is the
        mmu splice length when it covers the t2i / lm rows (and a t2i / lm
        group exists), else None."""
        tcfg = self.tcfg
        mmu_len = batch["mmu_labels"].shape[1]       # part1 + image tokens + part2
        tl_lens = [batch[k].shape[1] for k, bs in (("t2i_template", tcfg.batch_size_t2i),
                                                   ("lm_ids", tcfg.batch_size_lm)) if bs > 0]
        common = int(mmu_len) if tl_lens and mmu_len >= max(tl_lens) else None
        logger.info(f"SFT step mode: common_length={common} (mmu {mmu_len}, t2i/lm {tl_lens})")
        self.common_length = common
        self.step = make_sft_train_step(self.cfg, self.vq_cfg, self.vs_cfg, self.tx,
                                        dataclasses.replace(tcfg, common_length=common))
        return self.step

    # --------------------------------------------------------------- train --

    def save(self, final: bool = False):
        params = self.state.params
        if final and self.merge_on_save:
            params = dict(params, llm=LORA.merge_lora(params["llm"]))
            logger.info("merged LoRA adapters into the exported base weights")
        with torch.no_grad():
            export = W.unigen_to_jax(params, self.cfg)
        CK.save_checkpoint(self.state, self.config.experiment.output_dir, self.global_step,
                           total_limit=self.config.experiment.get("checkpoints_total_limit"),
                           unwrapped_params=export)

    def train(self, batches: Optional[Iterator[Dict]] = None):
        """The loop to ``training.max_train_steps``; returns the state."""
        exp, tr = self.config.experiment, self.config.training
        save_every, log_every = exp.get("save_every", 10000), exp.get("log_every", 50)
        for fb in batches if batches is not None else self.batches():
            if self.global_step >= tr.max_train_steps:
                break
            batch = self.device_batch(fb)
            if self.step is None:
                self.resolve_step(batch)
            self.state, metrics = self.step(self.state, self.vq_params, self.vs_params, batch,
                                            self.generator)
            self.global_step += 1
            if self.global_step % log_every == 0:
                self.metrics_log.log(metrics, self.global_step)
                logger.info(f"step {self.global_step}: loss={float(metrics['loss']):.4f}")
            if save_every and self.global_step % save_every == 0:
                self.save()
        if save_every:
            self.save(final=True)
        return self.state


def main(argv=None) -> int:
    overrides = sys.argv[1:] if argv is None else list(argv)
    cfg_path = next((o.split("=", 1)[1] for o in overrides if o.startswith("config=")), None)
    config = initialize_config(cfg_path, overrides)
    SFTRun(config).train()
    return 0


if __name__ == "__main__":
    sys.exit(main())
