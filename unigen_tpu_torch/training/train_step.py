"""The unified three-task train step.

Port of ``unigen_tpu/training/train_step.py``. The host supplies prompt
*templates* (``prompting.UniPrompting`` ids with zeros in the image block)
and raw pixels; the step encodes the pixels with the frozen MAGViTv2
(``magvit.get_code`` under ``torch.no_grad``: kernel 3 on the card),
corrupts the t2i codes (``ops.masking``), splices both image blocks into
their templates, runs the fused t2i + lm + mmu batch forward and backward,
weights the three losses, clips, applies AdamW in place and advances the
EMA. Nothing is read back to the host: the metrics are device tensors.

Sequence layouts (fixed positions, so a splice is a slice):
  t2i: image block at [-(n+1):-1]
  mmu: image block at [3:3+n]

Attention always runs through kernel 2 on the per-token bits of
``ops.masks`` (``t2i_attn_meta``, ``lm_attn_meta``,
``mmu_train_attn_meta``, joined by ``concat_meta``); with
``use_causal_mask`` every row gets the pad-only causal bits. JAX runs dense
[B, 1, L, L] masks by default (``use_flash_attention=False``); its own
test holds the two routes' losses to rtol 1e-4. A deliberate difference
(ROADMAP, "Deliberate differences").

Randomness: ``key`` is a ``torch.Generator`` (the masking draws come from
it on the device), a ``ops.masking.MaskDraws``, or with gradient
accumulation a list of one ``MaskDraws`` a micro-batch (JAX's
``jax.random.split(key, a)`` streams).

One path runs every state (``batch_grads`` then ``apply_update``, shared
with the SFT and DPO steps). A sharded state (``init_train_state(..., sharding=)`` over the
local shards of ``parallel.shard_params``) takes the same global batch and
key: inside ``collectives.batch_sharded`` each rank takes its rows of the
batch group (data, fsdp) of every micro-batch (``collectives.local_rows``),
which removes the three differences from the unsharded step: the masking
draws are made for the global batch on every rank and sliced
(``global_draws``); every CE's valid count is summed over the batch group
before its division; and the gradients are summed over the batch group
(``collectives.sync_grads``), each rank's loss being its share of the
global mean. The metrics are summed the same way, the grad norm and the
clip are the whole tree's, and AdamW and the EMA run on the shards. With no
mesh each of these is the identity. The forwards take the state's spec
tree (``param_specs``, from ``TrainState.sharding``) beside its params.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Union

import torch

from ..models import magvit, unigen
from ..models.magvit import MagvitConfig
from ..models.unigen import UniGenConfig
from ..ops import masking as MK
from ..ops import masks as M
from ..ops import sampling as S
from ..parallel import collectives as C
from ..weights import map_tree
from .ema import EMAConfig, EMAState, ema_init, ema_update
from .optimizer import AdamW, OptState, global_norm, named_leaves

Key = Union[torch.Generator, MK.MaskDraws, List[MK.MaskDraws], None]
METRICS = ("loss", "loss_t2i", "loss_lm", "loss_mmu", "avg_masking_rate")


class TrainState(NamedTuple):
    params: Any              # the port's tree; every leaf requires grad
    opt_state: OptState
    step: torch.Tensor       # int32 [] on the parameters' device
    ema: Optional[EMAState] = None
    sharding: Optional[Any] = None   # parallel.partition.Sharding of local shards


@dataclasses.dataclass(frozen=True)
class TrainStepConfig:
    batch_size_t2i: int
    batch_size_lm: int
    batch_size_mmu: int
    t2i_coeff: float = 1.0
    lm_coeff: float = 0.1
    mmu_coeff: float = 1.0
    min_masking_rate: float = 0.0
    mask_contiguous_region_prob: Optional[float] = None
    noise_type: str = "mask"
    mask_schedule: str = "cosine"
    use_causal_mask: bool = False
    t2i_gen_mode: str = "mask"
    max_grad_norm: Optional[float] = None
    pad_id: int = 0
    soi_id: int = 1
    eoi_id: int = 2
    grad_accum_steps: int = 1
    remat: bool = False
    memory_efficient_loss: bool = True  # chunked CE: no [B, L, 160k] logits tensor


def init_train_state(params: Any, tx: AdamW, ema_cfg: Optional[EMAConfig] = None,
                     sharding: Optional[Any] = None) -> TrainState:
    """A state over a copy of ``params`` (the step updates it in place; the
    caller's tree is left as it is), its leaves requiring grad. With
    ``sharding`` (``parallel.shard_params``' record) ``params`` are this
    rank's shards, and the state carries the record."""
    params = map_tree(params, lambda t: t.detach().clone().requires_grad_(True))
    leaves = [t for _, t in named_leaves(params)]
    if sharding is not None:
        sharding = dataclasses.replace(sharding, moments=[
            s for s, train in zip(sharding.spec_list(params), tx.trainable) if train])
    ema = ema_init(params) if ema_cfg is not None else None
    return TrainState(params, tx.init(leaves),
                      torch.zeros((), dtype=torch.int32, device=leaves[0].device), ema, sharding)


def local_draws(draws: MK.MaskDraws) -> MK.MaskDraws:
    """This rank's rows of the global batch's masking draws (the contiguous
    region's choice is one scalar for all rows)."""
    def rows(x, dim=0):
        return None if x is None else C.local_rows(x, dim=dim)
    return draws._replace(timesteps=rows(draws.timesteps), scores=rows(draws.scores),
                          replace=rows(draws.replace), rect=rows(draws.rect, 1),
                          eval_idx=rows(draws.eval_idx))


def check_key(key) -> None:
    """A sharded step needs the key: every rank must draw the same numbers."""
    if key is None and C.batch_size() > 1:
        raise ValueError("a sharded step needs a generator or the draws: every rank must "
                         "draw the same numbers")


def global_draws(key, rows: int, n: int, codebook_size: int, device, accum: int = 1):
    """This rank's rows of the masking draws of the global batch's ``rows``
    t2i rows: a generator (None: the default one) draws for every global
    row, one set a micro-batch in order; given draws are sliced."""
    check_key(key)
    if isinstance(key, MK.MaskDraws):
        return local_draws(key)
    if isinstance(key, list):
        return [local_draws(d) for d in key]
    ds = [local_draws(MK.draw_masking(key, rows // accum, n, codebook_size=codebook_size,
                                      device=device)) for _ in range(accum)]
    return ds if accum > 1 else ds[0]


def leaf_specs(state: TrainState) -> Optional[List]:
    """The specs of the state's leaves in ``named_leaves`` order (None: whole)."""
    return None if state.sharding is None else state.sharding.spec_list(state.params)


def param_specs(state: TrainState) -> Optional[Any]:
    """The spec tree of the state's params (and of its EMA's), which the
    forwards take; None for a whole state."""
    return None if state.sharding is None else state.sharding.tree(state.params)


def batch_grads(state: TrainState, batch: Dict[str, torch.Tensor], key,
                draw: Callable, grads_fn: Callable, accum: int = 1):
    """(gradients in ``named_leaves`` order, metrics) of ``state`` on the
    global ``batch``: this rank's rows and its rows of the draws that
    ``draw(key)`` makes for the whole batch, ``grads_fn(rows, draws)`` on
    them, its gradients and metrics summed over the batch group."""
    with C.batch_sharded(None if state.sharding is None else state.sharding.mesh):
        key = draw(key)
        grads, metrics = grads_fn({k: C.local_rows(v, accum) for k, v in batch.items()}, key)
        return (C.sync_grads(grads, leaf_specs(state)),
                {k: C.batch_sum(v) for k, v in metrics.items()})


def apply_update(tx: AdamW, state: TrainState, grads, metrics, ema_cfg=None):
    """The grad norm metric (over the leaves with a gradient), AdamW in
    place, the EMA; returns (state, metrics)."""
    specs = leaf_specs(state)
    with C.batch_sharded(None if state.sharding is None else state.sharding.mesh):
        kept = [i for i, g in enumerate(grads) if g is not None]
        metrics["grad_norm"] = global_norm([grads[i] for i in kept],
                                           None if specs is None else [specs[i] for i in kept])
        leaves = [t for _, t in named_leaves(state.params)]
        opt_state = tx.update(grads, state.opt_state, leaves, specs)
    del grads
    ema = ema_update(ema_cfg, state.ema, state.params) if ema_cfg is not None else state.ema
    return state._replace(opt_state=opt_state, step=state.step + 1, ema=ema), metrics


def local_tcfg(tcfg):
    """``tcfg`` with its batch sizes divided over the batch group."""
    n = C.batch_size()
    return tcfg if n == 1 else dataclasses.replace(
        tcfg, batch_size_t2i=tcfg.batch_size_t2i // n, batch_size_lm=tcfg.batch_size_lm // n,
        batch_size_mmu=tcfg.batch_size_mmu // n)


def _splice(ids: torch.Tensor, block: torch.Tensor, start: int) -> torch.Tensor:
    return torch.cat([ids[:, :start], block.to(ids.dtype), ids[:, start + block.shape[1]:]],
                     dim=1)


class TrainStep:
    """``step(state, vq_params, batch, key) -> (state, metrics)``; the state's
    tensors are updated in place and returned in a new ``TrainState``.

    ``batch`` fields (by the configured batch sizes; one length L):
      t2i_template, t2i_labels [Bt, L] int (zeros in the image block),
      t2i_pixels [Bt, H, W, 3]; lm_ids, lm_labels [Bl, L];
      mmu_template, mmu_labels [Bm, L] (zeros at [3:3+n]), mmu_pixels.
    """

    def __init__(self, cfg: UniGenConfig, vq_cfg: MagvitConfig, tx: AdamW,
                 tcfg: TrainStepConfig, ema_cfg: Optional[EMAConfig] = None):
        self.cfg, self.vq_cfg, self.tx, self.tcfg, self.ema_cfg = cfg, vq_cfg, tx, tcfg, ema_cfg
        self.schedule: Callable = S.get_mask_schedule(tcfg.mask_schedule)

    def build_inputs(self, vq_params, batch: Dict[str, torch.Tensor], draws):
        """(input_ids, labels, meta_bits, per-row mask rates) of the fused batch."""
        cfg, tcfg, n = self.cfg, self.tcfg, self.cfg.num_vq_tokens
        parts, labels, metas = [], [], []
        dev = next(iter(batch.values())).device
        mask_prob = torch.zeros((max(tcfg.batch_size_t2i, 1),), dtype=torch.float32, device=dev)

        def meta(ids, task_meta):
            return M.lm_attn_meta(ids, tcfg.pad_id) if tcfg.use_causal_mask else task_meta(ids)

        if tcfg.batch_size_t2i > 0:
            with torch.no_grad():
                codes = magvit.get_code(vq_params, self.vq_cfg, batch["t2i_pixels"])
            if tcfg.t2i_gen_mode == "mask":
                # corruption in codebook space; the marker codebook_size is the
                # gen projector's mask id (the unified id is mapped below)
                masked = MK.mask_or_random_replace_tokens(
                    draws, codes, cfg.codebook_size, self.schedule,
                    min_masking_rate=tcfg.min_masking_rate,
                    mask_contiguous_region_prob=tcfg.mask_contiguous_region_prob,
                    noise_type=tcfg.noise_type, codebook_size=cfg.codebook_size)
                img_inputs, img_labels, mask_prob = masked.input_ids, masked.labels, \
                    masked.mask_prob
            else:
                img_inputs, img_labels = codes, codes
            if not cfg.use_gen_projector:
                # unified space: tokens offset by the text vocabulary, mask = vocab - 1
                img_inputs = torch.where(img_inputs == cfg.codebook_size,
                                         torch.full_like(img_inputs, cfg.mask_token_id),
                                         img_inputs + cfg.text_vocab_len)
                img_labels = torch.where(img_labels < 0, img_labels,
                                         img_labels + cfg.text_vocab_len)
            start = batch["t2i_template"].shape[1] - n - 1
            ids = _splice(batch["t2i_template"], img_inputs, start)
            metas.append(meta(ids, lambda i: M.t2i_attn_meta(i, tcfg.pad_id, tcfg.soi_id,
                                                             tcfg.eoi_id)))
            parts.append(ids)
            labels.append(_splice(batch["t2i_labels"], img_labels, start))
        if tcfg.batch_size_lm > 0:
            ids = batch["lm_ids"]
            metas.append(M.lm_attn_meta(ids, tcfg.pad_id))
            parts.append(ids)
            labels.append(batch["lm_labels"])
        if tcfg.batch_size_mmu > 0:
            with torch.no_grad():
                codes = magvit.get_code(vq_params, self.vq_cfg, batch["mmu_pixels"])
            ids = _splice(batch["mmu_template"], codes + cfg.text_vocab_len, 3)
            metas.append(meta(ids, lambda i: M.mmu_train_attn_meta(i, tcfg.pad_id, tcfg.soi_id,
                                                                   tcfg.eoi_id)))
            parts.append(ids)
            labels.append(batch["mmu_labels"])
        return (torch.cat(parts, dim=0), torch.cat(labels, dim=0),
                M.pack_meta(M.concat_meta(*metas)), mask_prob)

    def loss_fn(self, params, vq_params, batch, draws, specs=None):
        """(weighted loss, detached metrics) of one (micro-)batch; ``specs``
        the spec tree of sharded ``params``."""
        tcfg = self.tcfg
        input_ids, label_ids, meta_bits, mask_prob = self.build_inputs(vq_params, batch, draws)
        _, lt, ll, lm = unigen.forward(
            params, self.cfg, input_ids=input_ids, meta_bits=meta_bits, labels=label_ids,
            batch_size_t2i=tcfg.batch_size_t2i, batch_size_lm=tcfg.batch_size_lm,
            batch_size_mmu=tcfg.batch_size_mmu, t2i_mode=tcfg.t2i_gen_mode, remat=tcfg.remat,
            memory_efficient_loss=tcfg.memory_efficient_loss and not self.cfg.use_gen_projector,
            specs=specs)
        loss = tcfg.t2i_coeff * lt + tcfg.lm_coeff * ll + tcfg.mmu_coeff * lm
        metrics = {"loss": loss, "loss_t2i": lt, "loss_lm": ll, "loss_mmu": lm,
                   "avg_masking_rate": C.batch_mean(mask_prob)}
        return loss, {k: v.detach() for k, v in metrics.items()}

    def loss_and_grads(self, params, vq_params, batch: Dict[str, torch.Tensor], key: Key,
                       specs=None) -> tuple:
        """(gradients in ``named_leaves`` order, metrics), averaged over the
        micro-batches; the parameters are not touched."""
        leaves = [t for _, t in named_leaves(params)]
        a = self.tcfg.grad_accum_steps
        keys = key if isinstance(key, list) else [key] * a
        if len(keys) != a:
            raise ValueError(f"{len(keys)} masking draws for {a} micro-batches")
        grads: Optional[List[torch.Tensor]] = None
        metrics: Dict[str, torch.Tensor] = {}
        for i, k in enumerate(keys):
            micro = {name: x.reshape(a, x.shape[0] // a, *x.shape[1:])[i]
                     for name, x in batch.items()} if a > 1 else batch
            loss, m = self.loss_fn(params, vq_params, micro, k, specs)
            g = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
            grads = list(g) if grads is None else [x + y for x, y in zip(grads, g)]
            metrics = m if not metrics else {n: metrics[n] + m[n] for n in metrics}
        if a > 1:
            grads = [x / a for x in grads]
            metrics = {n: v / a for n, v in metrics.items()}
        return grads, metrics

    def grads(self, state: TrainState, vq_params, batch, key: Key):
        """(gradients, metrics) of ``state`` on the global batch
        (``batch_grads``); the parameters are not touched."""
        tcfg, a = self.tcfg, self.tcfg.grad_accum_steps

        def draw(key):
            if tcfg.batch_size_t2i > 0 and tcfg.t2i_gen_mode == "mask":
                return global_draws(key, tcfg.batch_size_t2i, self.cfg.num_vq_tokens,
                                    self.cfg.codebook_size, state.step.device, a)
            return key

        def grads_fn(rows, key):
            step = TrainStep(self.cfg, self.vq_cfg, self.tx, local_tcfg(tcfg), self.ema_cfg)
            return step.loss_and_grads(state.params, vq_params, rows, key, param_specs(state))
        return batch_grads(state, batch, key, draw, grads_fn, a)

    def __call__(self, state: TrainState, vq_params, batch: Dict[str, torch.Tensor],
                 key: Key):
        return self.apply(state, *self.grads(state, vq_params, batch, key))

    def apply(self, state: TrainState, grads, metrics):
        """The grad norm metric, AdamW in place, the EMA (``apply_update``)."""
        return apply_update(self.tx, state, grads, metrics, self.ema_cfg)


def make_train_step(cfg: UniGenConfig, vq_cfg: MagvitConfig, tx: AdamW,
                    tcfg: TrainStepConfig, ema_cfg: Optional[EMAConfig] = None) -> TrainStep:
    """The step: (state, vq_params, batch, key) -> (state, metrics)."""
    return TrainStep(cfg, vq_cfg, tx, tcfg, ema_cfg)
