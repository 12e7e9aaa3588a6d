"""DPO over image preferences.

Port of ``unigen_tpu/training/dpo.py``: the chosen and the rejected images
are encoded by the frozen MAGViTv2 (kernel 3 on the card, under
``torch.no_grad``), masked with their own draws and spliced into one
prompt template; the policy and the frozen reference score the
concatenated [chosen; rejected] rows, each log-prob the sum over the
trailing image block's masked positions (``get_batch_logps``, or chunked
from the hidden states, ``get_batch_logps_from_hidden``), and the loss is
``-logsigmoid(beta * (policy log-ratio - reference log-ratio))``.

The reference is either online (a frozen copy of the parameters whose
forward runs under ``torch.no_grad``: no activations kept) or precomputed
(``precomputed_ref``: ``make_ref_logps_fn`` scores each batch ahead of
training, the batch then carries ``ref_chosen_logps`` / ``ref_rejected_logps``
and the step holds no second model).

Attention runs through kernel 2 on ``t2i_attn_meta`` bits (with
``use_causal_mask``, the pad-only causal bits), where JAX's DPO runs its
dense ``create_attention_mask_predict_next``; they differ only on pad query
rows, which no scored position sees (ROADMAP, "Deliberate differences").
Masking draws: ``key`` is a ``torch.Generator`` (the chosen draws, then the
rejected ones) or a pair of ``ops.masking.MaskDraws`` (JAX's ``k_c, k_r``
split; the entry derives both from the step's seed, so the reference pass
and the step see the same draws).

A sharded state (``train_step``'s docstring) takes the global batch: each
rank scores its rows of the batch group under its rows of the global
draws, its loss and metrics are its shares of the means over all pairs,
and the gradients are summed over the batch group. The reference tree is
sharded as the policy's (``parallel.shard_params`` with the same specs),
so the state's ``Sharding`` gives both spec trees.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from ..models import magvit, qwen2, unigen
from ..models.magvit import MagvitConfig
from ..models.unigen import UniGenConfig, _chunked_label_logps
from ..ops import masking as MK
from ..ops import masks as M
from ..ops import sampling as S
from ..parallel import collectives as C
from .optimizer import AdamW, named_leaves
from .train_step import (TrainState, _splice, apply_update, batch_grads, check_key, local_draws,
                         param_specs)

PairKey = Union[torch.Generator, Sequence[MK.MaskDraws], None]


@dataclasses.dataclass(frozen=True)
class DPOConfig:
    beta: float = 0.1
    dpo_coef: float = 1.0
    t2i_gen_mode: str = "mask"
    use_causal_mask: bool = False
    min_masking_rate: float = 0.0
    mask_schedule: str = "cosine"
    average_log_prob: bool = False
    max_grad_norm: Optional[float] = None
    pad_id: int = 0
    soi_id: int = 1
    eoi_id: int = 2
    remat: bool = False
    # chunked logps over the image block (no [2B, L, V] fp32 logits); the
    # gen projector's narrow image head ignores it
    memory_efficient_logps: bool = True
    # the reference log-probs come with the batch (make_ref_logps_fn)
    precomputed_ref: bool = False


def get_batch_logps(logits: torch.Tensor, labels: torch.Tensor, *, num_vq_tokens: int = 256,
                    t2i_gen_mode: str = "mask", average_log_prob: bool = False,
                    label_pad_token_id: int = -100) -> torch.Tensor:
    """[B] sum (or mean) of the label log-probs over the trailing image block."""
    n = num_vq_tokens
    logits = logits[:, -(n + 1):-1].float()
    labels = labels[:, -(n + 1):-1]
    loss_mask = labels != label_pad_token_id
    safe = torch.where(loss_mask, labels, torch.zeros_like(labels))
    logp = torch.log_softmax(logits, dim=-1)
    if t2i_gen_mode == "ar":
        per_tok = torch.gather(logp[:, :-1], 2, safe[:, 1:, None])[..., 0]
        loss_mask = loss_mask[:, 1:]
    else:
        per_tok = torch.gather(logp, 2, safe[..., None])[..., 0]
    total = (per_tok * loss_mask).sum(-1)
    if average_log_prob:
        return total / loss_mask.sum(-1)
    return total


def get_batch_logps_from_hidden(hidden: torch.Tensor, w: torch.Tensor, labels: torch.Tensor, *,
                                average_log_prob: bool = False, label_pad_token_id: int = -100,
                                chunk: int = 64, spec=None) -> torch.Tensor:
    """[B] label log-probs projecting ``hidden`` through ``w`` (of spec
    ``spec``) chunk by chunk (``unigen._chunked_label_logps``); the caller
    slices both so that position i of one predicts position i of the other."""
    total, count = _chunked_label_logps(hidden, w, labels, ignore_id=label_pad_token_id,
                                        chunk=chunk, per_row=True, spec=spec)
    if average_log_prob:
        return total / count
    return total


def _encode_and_mask(cfg: UniGenConfig, vq_cfg: MagvitConfig, dcfg: DPOConfig, schedule,
                     vq_params, pixels, template, labels_t, draws):
    """Encode ``pixels``, mask per the schedule, splice into the template:
    (ids, labels, meta, mask_prob)."""
    n = cfg.num_vq_tokens
    with torch.no_grad():
        codes = magvit.get_code(vq_params, vq_cfg, pixels)
    if dcfg.t2i_gen_mode == "mask":
        masked = MK.mask_or_random_replace_tokens(
            draws, codes, cfg.codebook_size, schedule, min_masking_rate=dcfg.min_masking_rate,
            codebook_size=cfg.codebook_size)
        img_in_cb, img_lab_cb, mask_prob = masked.input_ids, masked.labels, masked.mask_prob
    else:
        img_in_cb = img_lab_cb = codes
        mask_prob = torch.zeros((codes.shape[0],), dtype=torch.float32, device=codes.device)
    if cfg.use_gen_projector:
        img_in, img_lab = img_in_cb, img_lab_cb
    else:
        img_in = torch.where(img_in_cb == cfg.codebook_size,
                             torch.full_like(img_in_cb, cfg.mask_token_id),
                             img_in_cb + cfg.text_vocab_len)
        img_lab = torch.where(img_lab_cb < 0, img_lab_cb, img_lab_cb + cfg.text_vocab_len)
    ids = _splice(template, img_in, template.shape[1] - n - 1)
    labs = _splice(labels_t, img_lab, labels_t.shape[1] - n - 1)
    meta = (M.lm_attn_meta(ids, dcfg.pad_id) if dcfg.use_causal_mask else
            M.t2i_attn_meta(ids, dcfg.pad_id, dcfg.soi_id, dcfg.eoi_id))
    return ids, labs, meta, mask_prob


def _concatenated_logps(cfg: UniGenConfig, dcfg: DPOConfig, params, ids, labs, bits, b: int,
                        specs=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(chosen, rejected) log-probs [b] each of the [2b, L] rows."""
    n = cfg.num_vq_tokens
    if dcfg.memory_efficient_logps and not cfg.use_gen_projector:
        hidden = unigen.forward(params, cfg, input_ids=ids, meta_bits=bits,
                                batch_size_t2i=2 * b, t2i_mode=dcfg.t2i_gen_mode,
                                remat=dcfg.remat, return_hidden=True, specs=specs)
        w, spec = qwen2.lm_head(params["llm"], cfg.llm, C.sub(specs, "llm"))
        if dcfg.t2i_gen_mode == "ar":
            h, lab = hidden[:, -(n + 1):-2], labs[:, -n:-1]
        else:
            h, lab = hidden[:, -(n + 1):-1], labs[:, -(n + 1):-1]
        logps = get_batch_logps_from_hidden(h, w, lab, average_log_prob=dcfg.average_log_prob,
                                            spec=spec)
        return logps[:b], logps[b:]
    logits = unigen.forward(params, cfg, input_ids=ids, meta_bits=bits, batch_size_t2i=2 * b,
                            t2i_mode=dcfg.t2i_gen_mode, remat=dcfg.remat, specs=specs)
    logps = get_batch_logps(logits, labs, num_vq_tokens=n, t2i_gen_mode=dcfg.t2i_gen_mode,
                            average_log_prob=dcfg.average_log_prob)
    return logps[:b], logps[b:]


def pair_draws(key: PairKey, b: int, n: int, codebook_size: int, device=None
               ) -> Tuple[MK.MaskDraws, MK.MaskDraws]:
    """The chosen and the rejected rows' masking draws: ``key`` as given
    (two ``MaskDraws``), else drawn from the generator, chosen first."""
    if key is not None and not isinstance(key, torch.Generator):
        k_c, k_r = key
        return k_c, k_r
    return tuple(MK.draw_masking(key, b, n, codebook_size=codebook_size, device=device)
                 for _ in range(2))


def _build_pair_inputs(cfg, vq_cfg, dcfg, schedule, vq_params, batch, key: PairKey):
    """The concatenated [chosen; rejected] ids, labels and bits of one batch
    and its draws, shared by the step and the reference pass."""
    b = batch["template"].shape[0]
    k_c, k_r = pair_draws(key, b, cfg.num_vq_tokens, cfg.codebook_size,
                          batch["template"].device)
    c_ids, c_labs, c_meta, c_prob = _encode_and_mask(
        cfg, vq_cfg, dcfg, schedule, vq_params, batch["chosen_pixels"], batch["template"],
        batch["labels"], k_c)
    r_ids, r_labs, r_meta, r_prob = _encode_and_mask(
        cfg, vq_cfg, dcfg, schedule, vq_params, batch["rejected_pixels"], batch["template"],
        batch["labels"], k_r)
    bits = M.pack_meta(M.concat_meta(c_meta, r_meta))
    return torch.cat([c_ids, r_ids]), torch.cat([c_labs, r_labs]), bits, c_prob, r_prob


def make_ref_logps_fn(cfg: UniGenConfig, vq_cfg: MagvitConfig, dcfg: DPOConfig):
    """``ref_fn(params, vq_params, batch, key, specs=None) -> {"ref_chosen_logps",
    "ref_rejected_logps"}``: the reference model's log-probs of one batch
    under its draws, a forward without gradients. DPO's reference is the
    step-0 policy, so these can be computed ahead of training, one a step,
    and handed to the ``precomputed_ref`` step with the same draws."""
    schedule = S.get_mask_schedule(dcfg.mask_schedule)

    @torch.no_grad()
    def ref_logps(params, vq_params, batch, key: PairKey, specs=None
                  ) -> Dict[str, torch.Tensor]:
        ids, labs, bits, _, _ = _build_pair_inputs(cfg, vq_cfg, dcfg, schedule, vq_params,
                                                   batch, key)
        rc, rr = _concatenated_logps(cfg, dcfg, params, ids, labs, bits,
                                     batch["template"].shape[0], specs)
        return {"ref_chosen_logps": rc, "ref_rejected_logps": rr}

    return ref_logps


class DPOStep:
    """``step(state, ref_params, vq_params, batch, key) -> (state, metrics)``.

    ``batch``: template, labels [B, L] (zeros in the image block),
    chosen_pixels / rejected_pixels [B, H, W, 3]; with ``precomputed_ref``
    also ref_chosen_logps / ref_rejected_logps [B] (``ref_params`` is then
    ignored: pass None). The state's tensors are updated in place."""

    def __init__(self, cfg: UniGenConfig, vq_cfg: MagvitConfig, tx: AdamW, dcfg: DPOConfig):
        self.cfg, self.vq_cfg, self.tx, self.dcfg = cfg, vq_cfg, tx, dcfg
        self.schedule = S.get_mask_schedule(dcfg.mask_schedule)
        self.ref_fn = make_ref_logps_fn(cfg, vq_cfg, dcfg)

    def loss_and_grads(self, params, ref_params, vq_params, batch, key: PairKey, specs=None,
                       ref_specs=None):
        """(gradients in ``named_leaves`` order, None for a frozen leaf;
        metrics); the parameters are not touched. ``specs`` / ``ref_specs``:
        the two trees' spec trees when sharded."""
        cfg, dcfg = self.cfg, self.dcfg
        b = batch["template"].shape[0]
        ids, labs, bits, c_prob, r_prob = _build_pair_inputs(
            cfg, self.vq_cfg, dcfg, self.schedule, vq_params, batch, key)
        if dcfg.precomputed_ref:
            rc, rr = batch["ref_chosen_logps"], batch["ref_rejected_logps"]
        else:
            with torch.no_grad():
                rc, rr = _concatenated_logps(cfg, dcfg, ref_params, ids, labs, bits, b, ref_specs)
        pc, pr = _concatenated_logps(cfg, dcfg, params, ids, labs, bits, b, specs)
        logits_diff = (pc - pr) - (rc - rr)
        loss = dcfg.dpo_coef * C.batch_mean(-F.logsigmoid(dcfg.beta * logits_diff))
        leaves = [t for _, t in named_leaves(params)]
        want = [t for t in leaves if t.requires_grad]
        got = iter(torch.autograd.grad(loss, want, allow_unused=True, materialize_grads=True))
        grads = [next(got) if t.requires_grad else None for t in leaves]
        metrics = {
            "loss": loss.detach(),
            "reward_accuracy": C.batch_mean(((pc - pr) > (rc - rr)).float()),
            "policy_chosen_logps": C.batch_mean(pc.detach()),
            "policy_rejected_logps": C.batch_mean(pr.detach()),
            "chosen_masking_rate": C.batch_mean(c_prob),
            "rejected_masking_rate": C.batch_mean(r_prob),
        }
        return grads, metrics

    def __call__(self, state: TrainState, ref_params, vq_params, batch, key: PairKey):
        def draw(key):
            check_key(key)
            return tuple(local_draws(d) for d in pair_draws(
                key, batch["template"].shape[0], self.cfg.num_vq_tokens,
                self.cfg.codebook_size, state.step.device))

        sh = state.sharding
        ref_specs = None if sh is None or ref_params is None else sh.tree(ref_params)

        def grads_fn(rows, key):
            return self.loss_and_grads(state.params, ref_params, vq_params, rows, key,
                                       param_specs(state), ref_specs)
        return self.apply(state, *batch_grads(state, batch, key, draw, grads_fn))

    def apply(self, state: TrainState, grads, metrics):
        """The grad norm metric (over the trained leaves) and AdamW in place."""
        return apply_update(self.tx, state, grads, metrics)


def make_dpo_step(cfg: UniGenConfig, vq_cfg: MagvitConfig, tx: AdamW,
                  dcfg: DPOConfig) -> DPOStep:
    """The step: (state, ref_params, vq_params, batch, key) -> (state, metrics)."""
    return DPOStep(cfg, vq_cfg, tx, dcfg)
