"""The SFT train step: the continuous-vision-tower variant of the unified step.

Port of ``unigen_tpu/training/sft.py``. The t2i and lm flows are PT2's
(prompt templates spliced on the device with the frozen MAGViTv2's codes,
MaskGIT corruption); the mmu flow runs pixels through the frozen SigLIP
tower (under ``torch.no_grad``, optionally as a global view plus n x n
crops, ``grid_tiles``), projects them with ``mm_projector`` and splices
``[part1 | image embeddings | part2]``. Four dispatch modes, as in JAX:

* separate (``common_length`` None): ``loss_tl`` (t2i and lm in one forward
  when their rows have one length, else two) and ``loss_mmu`` at its own
  length; two backward passes a step, their gradients accumulated into the
  same ``.grad`` leaves (JAX's tree-add ``g1 + g2``);
* ``loss_fused``: every row left-padded to ``common_length``, one forward,
  RoPE positions restarted at each row's first real token;
* ``loss_packed`` (``pack_rows``, mask mode, no gen projector): several t2i
  or lm rows a packed row, each segment with its own positions and its
  segment id in the kernel's bits 3 and up; t2i scored unshifted over the
  packed rows;
* ``make_sft_grad_fns``: the separate mode as three calls (two gradient
  functions and the update).

Attention always runs through kernel 2 on per-token bits
(``t2i_attn_meta``, ``lm_attn_meta``, ``mmu_vit_attn_meta`` with the rows'
``prompt_len``, the packed rows' ``seg``, joined by ``concat_meta``), JAX's
``use_flash_attention=True`` route; JAX's default dense masks differ only
on pad query rows (ROADMAP, "Deliberate differences"). The masking draws
come from ``key``: a ``torch.Generator`` or an ``ops.masking.MaskDraws``
(the tests hand in JAX's).

Gradients are taken for the leaves that require grad: ``init_sft_state``
freezes (``requires_grad=False``) the leaves the optimizer does not train,
so a LoRA step computes no base-weight gradients. The ``grad_norm`` metric
covers the trained leaves' gradients; JAX's covers every leaf's, the frozen
ones too (the same tree when every leaf trains, as in full SFT).

With the SigLIP2-NaFlex tower (``vision_cfg`` a ``Siglip2Config``) the mmu
rows carry patches instead of pixels: ``mmu_pixel_values`` [Bm, P, 3 p p],
``mmu_pixel_attention_mask`` [Bm, P], ``mmu_spatial_shapes`` [Bm, 2] and
``mmu_pos_embeds`` [Bm, P, D] (``models.siglip2.resize_positional_embeddings``
once a batch); the image block's bidirectional keys are each row's own
patches (``mmu_vit_attn_meta`` with the spatial shapes). ``n_grid`` tiling is
a fixed-resolution feature and raises with it, as in JAX.

A sharded state (``train_step``'s docstring) takes the global batch: each
rank runs the step on its rows of the batch group under its rows of the
global t2i draws, in any of the modes (a packed rank packs its own rows),
with every CE's count, the gradients and the metrics summed over the
batch group. The frozen tower may be sharded by
``parallel.partition.siglip_specs``: its ``Sharding`` comes to the step as
``vision_sharding``. The losses take both trees' spec trees (``specs``,
``vision_specs``) beside their params. ``make_sft_grad_fns`` is unsharded.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from ..models import magvit, qwen2, siglip, siglip2, unigen
from ..models.magvit import MagvitConfig
from ..models.unigen import UniGenConfig, _chunked_ce
from ..ops import masking as MK
from ..ops import masks as M
from ..ops import sampling as S
from ..parallel import collectives as C
from .optimizer import AdamW, named_leaves
from .train_step import (Key, TrainState, TrainStepConfig, _splice, apply_update, batch_grads,
                         global_draws, init_train_state, local_tcfg, param_specs)


def grid_tiles(pixels: torch.Tensor, n_grid: int, tile_size: int) -> torch.Tensor:
    """[B, S, S, 3] -> [B, 1 + n*n, tile, tile, 3]: the global view resized
    bilinearly (antialiased when it shrinks, as ``jax.image.resize`` does;
    computed in fp32), then the n x n crops."""
    glob = F.interpolate(pixels.float().permute(0, 3, 1, 2), size=(tile_size, tile_size),
                         mode="bilinear", align_corners=False, antialias=True)
    tiles = [glob.permute(0, 2, 3, 1).to(pixels.dtype)]
    for i in range(n_grid):
        for j in range(n_grid):
            tiles.append(pixels[:, i * tile_size:(i + 1) * tile_size,
                                j * tile_size:(j + 1) * tile_size])
    return torch.stack(tiles, dim=1)


@dataclasses.dataclass(frozen=True)
class SFTStepConfig(TrainStepConfig):
    n_grid: int = 0              # 0 = a single view at the tower's size
    # the mmu splice length: t2i / lm rows left-padded (or packed) to it and
    # all three flows in one forward; None = separate calls at each length
    common_length: Optional[int] = None
    # with common_length: pack several short t2i / lm rows a row (mask mode,
    # no gen projector) instead of left-padding each
    pack_rows: bool = True


def init_sft_state(params: Any, tx: AdamW, sharding: Optional[Any] = None) -> TrainState:
    """``init_train_state`` with the leaves the optimizer freezes not
    requiring grad: no gradient is computed for them."""
    state = init_train_state(params, tx, sharding=sharding)
    for (_, t), train in zip(named_leaves(state.params), tx.trainable):
        t.requires_grad_(train)
    return state


def _leaf_grads(params) -> List[Optional[torch.Tensor]]:
    """The accumulated ``.grad`` of every leaf in ``named_leaves`` order
    (zeros for a trained leaf no loss reached, as JAX's zero gradient; None
    for a frozen leaf), then cleared."""
    out = []
    for _, t in named_leaves(params):
        g = t.grad
        if g is None and t.requires_grad:
            g = torch.zeros_like(t)
        t.grad = None
        out.append(g)
    return out


class SFTStep:
    """``step(state, vq_params, vision_params, batch, key) -> (state, metrics)``.

    ``batch`` fields (beyond PT2's ``t2i_*`` and ``lm_*``):
      mmu_part1 [Bm, L1], mmu_part2 [Bm, L2] int: the prompt head and
      ``<|eoi|>`` + conversation ids; mmu_labels [Bm, L1 + P + L2];
      mmu_prompt_len [Bm]: each row's valid length; mmu_pixels [Bm, S, S, 3],
      or with the NaFlex tower mmu_pixel_values, mmu_pixel_attention_mask,
      mmu_spatial_shapes and mmu_pos_embeds (module docstring).
    The state's tensors are updated in place and returned in a new
    ``TrainState``; the vision tower's parameters are frozen.
    """

    def __init__(self, cfg: UniGenConfig, vq_cfg: MagvitConfig, vision_cfg, tx: AdamW,
                 tcfg: SFTStepConfig):
        self.naflex = isinstance(vision_cfg, siglip2.Siglip2Config)
        if self.naflex and tcfg.n_grid > 0:
            # NaFlex already sees native-resolution patch grids; training without
            # the configured tiling would be a different model
            raise ValueError("n_grid tiling is a fixed-res SigLIP feature; disable n_grid (or "
                             "use SiglipConfig) with NaFlex")
        self.cfg, self.vq_cfg, self.vision_cfg, self.tx, self.tcfg = cfg, vq_cfg, vision_cfg, \
            tx, tcfg
        self.schedule = S.get_mask_schedule(tcfg.mask_schedule)
        self.tile = None if self.naflex else vision_cfg.image_size

    # ------------------------------------------------------------- inputs --

    def vision_features(self, vision_params, batch, vision_specs=None) -> torch.Tensor:
        """The frozen tower's features [Bm, P, D] (tiles concatenated along P)."""
        if self.naflex:
            return siglip2.forward_with_pos(
                vision_params, self.vision_cfg, batch["mmu_pixel_values"],
                batch["mmu_pixel_attention_mask"], batch["mmu_pos_embeds"], vision_specs)
        pixels = batch["mmu_pixels"]
        if self.tcfg.n_grid > 0:
            tiles = grid_tiles(pixels, self.tcfg.n_grid, self.tile)
            b, t = tiles.shape[:2]
            feats = siglip.forward(vision_params, self.vision_cfg,
                                   tiles.reshape(b * t, self.tile, self.tile, 3), vision_specs)
            return feats.reshape(b, -1, feats.shape[-1])
        return siglip.forward(vision_params, self.vision_cfg, pixels, vision_specs)

    def build_tl_inputs(self, vq_params, batch, key: Key, target_len: Optional[int] = None):
        """(ids, labels, metas, bt, bl, mask_prob) of the t2i and lm flows;
        with ``target_len`` the rows are left-padded to it (the trailing
        image block stays at the tail; pads carry -100 labels)."""
        cfg, tcfg, n = self.cfg, self.tcfg, self.cfg.num_vq_tokens
        parts, labs_parts, metas = [], [], []
        bt = bl = 0
        dev = next(iter(batch.values())).device
        mask_prob = torch.zeros((1,), dtype=torch.float32, device=dev)

        def pad_to(ids, labs):
            if target_len is None:
                return ids, labs
            p = target_len - ids.shape[1]
            if p < 0:
                raise ValueError(f"common_length {target_len} < row length {ids.shape[1]}")
            return (F.pad(ids, (p, 0), value=tcfg.pad_id), F.pad(labs, (p, 0), value=-100))

        if tcfg.batch_size_t2i > 0:
            with torch.no_grad():
                codes = magvit.get_code(vq_params, self.vq_cfg, batch["t2i_pixels"])
            masked = MK.mask_or_random_replace_tokens(
                key, codes, cfg.codebook_size, self.schedule,
                min_masking_rate=tcfg.min_masking_rate, codebook_size=cfg.codebook_size)
            img_in = torch.where(masked.input_ids == cfg.codebook_size,
                                 torch.full_like(masked.input_ids, cfg.mask_token_id),
                                 masked.input_ids + cfg.text_vocab_len)
            img_lab = torch.where(masked.labels < 0, masked.labels,
                                  masked.labels + cfg.text_vocab_len)
            ids = _splice(batch["t2i_template"], img_in, batch["t2i_template"].shape[1] - n - 1)
            labs = _splice(batch["t2i_labels"], img_lab, batch["t2i_labels"].shape[1] - n - 1)
            ids, labs = pad_to(ids, labs)
            parts.append(ids)
            labs_parts.append(labs)
            metas.append(M.t2i_attn_meta(ids, tcfg.pad_id, tcfg.soi_id, tcfg.eoi_id))
            bt = ids.shape[0]
            mask_prob = masked.mask_prob
        if tcfg.batch_size_lm > 0:
            ids, labs = pad_to(batch["lm_ids"], batch["lm_labels"])
            off = ids.shape[1] - batch["lm_ids"].shape[1]
            if off:
                # the pad -> first real token pair is not a next-token pair
                labs = labs.clone()
                labs[:, off] = -100
            parts.append(ids)
            labs_parts.append(labs)
            metas.append(M.lm_attn_meta(ids, tcfg.pad_id))
            bl = ids.shape[0]
        return parts, labs_parts, metas, bt, bl, mask_prob

    def build_mmu_inputs(self, params, vision_params, batch, specs=None, vision_specs=None):
        """([part1 | projected image | part2] embeddings, mmu_vit meta with
        each row's prompt_len, labels). With the NaFlex tower each row's
        bidirectional block is its own patches."""
        feats = self.vision_features(vision_params, batch, vision_specs)
        img = unigen.mm_project(params, feats, specs)
        e1 = unigen.embed_tokens(params, batch["mmu_part1"], specs)
        e2 = unigen.embed_tokens(params, batch["mmu_part2"], specs)
        embeds = torch.cat([e1, img.to(e1.dtype), e2], dim=1)
        b, l, _ = embeds.shape
        num_tokens = batch["mmu_spatial_shapes"] if self.naflex else img.shape[1]
        meta = M.mmu_vit_attn_meta(b, l, num_tokens=num_tokens,
                                   prefix_length=batch["mmu_part1"].shape[1],
                                   prompt_len=batch["mmu_prompt_len"])
        return embeds, meta, batch["mmu_labels"]

    # ------------------------------------------------------------- losses --

    def _forward(self, params, specs, **kw):
        return unigen.forward(params, self.cfg, remat=self.tcfg.remat,
                              memory_efficient_loss=self.tcfg.memory_efficient_loss,
                              specs=specs, **kw)

    def loss_tl(self, params, vq_params, batch, key: Key, specs=None):
        """The weighted t2i + lm loss: one forward when the two flows share a
        length, else one a flow."""
        tcfg = self.tcfg
        losses: Dict[str, torch.Tensor] = {}
        parts, labs_parts, metas, bt, bl, mask_prob = self.build_tl_inputs(vq_params, batch, key)
        total = torch.zeros((), dtype=torch.float32, device=mask_prob.device)
        if len(parts) < 2 or parts[0].shape[1] == parts[1].shape[1]:
            _, lt, ll, _ = self._forward(
                params, specs, input_ids=torch.cat(parts), labels=torch.cat(labs_parts),
                meta_bits=M.pack_meta(M.concat_meta(*metas)), batch_size_t2i=bt,
                batch_size_lm=bl, t2i_mode=tcfg.t2i_gen_mode)
        else:
            _, lt, _, _ = self._forward(params, specs, input_ids=parts[0],
                                        labels=labs_parts[0], meta_bits=M.pack_meta(metas[0]),
                                        batch_size_t2i=bt, t2i_mode=tcfg.t2i_gen_mode)
            _, _, ll, _ = self._forward(params, specs, input_ids=parts[1],
                                        labels=labs_parts[1], meta_bits=M.pack_meta(metas[1]),
                                        batch_size_lm=bl)
        if bt:
            losses["loss_t2i"] = lt
            total = total + tcfg.t2i_coeff * lt
        if bl:
            losses["loss_lm"] = ll
            total = total + tcfg.lm_coeff * ll
        losses["avg_masking_rate"] = C.batch_mean(mask_prob)
        return total, losses

    def loss_mmu(self, params, vision_params, batch, specs=None, vision_specs=None):
        """The weighted mmu (vision conversation) loss at its own length."""
        embeds, meta, labels = self.build_mmu_inputs(params, vision_params, batch, specs,
                                                     vision_specs)
        _, _, _, lm = self._forward(params, specs, input_embeddings=embeds, labels=labels,
                                    meta_bits=M.pack_meta(meta), batch_size_mmu=embeds.shape[0])
        return self.tcfg.mmu_coeff * lm, {"loss_mmu": lm}

    def _common_mmu(self, params, vision_params, batch, specs, vision_specs):
        embeds, meta, labels = self.build_mmu_inputs(params, vision_params, batch, specs,
                                                     vision_specs)
        if embeds.shape[1] != self.tcfg.common_length:
            raise ValueError(f"common_length {self.tcfg.common_length} != mmu splice length "
                             f"{embeds.shape[1]}")
        return embeds, meta, labels

    def _total(self, losses, lt, ll, lmu, bt, bl):
        tcfg = self.tcfg
        total = tcfg.mmu_coeff * lmu
        losses["loss_mmu"] = lmu
        if bt:
            losses["loss_t2i"] = lt
            total = total + tcfg.t2i_coeff * lt
        if bl:
            losses["loss_lm"] = ll
            total = total + tcfg.lm_coeff * ll
        return total, losses

    def loss_fused(self, params, vq_params, vision_params, batch, key: Key, specs=None,
                   vision_specs=None):
        """All three flows in one forward at ``common_length``: t2i / lm rows
        left-padded, their positions restarted at the first real token (pads
        clamped to 0)."""
        tcfg, lc = self.tcfg, self.tcfg.common_length
        parts, labs_parts, metas, bt, bl, mask_prob = self.build_tl_inputs(
            vq_params, batch, key, target_len=lc)
        mmu_embeds, mmu_meta, mmu_labels = self._common_mmu(params, vision_params, batch, specs,
                                                            vision_specs)
        embeds = []
        if bt:
            embeds.append(unigen.prepare_inputs_for_t2i(params, self.cfg, parts[0], specs))
        if bl:
            embeds.append(unigen.embed_tokens(params, parts[-1], specs))
        embeds.append(mmu_embeds)
        bm = mmu_embeds.shape[0]
        steps = torch.arange(lc, device=mmu_embeds.device)
        pos = []
        for rows, key_ in ((bt, "t2i_template"), (bl, "lm_ids")):
            if rows:
                off = lc - batch[key_].shape[1]
                pos.append(torch.clamp(steps - off, min=0)[None].expand(rows, lc))
        pos.append(steps[None].expand(bm, lc))
        _, lt, ll, lmu = self._forward(
            params, specs, input_embeddings=torch.cat([e.to(mmu_embeds.dtype) for e in embeds]),
            labels=torch.cat(labs_parts + [mmu_labels]),
            meta_bits=M.pack_meta(M.concat_meta(*metas, mmu_meta)),
            batch_size_t2i=bt, batch_size_lm=bl, batch_size_mmu=bm,
            t2i_mode=tcfg.t2i_gen_mode, positions=torch.cat(pos))
        return self._total({"avg_masking_rate": C.batch_mean(mask_prob)}, lt, ll, lmu, bt, bl)

    def _pack(self, ids_r, labs_r, meta_builder):
        """r rows of length ls -> ceil(r / segs) rows of ``common_length``:
        segment slot s of a row holds a row at offset s * ls with positions
        0..ls-1 and segment id s; filler slots are pads. The bits come from
        the packed ids, then ``seg`` is replaced."""
        lc, pad_id = self.tcfg.common_length, self.tcfg.pad_id
        r, ls = ids_r.shape
        segs = max(1, lc // ls)
        p_rows = -(-r // segs)
        dev = ids_r.device
        ids_p = torch.full((p_rows, lc), pad_id, dtype=ids_r.dtype, device=dev)
        labs_p = torch.full((p_rows, lc), -100, dtype=labs_r.dtype, device=dev)
        pos_p = torch.zeros((p_rows, lc), dtype=torch.int64, device=dev)
        seg_p = torch.zeros((p_rows, lc), dtype=torch.int32, device=dev)
        steps = torch.arange(ls, device=dev)
        for i in range(r):
            pr, slot = divmod(i, segs)
            o = slot * ls
            ids_p[pr, o:o + ls] = ids_r[i]
            labs_p[pr, o:o + ls] = labs_r[i]
            pos_p[pr, o:o + ls] = steps
            seg_p[pr, o:o + ls] = slot
        return ids_p, labs_p, meta_builder(ids_p)._replace(seg=seg_p), pos_p

    def loss_packed(self, params, vq_params, vision_params, batch, key: Key, specs=None,
                    vision_specs=None):
        """``loss_fused`` with the short t2i / lm rows sequence-packed: each
        flow's rows fill ``common_length // row_length`` segments a row.
        The t2i labels are -100 outside each segment's image block, so the
        unshifted full-row CE scores exactly the block; lm and mmu take the
        shifted CE with each lm segment's first label dropped."""
        tcfg, lc, n = self.tcfg, self.tcfg.common_length, self.cfg.num_vq_tokens
        parts, labs_parts, _, bt, bl, mask_prob = self.build_tl_inputs(vq_params, batch, key)
        mmu_embeds, mmu_meta, mmu_labels = self._common_mmu(params, vision_params, batch, specs,
                                                            vision_specs)
        embeds, metas, poss = [], [], []
        rt = rl = 0
        t2i_labs_p = lm_labs_p = None
        if bt:
            # only the image block is scored (JAX's slice drops the soi / eoi labels)
            block = torch.full_like(labs_parts[0], -100)
            block[:, -(n + 1):-1] = labs_parts[0][:, -(n + 1):-1]
            ids_p, t2i_labs_p, meta_p, pos_p = self._pack(
                parts[0], block,
                lambda ip: M.t2i_attn_meta(ip, tcfg.pad_id, tcfg.soi_id, tcfg.eoi_id))
            embeds.append(unigen.embed_tokens(params, ids_p, specs))
            metas.append(meta_p)
            poss.append(pos_p)
            rt = ids_p.shape[0]
        if bl:
            lm_labs = labs_parts[-1].clone()
            lm_labs[:, 0] = -100
            ids_p, lm_labs_p, meta_p, pos_p = self._pack(
                parts[-1], lm_labs, lambda ip: M.lm_attn_meta(ip, tcfg.pad_id))
            embeds.append(unigen.embed_tokens(params, ids_p, specs))
            metas.append(meta_p)
            poss.append(pos_p)
            rl = ids_p.shape[0]
        bm = mmu_embeds.shape[0]
        embeds.append(mmu_embeds)
        metas.append(mmu_meta)
        poss.append(torch.arange(lc, device=mmu_embeds.device)[None].expand(bm, lc))
        llm_specs = C.sub(specs, "llm")
        hidden, _ = qwen2.forward(
            params["llm"], self.cfg.llm,
            inputs_embeds=torch.cat([e.to(mmu_embeds.dtype) for e in embeds]),
            meta_bits=M.pack_meta(M.concat_meta(*metas)), positions=torch.cat(poss),
            remat=tcfg.remat, specs=llm_specs)
        w, spec = qwen2.lm_head(params["llm"], self.cfg.llm, llm_specs)
        lt = _chunked_ce(hidden[:rt], w, t2i_labs_p, spec=spec) if bt else None
        ll = _chunked_ce(hidden[rt:rt + rl, :-1], w, lm_labs_p[:, 1:], spec=spec) if bl else None
        lmu = _chunked_ce(hidden[rt + rl:, :-1], w, mmu_labels[:, 1:], spec=spec)
        return self._total({"avg_masking_rate": C.batch_mean(mask_prob)}, lt, ll, lmu, bt, bl)

    # ---------------------------------------------------------- the step --

    @property
    def mode(self) -> str:
        tcfg = self.tcfg
        if tcfg.common_length is not None and tcfg.batch_size_mmu > 0 and (
                tcfg.batch_size_t2i > 0 or tcfg.batch_size_lm > 0):
            packable = (tcfg.pack_rows and tcfg.t2i_gen_mode == "mask"
                        and not self.cfg.use_gen_projector)
            return "packed" if packable else "fused"
        return "separate"

    def loss_and_grads(self, params, vq_params, vision_params, batch, key: Key, specs=None,
                       vision_specs=None
                       ) -> Tuple[List[Optional[torch.Tensor]], Dict[str, torch.Tensor]]:
        """(gradients in ``named_leaves`` order, None for a frozen leaf;
        metrics); the parameters are not touched. The separate mode runs
        two backward passes into the same leaves."""
        tcfg = self.tcfg
        metrics: Dict[str, torch.Tensor] = {}
        if self.mode != "separate":
            fn = self.loss_packed if self.mode == "packed" else self.loss_fused
            total, m = fn(params, vq_params, vision_params, batch, key, specs, vision_specs)
            total.backward()
            metrics.update(m)
        else:
            total = None
            if tcfg.batch_size_t2i > 0 or tcfg.batch_size_lm > 0:
                l1, m1 = self.loss_tl(params, vq_params, batch, key, specs)
                l1.backward()
                metrics.update(m1)
                total = l1.detach()
            if tcfg.batch_size_mmu > 0:
                l2, m2 = self.loss_mmu(params, vision_params, batch, specs, vision_specs)
                l2.backward()
                metrics.update(m2)
                total = l2.detach() if total is None else total + l2.detach()
        metrics["loss"] = total
        if "avg_masking_rate" not in metrics:
            metrics["avg_masking_rate"] = torch.zeros((), device=total.device)
        return _leaf_grads(params), {k: v.detach() for k, v in metrics.items()}

    def apply(self, state: TrainState, grads, metrics):
        """The update of ``grads``: the grad norm metric, AdamW in place."""
        return apply_update(self.tx, state, grads, metrics)

    def __call__(self, state: TrainState, vq_params, vision_params, batch, key: Key,
                 vision_sharding=None):
        """``vision_sharding``: the ``Sharding`` of a sharded tower."""
        tcfg = self.tcfg
        vision_specs = None if vision_sharding is None else vision_sharding.tree(vision_params)

        def draw(key):
            if tcfg.batch_size_t2i > 0:
                return global_draws(key, tcfg.batch_size_t2i, self.cfg.num_vq_tokens,
                                    self.cfg.codebook_size, state.step.device)
            return key

        def grads_fn(rows, key):
            step = SFTStep(self.cfg, self.vq_cfg, self.vision_cfg, self.tx, local_tcfg(tcfg))
            return step.loss_and_grads(state.params, vq_params, vision_params, rows, key,
                                       param_specs(state), vision_specs)
        return self.apply(state, *batch_grads(state, batch, key, draw, grads_fn))


def make_sft_train_step(cfg: UniGenConfig, vq_cfg: MagvitConfig, vision_cfg, tx: AdamW,
                        tcfg: SFTStepConfig) -> SFTStep:
    """The step: (state, vq_params, vision_params, batch, key) -> (state, metrics)."""
    return SFTStep(cfg, vq_cfg, vision_cfg, tx, tcfg)


def make_sft_grad_fns(cfg: UniGenConfig, vq_cfg: MagvitConfig, vision_cfg, tx: AdamW,
                      tcfg: SFTStepConfig):
    """The separate-mode step as three calls, JAX's split dispatch:

        g1, aux1 = grad_tl(state.params, vq_params, batch, key)
        g2, aux2 = grad_mmu(state.params, vision_params, batch)
        state, metrics = apply_grads(state, g1, g2, aux1, aux2)

    The gradients are lists in ``named_leaves`` order (None for a frozen
    leaf); their sum is the fused step's."""
    if not (tcfg.batch_size_t2i > 0 or tcfg.batch_size_lm > 0) or not tcfg.batch_size_mmu > 0:
        raise ValueError("split dispatch needs both task groups; use make_sft_train_step "
                         "when one group is empty")
    step = make_sft_train_step(cfg, vq_cfg, vision_cfg, tx, tcfg)

    def grads_of(params, loss):
        leaves = [t for _, t in named_leaves(params)]
        want = [t for t in leaves if t.requires_grad]
        got = iter(torch.autograd.grad(loss, want, allow_unused=True, materialize_grads=True))
        return [next(got) if t.requires_grad else None for t in leaves]

    def grad_tl(params, vq_params, batch, key: Key):
        l1, m1 = step.loss_tl(params, vq_params, batch, key)
        return grads_of(params, l1), (l1.detach(), {k: v.detach() for k, v in m1.items()})

    def grad_mmu(params, vision_params, batch):
        l2, m2 = step.loss_mmu(params, vision_params, batch)
        return grads_of(params, l2), (l2.detach(), {k: v.detach() for k, v in m2.items()})

    def apply_grads(state: TrainState, g1, g2, aux1, aux2):
        (l1, m1), (l2, m2) = aux1, aux2
        grads = [None if a is None else a + b for a, b in zip(g1, g2)]
        metrics = {**m1, **m2, "loss": l1 + l2}
        return step.apply(state, grads, metrics)

    return grad_tl, grad_mmu, apply_grads
