"""High-level inference pipeline: prompts -> images, images -> answers.

Port of ``unigen_tpu/pipeline.py::UniGenPipeline``: ``generate_images`` (modes
``"mask"`` and ``"ar"``), ``decode_codes``, ``encode_pixels``,
``understand_discrete`` (VQA over the tokenizer's codes), ``understand`` (VQA
through the fixed-resolution SigLIP tower and the MM projector),
``score_continuation(s)`` (log-likelihoods of continuations after a VQA
prompt), ``vqa_serving_inputs`` (one request's splice for the serving
engine's ``submit_embeds``), ``generate_text``, ``decode_text`` and
``pixels_to_uint8``. Host work is prompt assembly; everything else runs on
the pipeline's device.
``understand`` and the scoring calls take pixels as arrays or tensors (uint8
HWC, normalized on the device in fp32, or floats already in [-1, 1]), not as
PIL images.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .device import to_device
from .generation import generate_text as _generate_text
from .generation import mmu_generate, t2i_generate, t2i_generate_ar
from .models import magvit, qwen2, siglip, unigen
from .ops import masks as M
from .ops import sampling as S
from .prompting import UniPrompting
from .weights import tree_to


@torch.no_grad()
def _generate_codes(params, cfg, ids, uncond_ids, generator, *, pad_id, guidance_scale,
                    timesteps, temperature, mask_schedule, mode="mask", noise=None):
    """``t2i_generate`` on its prefix-cached path, which reads no dense omni
    mask, so none is built (JAX builds one and its jit drops it unread); or,
    with ``mode="ar"``, ``t2i_generate_ar`` with the non-pad tokens of the
    cond and uncond rows as its padding mask."""
    if mode == "ar":
        keep = torch.cat([ids, uncond_ids], dim=0) != pad_id
        return t2i_generate_ar(params, cfg, generator, ids, uncond_ids, keep,
                               guidance_scale=guidance_scale, temperature=temperature,
                               noise=noise)
    return t2i_generate(params, cfg, generator, ids, None, uncond_input_ids=uncond_ids,
                        temperature=temperature, timesteps=timesteps,
                        guidance_scale=guidance_scale,
                        noise_schedule=S.get_mask_schedule(mask_schedule),
                        pad_id=pad_id, noise=noise)


@torch.no_grad()
def _mmu_vit_score(params, cfg, part1, part2c, img_embeds, cont_mask, valid_len):
    """Sum of the log-likelihoods of ``part2c``'s continuation tokens
    (``cont_mask``) and whether each is the greedy choice: one cache-free
    forward through the flash kernel, pads at and beyond ``valid_len`` of
    each row's part2c, the text head on the positions that predict part2c,
    fp32 ``log_softmax``. Pad query rows are never read: ``torch.where``
    drops them from the sum and the flag (a product with a 0/1 mask would
    carry a non-finite value into both)."""
    e1 = unigen.embed_tokens(params, part1)
    e2 = unigen.embed_tokens(params, part2c)
    embeds = torch.cat([e1, img_embeds.to(e1.dtype), e2], dim=1)
    b, l, _ = embeds.shape
    off = l - part2c.shape[1]                        # start of part2c in the splice
    meta = M.pack_meta(M.mmu_vit_attn_meta(b, l, num_tokens=img_embeds.shape[1],
                                           prefix_length=part1.shape[1],
                                           prompt_len=off + valid_len))
    hidden, _ = qwen2.forward(params["llm"], cfg.llm, inputs_embeds=embeds, meta_bits=meta)
    # the hidden state at splice position off + j - 1 predicts part2c[:, j]
    logits = qwen2.logits(params["llm"], cfg.llm, hidden[:, off - 1:l - 1]).float()
    tok_lp = torch.gather(torch.log_softmax(logits, dim=-1), -1, part2c[..., None])[..., 0]
    greedy = torch.argmax(logits, dim=-1) == part2c
    return (torch.where(cont_mask, tok_lp, 0.0).sum(dim=-1),
            torch.where(cont_mask, greedy, True).all(dim=-1))


@torch.no_grad()
def _mmu_vit_inputs(params, part1, part2, img_embeds, prompt_len):
    """The spliced embeddings [B, L, D] and mmu_vit meta bits [B, L] int32 of
    an understanding prompt, the construction ``understand`` performs before
    ``mmu_generate``, returned for the serving engine's ``submit_embeds``.
    JAX returns the dense [B, 1, L, L] mask; the bits are its form for the
    flash kernel, and on every non-pad query row they are the same mask.
    Slots at and beyond ``prompt_len`` are pad, so a bucketed part2 changes
    no result."""
    e1 = unigen.embed_tokens(params, part1)
    e2 = unigen.embed_tokens(params, part2)
    embeds = torch.cat([e1, img_embeds.to(e1.dtype), e2], dim=1)
    b, l, _ = embeds.shape
    meta = M.pack_meta(M.mmu_vit_attn_meta(b, l, num_tokens=img_embeds.shape[1],
                                           prefix_length=part1.shape[1], prompt_len=prompt_len))
    return embeds, meta


# score_continuations pads each batch's question + continuation tails up to a
# multiple of this many tokens
SCORE_LENGTH_BUCKET = 64


@dataclasses.dataclass
class UniGenPipeline:
    params: Any
    cfg: unigen.UniGenConfig
    vq_params: Any
    vq_cfg: magvit.MagvitConfig
    prompting: UniPrompting
    device: torch.device
    vision_params: Optional[Any] = None
    vision_cfg: Optional[siglip.SiglipConfig] = None
    quantized_cache: bool = False   # int8 KV cache for understand and generate_text

    def to(self, device) -> "UniGenPipeline":
        """A pipeline with every parameter moved to ``device``."""
        device = torch.device(device)
        return dataclasses.replace(self, params=tree_to(self.params, device),
                                   vq_params=tree_to(self.vq_params, device),
                                   vision_params=tree_to(self.vision_params, device),
                                   device=device)

    def prompt_ids(self, prompts: Sequence[str], max_text_len: int = 128
                   ) -> Tuple[np.ndarray, np.ndarray]:
        """(cond ids, uncond ids), each [B, L] int64, for the t2i_gen task."""
        n = self.cfg.num_vq_tokens
        mask_img = np.full((len(prompts), n), self.cfg.mask_token_id, np.int64)
        ids, _ = self.prompting((list(prompts), mask_img, max_text_len), "t2i_gen")
        uncond_ids, _ = self.prompting(([""] * len(prompts), mask_img, max_text_len),
                                       "t2i_gen")
        return ids, uncond_ids

    def generate_images(
        self,
        prompts: Sequence[str],
        generator: Optional[torch.Generator],
        *,
        guidance_scale: float = 6.0,
        timesteps: int = 50,
        temperature: float = 1.0,
        max_text_len: int = 128,
        mask_schedule: str = "cosine",
        mode: str = "mask",
        return_codes: bool = False,
        noise=None,
    ) -> torch.Tensor:
        """prompts -> pixels in [-1, 1], [B, H, W, 3] (GenEval protocol
        defaults: guidance 6, 50 steps, 128-token text budget). ``mode``:
        ``"mask"`` (MaskGIT) or ``"ar"`` (one token a step; ``timesteps`` and
        ``mask_schedule`` unused). ``generator`` lives on the pipeline's
        device; ``noise`` is the shared-noise hook of ``t2i_generate``
        ((u_sample, u_mask)) or of ``t2i_generate_ar`` ([N, B, CB])."""
        if mode not in ("mask", "ar"):
            raise ValueError(f"mode must be 'mask' or 'ar', got {mode!r}")
        ids, uncond_ids = self.prompt_ids(prompts, max_text_len)
        codes = _generate_codes(
            self.params, self.cfg, torch.as_tensor(ids, device=self.device),
            torch.as_tensor(uncond_ids, device=self.device), generator,
            pad_id=self.prompting.pad_id, guidance_scale=guidance_scale, timesteps=timesteps, temperature=temperature,
            mask_schedule=mask_schedule, mode=mode, noise=noise)
        if return_codes:
            return codes
        return self.decode_codes(codes)

    def decode_codes(self, codes: torch.Tensor) -> torch.Tensor:
        """Codebook ids -> pixels in [-1, 1] (clamped into the codebook first)."""
        codes = torch.clamp(codes, 0, self.cfg.codebook_size - 1)
        return magvit.decode_code(self.vq_params, self.vq_cfg, codes)

    @torch.no_grad()
    def encode_pixels(self, pixels) -> torch.Tensor:
        """Pixels in [-1, 1], [B, H, W, 3] (array or tensor) -> codebook ids
        [B, N] int32. The encoder runs in the pixels' dtype, as JAX's does
        (float64 and integer pixels become float32, JAX's default)."""
        x = torch.as_tensor(pixels, device=self.device)
        if x.dtype == torch.float64 or not torch.is_floating_point(x):
            x = x.float()
        return magvit.get_code(self.vq_params, self.vq_cfg, x)

    # ------------------------------------------------------------------ mmu --

    @torch.no_grad()
    def understand_discrete(
        self,
        pixels,
        questions: Sequence[str],
        generator: Optional[torch.Generator],
        *,
        max_new_tokens: int = 128,
        temperature: float = 0.0,
        top_k: Optional[int] = None,
        noise: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """VQA over the tokenizer's codes (the ``mmu`` task): [B,
        max_new_tokens] ids. ``pixels`` in [-1, 1], [B, H, W, 3]; the prompt is
        right-padded to the prompting's ``max_seq_len``. ``noise`` is
        ``mmu_generate``'s shared-noise hook."""
        ids, prompt_len = self._mmu_prompt(self.encode_pixels(pixels).cpu().numpy(), questions)
        ids = torch.as_tensor(ids, device=self.device)
        prompt_len = torch.as_tensor(prompt_len, device=self.device)
        meta = M.pack_meta(M.mmu_attn_meta(ids, self.prompting.sptids_dict["<|eoi|>"],
                                           prompt_len))
        return mmu_generate(self.params, self.cfg, generator, input_ids=ids, meta_bits=meta,
                            prompt_len=prompt_len, max_new_tokens=max_new_tokens,
                            temperature=temperature, top_k=top_k,
                            eot_token=self.prompting.eos_token_id,
                            quantized_cache=self.quantized_cache, noise=noise)

    def _mmu_prompt(self, codes: np.ndarray, questions: Sequence[str]
                    ) -> Tuple[np.ndarray, np.ndarray]:
        """The ``mmu`` prompt of codebook ids [B, N]: (ids [B, max_seq_len],
        right-padded, and each row's prompt length)."""
        ids, att, _ = self.prompting((codes.astype(np.int64) + self.cfg.text_vocab_len,
                                      list(questions)), "mmu")
        return ids, att.sum(axis=1)

    def _vqa_question_ids(self, question: str) -> np.ndarray:
        """The full chat template of one question; ``mmu_conv`` drops its
        leading ``<|im_start|>`` (the template must carry it, or the first
        question token would be lost)."""
        return np.asarray(self.prompting._tokenize(
            f"<|im_start|>user\n{question}<|im_end|>\n<|im_start|>assistant\n")[0], np.int64)

    def _vqa_parts(self, questions: Sequence[str], num_patches: int,
                   system_prompt_ids: Optional[np.ndarray]):
        """``mmu_conv``'s (part1, part2) around ``num_patches`` image
        embeddings, the questions right-padded to the longest, and each
        question's template length: part2's real length, since part2 is
        ``<|eoi|>`` and the template without its first token."""
        q_ids = [self._vqa_question_ids(q) for q in questions]
        q_arr = np.full((len(q_ids), max(len(q) for q in q_ids)), self.prompting.pad_id,
                        np.int64)
        for i, q in enumerate(q_ids):
            q_arr[i, :len(q)] = q
        part1, part2, _, _ = self.prompting((np.zeros((len(q_ids), num_patches, 1)), q_arr,
                                             None, system_prompt_ids), "mmu_conv")
        return part1, part2, np.asarray([len(q) for q in q_ids])

    @torch.no_grad()
    def _image_embeds(self, pixels) -> torch.Tensor:
        """SigLIP tower + MM projector: [B, H, W, 3] -> [B, P, hidden]. uint8
        pixels are normalized on the device, ``(x / 255 - 0.5) / 0.5`` in fp32."""
        if self.vision_params is None:
            raise ValueError("the pipeline was built without a vision tower")
        x = torch.as_tensor(pixels, device=self.device)
        if not torch.is_floating_point(x):
            x = (x.float() / 255.0 - 0.5) / 0.5
        feats = siglip.forward(self.vision_params, self.vision_cfg, x)
        return unigen.mm_project(self.params, feats)

    @torch.no_grad()
    def understand(
        self,
        pixels,
        questions: Sequence[str],
        generator: Optional[torch.Generator],
        *,
        system_prompt_ids: Optional[np.ndarray] = None,
        max_new_tokens: int = 128,
        temperature: float = 0.0,
        top_k: Optional[int] = None,
        noise: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """VQA through the continuous SigLIP path: [B, max_new_tokens] ids.

        ``pixels`` [B, 384, 384, 3]: uint8, or floats normalized with
        mean = std = 0.5. ``noise`` is ``mmu_generate``'s shared-noise hook.
        """
        img_embeds = self._image_embeds(pixels)
        b, p, _ = img_embeds.shape
        part1, part2, q_lens = self._vqa_parts(questions, p, system_prompt_ids)
        prompt_len = torch.as_tensor(part1.shape[1] + p + 1 + (q_lens - 1),
                                     device=self.device)      # part1 + img + eoi + text
        e1 = unigen.embed_tokens(self.params, torch.as_tensor(part1, device=self.device))
        e2 = unigen.embed_tokens(self.params, torch.as_tensor(part2, device=self.device))
        embeds = torch.cat([e1, img_embeds.to(e1.dtype), e2], dim=1)
        meta = M.pack_meta(M.mmu_vit_attn_meta(b, embeds.shape[1], num_tokens=p,
                                               prefix_length=part1.shape[1],
                                               prompt_len=prompt_len))
        return mmu_generate(self.params, self.cfg, generator, input_embeddings=embeds,
                            meta_bits=meta, prompt_len=prompt_len,
                            max_new_tokens=max_new_tokens, temperature=temperature,
                            top_k=top_k, eot_token=self.prompting.eos_token_id,
                            quantized_cache=self.quantized_cache, noise=noise)

    def score_continuations(
        self,
        pixels,
        questions: Sequence[str],
        continuations: Sequence[np.ndarray],
        *,
        system_prompt_ids: Optional[np.ndarray] = None,
        length_bucket: int = SCORE_LENGTH_BUCKET,
    ) -> List[Tuple[float, bool]]:
        """(sum log p(continuation | image, question), greedy-match flag) for
        B triples in one forward, the lmms-eval ``loglikelihood`` contract.
        Each question + continuation tail is right-padded to the batch's
        longest, rounded up to a multiple of ``length_bucket``; pad slots are
        left out of attention and of the sum, so the bucket changes no
        result."""
        img_embeds = self._image_embeds(pixels)
        b, p, _ = img_embeds.shape
        part1, part2c, cont_mask, l2_real = self._score_parts(
            questions, continuations, p, system_prompt_ids, length_bucket)
        lp, greedy = _mmu_vit_score(self.params, self.cfg,
                                    torch.as_tensor(part1, device=self.device),
                                    torch.as_tensor(part2c, device=self.device), img_embeds,
                                    torch.as_tensor(cont_mask, device=self.device),
                                    torch.as_tensor(l2_real, device=self.device))
        lp, greedy = lp.cpu(), greedy.cpu()
        return [(float(lp[i]), bool(greedy[i])) for i in range(b)]

    def _score_parts(self, questions: Sequence[str], continuations: Sequence[np.ndarray],
                     num_patches: int, system_prompt_ids: Optional[np.ndarray],
                     length_bucket: int):
        """(part1, part2c, cont_mask, part2c's real lengths) of a scoring
        batch: each question's template and continuation, right-padded to
        the longest, rounded up to a multiple of ``length_bucket``."""
        part1, part2, l2_q = self._vqa_parts(questions, num_patches, system_prompt_ids)
        conts = [np.asarray(c, np.int64).reshape(-1) for c in continuations]
        l2_real = l2_q + np.asarray([len(c) for c in conts])
        l2 = -(-int(l2_real.max()) // length_bucket) * length_bucket
        part2c = np.full((len(conts), l2), self.prompting.pad_id, np.int64)
        cont_mask = np.zeros((len(conts), l2), bool)
        for i, c in enumerate(conts):
            part2c[i, :l2_q[i]] = part2[i, :l2_q[i]]
            part2c[i, l2_q[i]:l2_real[i]] = c
            cont_mask[i, l2_q[i]:l2_real[i]] = True
        return part1, part2c, cont_mask, l2_real

    def score_continuation(self, pixels, question: str, continuation_ids: np.ndarray, *,
                           system_prompt_ids: Optional[np.ndarray] = None,
                           length_bucket: int = SCORE_LENGTH_BUCKET) -> Tuple[float, bool]:
        """``score_continuations`` of one (image [1, H, W, 3], question,
        continuation) triple."""
        return self.score_continuations(pixels, [question], [continuation_ids],
                                        system_prompt_ids=system_prompt_ids,
                                        length_bucket=length_bucket)[0]

    def vqa_serving_inputs(self, pixels, questions: Sequence[str], *,
                           system_prompt_ids: Optional[np.ndarray] = None,
                           l2_bucket: int = 64) -> List[tuple]:
        """One ``(embeds [1, L, D], meta_bits [1, L], prompt_len)`` a question,
        for ``ServingEngine.submit_embeds``: ``understand``'s splice of image i
        and question i, the question's part right-padded to a multiple of
        ``l2_bucket`` (one admission shape a bucket, not one a question
        length). Embeddings and bits stay on the device, and the ids go up without
        waiting for the queued work, so a submitter does not stall the
        engine's decode."""
        img_embeds = self._image_embeds(pixels)
        _, p, _ = img_embeds.shape
        out = []
        for i, q in enumerate(questions):
            part1, part2, _, _ = self.prompting((np.zeros((1, p, 1)), self._vqa_question_ids(q)[None],
                                                 None, system_prompt_ids), "mmu_conv")
            l2 = part2.shape[1]
            part2p = np.full((1, -(-l2 // l2_bucket) * l2_bucket), self.prompting.pad_id, np.int64)
            part2p[0, :l2] = part2[0]
            plen = part1.shape[1] + p + l2
            embeds, meta = _mmu_vit_inputs(
                self.params, to_device(part1, self.device), to_device(part2p, self.device),
                img_embeds[i:i + 1], to_device(np.asarray([plen]), self.device))
            out.append((embeds, meta, plen))
        return out

    # ------------------------------------------------------------- text-only --

    @torch.no_grad()
    def generate_text(self, prompts: Sequence[str], generator: Optional[torch.Generator], *,
                      max_new_tokens: int = 128, temperature: float = 0.0,
                      top_k: Optional[int] = None) -> List[str]:
        """Plain text generation with the unified backbone, decoded to strings."""
        tok_ids = [self.prompting._tokenize(
            f"<|im_start|>user\n{p}<|im_end|>\n<|im_start|>assistant\n")[0] for p in prompts]
        ids = np.full((len(prompts), max(len(t) for t in tok_ids)), self.prompting.pad_id,
                      np.int64)
        for i, t in enumerate(tok_ids):
            ids[i, :len(t)] = t
        out = _generate_text(self.params, self.cfg, generator,
                             torch.as_tensor(ids, device=self.device),
                             torch.as_tensor([len(t) for t in tok_ids], device=self.device),
                             max_new_tokens=max_new_tokens, temperature=temperature,
                             top_k=top_k, eot_token=self.prompting.eos_token_id,
                             quantized_cache=self.quantized_cache)
        return self.decode_text(out)

    def decode_text(self, token_ids) -> List[str]:
        """Token ids -> strings, each row cut at its first eos."""
        ids = token_ids.cpu().numpy() if isinstance(token_ids, torch.Tensor) else \
            np.asarray(token_ids)
        out = []
        for row in ids:
            stop = np.flatnonzero(row == self.prompting.eos_token_id)
            row = row[: stop[0]] if len(stop) else row
            out.append(self.prompting.text_tokenizer.decode([int(i) for i in row]))
        return out


def pixels_to_uint8(pixels) -> np.ndarray:
    """[-1, 1] floats -> uint8 HWC images. uint8 input passes through unchanged."""
    if isinstance(pixels, torch.Tensor):
        pixels = pixels.detach().float().cpu().numpy()
    arr = np.asarray(pixels)
    if arr.dtype == np.uint8:
        return arr
    x = np.clip((arr.astype(np.float32) + 1.0) / 2.0, 0.0, 1.0)
    return (x * 255.0).round().astype(np.uint8)
