"""Understanding-benchmark adapter in lmms-eval's model protocol.

Port of ``unigen_tpu/evaluation/lmms_adapter.py``. ``generate_until`` builds
the ``mmu_conv`` embedding splice with the optional Qwen system prompt, runs
the prefix-LM cached decode of ``pipeline.understand`` and trims each answer
at its stop strings; ``loglikelihood`` scores continuations through
``pipeline.score_continuations``. Multi-image requests are pasted side by side
('concat') or reduced to their first image ('first'). Either tower works:
SigLIP images are resized to its fixed size (uint8, normalized on the
device), SigLIP2-NaFlex images by the patch-budget resize, and requests are
grouped by the prepared shape, which is predicted from the image's dims.

Images may be PIL images (lmms-eval hands those), recognised by their
``mode`` and ``convert`` and never by importing PIL (the card's machine has
none), or uint8 [H, W, 3] arrays. Sampling draws come from
``ops.sampling.derived_generator(seed, chunk index)``, where JAX splits a key
a chunk. Eager PyTorch compiles nothing, so nothing is warmed ahead of use:
the serving engine starts with no precompile list.

``register()`` exposes the class to lmms-eval as "unigen_tpu_torch" when the
package is installed; ``evaluation/lmms_plugin.py`` is the plugin module
that adapts lmms-eval's ``Instance`` requests. Without lmms-eval::

    adapter = UniGenLmmsAdapter(pipeline)
    answers = adapter.generate_until([(question, {"max_new_tokens": 32}, image)])
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..data.transform import (image_size, naflex_resize, naflex_target_dims, siglip_preprocess,
                              to_rgb_uint8)
from ..models.siglip2 import Siglip2Config
from ..ops.sampling import derived_generator
from ..pipeline import UniGenPipeline

QWEN_SYSTEM_PROMPT = "<|im_start|>system\nYou are a helpful assistant.<|im_end|>\n"
L2_BUCKET = 64      # vqa_serving_inputs' bucket of the question's part


def concat_images_horizontal(images: Sequence) -> np.ndarray:
    """Images pasted side by side, top-aligned, on a black canvas as tall as
    the tallest: [max H, sum W, 3] uint8."""
    arrs = [to_rgb_uint8(im) for im in images]
    canvas = np.zeros((max(a.shape[0] for a in arrs), sum(a.shape[1] for a in arrs), 3),
                      np.uint8)
    x = 0
    for a in arrs:
        canvas[:a.shape[0], x:x + a.shape[1]] = a
        x += a.shape[1]
    return canvas


def _trim(text: str, until) -> str:
    for stop in until or []:
        if stop and stop in text:
            text = text.split(stop)[0]
    return text


@dataclasses.dataclass
class UniGenLmmsAdapter:
    pipeline: UniGenPipeline
    multi_image_mode: str = "concat"       # 'concat' | 'first'
    max_new_tokens: int = 512
    use_system_prompt: bool = True
    seed: int = 0
    batch_size: int = 8                    # device batch of generate_until
    serving: bool = False                  # continuous batching through ServingEngine
    serving_slots: int = 16
    # an int pins every decode chunk; a sequence lets the engine choose
    serving_chunk: Any = 8
    serving_quantized_cache: bool = False
    serving_speculate_k: int = 0           # prompt-lookup speculative decode
    request_timeout: float = 3600.0
    last_stats: Optional[List[Any]] = None  # EngineStats of each serving engine run
    last_latency: Optional[Dict[str, float]] = None  # TTFT / ITL percentiles (s)

    @property
    def _naflex(self) -> bool:
        return isinstance(self.pipeline.vision_cfg, Siglip2Config)

    def _one_image(self, images):
        if isinstance(images, (list, tuple)):
            if len(images) == 0:
                raise ValueError("request without images")
            if len(images) > 1 and self.multi_image_mode == "concat":
                return concat_images_horizontal(images)
            return images[0]
        return images

    def _prepare_image(self, images) -> np.ndarray:
        """The tower's input of one request: the NaFlex resize ([th, tw, 3]
        float32 in [-1, 1]) or the SigLIP resize (uint8, normalized on the
        device with the same fp32 operations)."""
        image = self._one_image(images)
        vcfg = self.pipeline.vision_cfg
        if self._naflex:
            return naflex_resize(image, vcfg.patch_size, vcfg.num_patches)
        return siglip_preprocess(image, vcfg.image_size, as_uint8=True)

    def _raw_dims(self, images) -> Tuple[int, int]:
        """(width, height) the request presents to the preprocessor, from the
        image's dims only (no pixel is read or resized)."""
        if isinstance(images, (list, tuple)):
            if len(images) == 0:
                raise ValueError("request without images")
            if len(images) > 1 and self.multi_image_mode == "concat":
                dims = [self._raw_dims(im) for im in images]
                return sum(w for w, _ in dims), max(h for _, h in dims)
            images = images[0]
        return image_size(images)

    def _prepared_shape(self, images) -> tuple:
        """``_prepare_image(images).shape``, predicted from the dims alone."""
        vcfg = self.pipeline.vision_cfg
        if self._naflex:
            w, h = self._raw_dims(images)
            th, tw = naflex_target_dims(w, h, vcfg.patch_size, vcfg.num_patches)
            return (th, tw, 3)
        return (vcfg.image_size, vcfg.image_size, 3)

    def _num_patches(self, images) -> int:
        """The image tokens the splice will hold, from the dims alone."""
        vcfg = self.pipeline.vision_cfg
        if self._naflex:
            th, tw, _ = self._prepared_shape(images)
            return (th // vcfg.patch_size) * (tw // vcfg.patch_size)
        return (vcfg.image_size // vcfg.patch_size) ** 2

    def _gen_key(self, gen_kwargs: Dict) -> tuple:
        """A request's decode parameters (stop strings are host-side and left out)."""
        return (int(gen_kwargs.get("max_new_tokens", self.max_new_tokens)),
                float(gen_kwargs.get("temperature", 0.0) or 0.0),
                gen_kwargs.get("top_k"))

    def _system_ids(self) -> Optional[np.ndarray]:
        if not self.use_system_prompt:
            return None
        return np.asarray([self.pipeline.prompting._tokenize(QWEN_SYSTEM_PROMPT)[0]])

    def generate_until(self, requests: List[Tuple[str, Dict, Any]]) -> List[str]:
        """[(context, gen_kwargs, images)] -> generated strings, in request
        order. gen_kwargs: 'max_new_tokens', 'temperature', 'top_k' and
        'until' stop strings.

        Requests are grouped by their decode parameters and prepared shape
        and run in device batches of ``batch_size`` through ``understand``; a
        last partial batch is padded by repeating its last request (the
        padded answers are dropped). One-deep pipelining: batch i + 1 is
        prepared and queued before batch i's tokens are read. With
        ``serving=True`` the requests go through the continuous-batching
        ``ServingEngine`` instead."""
        if self.serving:
            return self._generate_until_serving(requests)
        out: List[Optional[str]] = [None] * len(requests)
        sys_ids = self._system_ids()
        groups: Dict[tuple, List[int]] = {}
        for i, (_, gen_kwargs, images) in enumerate(requests):
            groups.setdefault(self._gen_key(gen_kwargs)
                              + (self._prepared_shape(images),), []).append(i)

        def flush(pending):
            chunk, toks = pending
            texts = self.pipeline.decode_text(toks)[:len(chunk)]
            for i, text in zip(chunk, texts):
                out[i] = _trim(text, requests[i][1].get("until"))

        pending = None
        n_chunk = 0
        for (max_new, temperature, top_k, _shape), idxs in groups.items():
            for start in range(0, len(idxs), self.batch_size):
                chunk = idxs[start:start + self.batch_size]
                full = chunk + [chunk[-1]] * (self.batch_size - len(chunk))
                pixels = np.stack([self._prepare_image(requests[i][2]) for i in full])
                gen = derived_generator(self.seed, n_chunk, device=self.pipeline.device)
                n_chunk += 1
                toks = self.pipeline.understand(
                    pixels, [requests[i][0] for i in full], gen, system_prompt_ids=sys_ids,
                    max_new_tokens=max_new, temperature=temperature, top_k=top_k)
                if pending is not None:
                    flush(pending)
                pending = (chunk, toks)
        if pending is not None:
            flush(pending)
        return out

    def _generate_until_serving(self, requests) -> List[str]:
        """``generate_until`` over the continuous-batching engine: the tower
        runs in chunks of ``batch_size`` requests of one prepared shape, and
        every request then decodes in shared slots with its own budget and
        temperature, so a short answer frees its slot at once. One engine a
        ``top_k`` (an engine-wide setting); its buckets are the splice
        lengths (system prompt + 3 head tokens + image tokens + the bucketed
        question), predicted from the dims."""
        from ..serving import ServingEngine

        if not requests:
            return []
        pipe = self.pipeline
        sys_ids = self._system_ids()
        sys_len = 0 if sys_ids is None else sys_ids.shape[1]
        metas = []       # (splice length, max_new, temperature, top_k) a request
        for context, gen_kwargs, images in requests:
            q_len = len(pipe._vqa_question_ids(context))
            splice = sys_len + 3 + self._num_patches(images) + -(-q_len // L2_BUCKET) * L2_BUCKET
            metas.append((splice,) + self._gen_key(gen_kwargs))
        buckets = sorted({m[0] for m in metas})
        max_len = max(m[0] + m[1] for m in metas) + self.serving_speculate_k
        out: List[Optional[str]] = [None] * len(requests)
        by_topk: Dict[Any, List[int]] = {}
        for i, m in enumerate(metas):
            by_topk.setdefault(m[3], []).append(i)
        self.last_stats = []
        for top_k, idxs in by_topk.items():
            with ServingEngine(pipe.params, pipe.cfg, slots=self.serving_slots, max_len=max_len,
                               buckets=buckets, chunk=self.serving_chunk, top_k=top_k,
                               quantized_cache=self.serving_quantized_cache,
                               speculate_k=self.serving_speculate_k, seed=self.seed,
                               device=pipe.device, sharding=pipe.sharding) as eng:
                futs: Dict[int, Any] = {}
                shape_groups: Dict[tuple, List[int]] = {}
                for i in idxs:
                    shape_groups.setdefault(self._prepared_shape(requests[i][2]), []).append(i)
                for sidx in shape_groups.values():
                    for start in range(0, len(sidx), self.batch_size):
                        chunk = sidx[start:start + self.batch_size]
                        pixels = np.stack([self._prepare_image(requests[i][2]) for i in chunk])
                        questions = [requests[i][0] for i in chunk]
                        trips = pipe.vqa_serving_inputs(pixels, questions,
                                                        system_prompt_ids=sys_ids,
                                                        l2_bucket=L2_BUCKET)
                        lookups = pipe.vqa_lookup_ids(
                            questions, system_prompt_ids=sys_ids,
                            num_patches=self._num_patches(requests[chunk[0]][2]))
                        for i, (emb, meta, plen), lookup in zip(chunk, trips, lookups):
                            futs[i] = eng.submit_embeds(
                                emb, meta, plen, max_new_tokens=metas[i][1],
                                temperature=metas[i][2], eot_token=pipe.prompting.eos_token_id,
                                lookup_ids=lookup)
                results = {i: f.result(timeout=self.request_timeout) for i, f in futs.items()}
                self.last_stats.append(eng.stats)
                self._record_latency(futs.values())
            for i, toks in results.items():
                text = pipe.decode_text(np.asarray([toks], np.int64))[0]
                out[i] = _trim(text, requests[i][1].get("until"))
        return out

    def _record_latency(self, futures) -> None:
        """Client-observed TTFT and inter-token latency percentiles over one
        engine run."""
        ttft = sorted(f.ttft for f in futures if f.ttft is not None)
        itl = sorted(f.itl for f in futures if f.itl is not None)

        def pct(xs, q):
            return xs[min(len(xs) - 1, int(q * (len(xs) - 1)))] if xs else float("nan")
        self.last_latency = {"ttft_p50_s": pct(ttft, 0.50), "ttft_p99_s": pct(ttft, 0.99),
                             "itl_p50_s": pct(itl, 0.50), "itl_p99_s": pct(itl, 0.99),
                             "n": len(ttft)}

    def loglikelihood(self, requests) -> List[Tuple[float, bool]]:
        """[(context, continuation, images)] -> [(sum log p, is_greedy)], in
        request order: grouped by prepared shape, scored in batches of
        ``batch_size`` (one forward each, ``score_continuations``), a last
        partial batch padded by repeating its last request."""
        out: List[Optional[Tuple[float, bool]]] = [None] * len(requests)
        sys_ids = self._system_ids()
        shape_groups: Dict[tuple, List[int]] = {}
        for i, (_, _, images) in enumerate(requests):
            shape_groups.setdefault(self._prepared_shape(images), []).append(i)
        for sidx in shape_groups.values():
            for start in range(0, len(sidx), self.batch_size):
                chunk = sidx[start:start + self.batch_size]
                full = chunk + [chunk[-1]] * (self.batch_size - len(chunk))
                pixels = np.stack([self._prepare_image(requests[i][2]) for i in full])
                conts = [np.asarray(self.pipeline.prompting._tokenize(requests[i][1])[0],
                                    np.int64) for i in full]
                scored = self.pipeline.score_continuations(
                    pixels, [requests[i][0] for i in full], conts, system_prompt_ids=sys_ids)
                for i, s in zip(chunk, scored[:len(chunk)]):
                    out[i] = s
        return out


def register(name: str = "unigen_tpu_torch"):
    """Register the adapter with lmms-eval when the package is installed."""
    try:
        from lmms_eval.api.registry import register_model
    except ImportError:
        return None
    return register_model(name)(UniGenLmmsAdapter)
