"""CoT-V Best-of-N test-time scaling: generate N candidates, self-verify, rank.

Port of ``unigen_tpu/evaluation/cot.py`` and the counterpart of
``scripts/inference_cot.py``. Stage 1 generates ``n_samples`` images a
prompt; stage 2 rates every candidate by self-VQA in one of three prompt
styles (outcome / think / rule); candidates are ranked by their share of
"yes" answers and the top-k are kept. Candidates stay on the device from
generation through rating (codes -> pixels -> resize -> SigLIP features, or
pixels -> the tokenizer's codes); only their uint8 copies go to the host.

Each prompt's generation and rating draw from generators derived from the
seed and the prompt's global index (``ops.sampling.derived_generator``), so
a sharded run gives the single-process run's samples and selections.

Run as a module (random weights from ``--seed`` until checkpoints exist;
flags with ``scripts/inference_cot.py``'s defaults stand in for its YAML
config)::

    python -m unigen_tpu_torch.evaluation.cot --metadata-file prompts.jsonl \\
        --output-dir out --n-samples 20 --topk 4 --style rule [--vision]

which writes ``<out>/t2i_samples_step{T}_scale{G}/<idx:05>/samples/*.png``
(all candidates), ``<out>/t2i_samples_step{T}_scale{G}_selected_prompt_{style}/``
(the top-k) and, from rank 0, ``rating_table_{style}.jsonl`` and
``rating_stats_{style}.jsonl``.
"""
from __future__ import annotations

import argparse
import json
import os
import re
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..data.transform import naflex_resize
from ..models.siglip2 import Siglip2Config
from ..ops.sampling import derived_generator
from ..pipeline import UniGenPipeline, pixels_to_uint8
from ..utils.multihost import gather_objects, process_index
from .geneval import load_metadata_jsonl, save_png, shard_for_process

# the derived generators' streams of one prompt
GEN_STREAM, RATE_STREAM = 1, 2

# Rating prompt protocol (reference :44-54)
QWEN_TEMPLATE = "<|im_start|>user\n{user_prompt}<|im_end|>\n<|im_start|>assistant\n"
QWEN_SYSTEM_PROMPT = "<|im_start|>system\nYou are a helpful assistant.<|im_end|>\n"
MMU_RATING_USER_PROMPT = {
    "outcome": ("This image is generated by a prompt: {context}. Does this image "
                "accurately represent the prompt? Please answer yes or no."),
    "think": ("This image is generated by a prompt: {context}. Please assess the image "
              "generation quality step by step. First, breakdown the prompt into "
              "multiple visual questions and iteratively answer each question with Yes "
              "or No between <think_start> <think_end>. Questions should cover "
              "all-round details about whether the image accurately represents entity "
              "categories, counting of entities, color, spatial relationship in the "
              "prompt. Next, output the final result between <answer_start> "
              "<answer_end>. Output Yes if all multi-choice answers equal yes to show "
              "the image has accurate alignment with the prompt. Otherwise answer "
              "with No."),
    "rule": "{context}  Please answer yes or no.",
}

_COLORS = {"red", "brown", "pink", "yellow", "orange", "green", "blue", "purple",
           "white", "black", "gray"}
_NUMBERS = {"one", "two", "three", "four", "five", "six", "seven", "eight", "nine",
            "ten"}


def parse_yesno(answer: str) -> str:
    """Leading yes/no, defaulting to 'no' (reference :246-251)."""
    m = re.match(r"^\s*(yes|no)\b", answer, re.IGNORECASE)
    return m.group(1).lower() if m else "no"


def parse_qa_pairs(text: str, start_token: str = "<think_start>",
                   end_token: str = "<think_end>") -> List[Tuple[str, str]]:
    """Extract (question, yes/no) pairs from a think-style CoT answer
    (reference :254-275)."""
    if start_token not in text:
        text = start_token + text
    if end_token not in text:
        text = text + end_token
    section = re.search(rf"{re.escape(start_token)}(.*?){re.escape(end_token)}",
                        text, re.DOTALL | re.IGNORECASE)
    if not section:
        return [("", "no")]
    matches = re.findall(r"(.*?\?)(?:\s*)(yes|no)\b", section.group(1),
                         flags=re.IGNORECASE | re.DOTALL)
    if not matches:
        return [("", "no")]
    out = []
    for q, a in matches:
        q = re.sub(r"^[;.\s]+", "", q.strip())
        if not q.endswith("?"):
            q += "?"
        out.append((q, a.lower()))
    return out


def geneval_prompt2questions(prompt: str) -> Optional[List[str]]:
    """Derive rule-style yes/no questions from a GenEval prompt (reference :431-502).

    Handles the five GenEval families: two-color attributes, spatial relations,
    single color, counting, single/two objects.
    """
    prompt = prompt.lower().strip()

    def article(word):
        return "an" if word[0] in "aeiou" else "a"

    m = re.match(r"a photo of an? (\w+) ([\w\s]+?) and an? (\w+) ([\w\s]+)", prompt)
    if m:
        c1, o1, c2, o2 = m.groups()
        if c1 in _COLORS:
            return [f"Is there a {o1.strip().split()[-1]}?",
                    f"Is there a {o2.strip().split()[-1]}?",
                    f"Is the {o1.strip()} {c1}?",
                    f"Is the {o2.strip()} {c2}?"]

    m = re.match(r"a photo of (?:a[n]? )?([\w\s]+?) "
                 r"(above|below|left of|right of|in front of|behind) "
                 r"(?:a[n]? )?([\w\s]+)", prompt)
    if m:
        o1, rel, o2 = m.groups()
        return [f"Is there {article(o1)} {o1.strip()}?",
                f"Is there {article(o2)} {o2.strip()}?",
                f"Is the {o1.strip()} {rel} the {o2.strip()}?"]

    if " and " not in prompt:
        m = re.match(r"a photo of an? (\w+) ([\w\s]+)", prompt)
        if m and m.group(1) in _COLORS:
            color, obj = m.groups()
            return [f"Is there a {obj.strip().split()[-1]}?",
                    f"Is the {obj.strip()} {color}?"]
        m = re.match(r"a photo of (\w+) ([\w\s]+)", prompt)
        if m and m.group(1) in _NUMBERS:
            num, obj = m.groups()
            return [f"Are there {obj.strip()}?", f"Are there {num} {obj.strip()}?"]
        m = re.match(r"a photo of an? ([\w\s]+)", prompt)
        if m:
            return [f"Is there a {m.group(1).strip()}?"]
    else:
        objects = [o.strip() for o in prompt.split("a photo of")[1].split("and")]
        return [f"Is there a {o.strip().split()[-1]}?" for o in objects]
    return None


def greedy_samples_byscore(rating_table: List[Dict], topk: int = 4):
    """Rank candidates per instance by yes-ratio; keep topk (reference :507-534).

    rating_table rows: {image_id: 'inst/samples/i.png', question, answer}.
    Returns (selected image_ids, per-image stats list).
    """
    per_image: Dict[str, List[str]] = defaultdict(list)
    for row in rating_table:
        per_image[row["image_id"]].append(row["answer"])
    stats = []
    for image_id, answers in per_image.items():
        yes = sum(a == "yes" for a in answers)
        stats.append({"instance_id": image_id.split("/")[0], "image_id": image_id,
                      "yes_count": yes, "total_questions": len(answers),
                      "score": yes / len(answers)})
    selected = []
    by_instance: Dict[str, List[Dict]] = defaultdict(list)
    for s in stats:
        by_instance[s["instance_id"]].append(s)
    for inst in sorted(by_instance):
        ranked = sorted(by_instance[inst], key=lambda s: -s["score"])
        selected.extend(s["image_id"] for s in ranked[:topk])
    return selected, stats


def resize_bilinear(pixels: torch.Tensor, size: int) -> torch.Tensor:
    """[N, H, W, 3] -> [N, size, size, 3] in the pixels' dtype, as
    ``jax.image.resize(..., "bilinear")`` upsamples (half-pixel centres, no
    antialiasing). Upsampling only: JAX antialiases a downsample."""
    n, h, w, _ = pixels.shape
    if size < h or size < w:
        raise ValueError(f"resize_bilinear upsamples only: {h} x {w} -> {size}")
    x = F.interpolate(pixels.permute(0, 3, 1, 2), size=(size, size), mode="bilinear",
                      align_corners=False, antialias=False)
    return x.permute(0, 2, 3, 1).contiguous()


def rate_candidates(
    pipeline: UniGenPipeline,
    pixels_256,                    # [N, 256, 256, 3] candidate images in [-1, 1]
    prompt: str,
    generator: Optional[torch.Generator],
    *,
    style: str = "rule",
    questions: Optional[Sequence[str]] = None,
    max_new_tokens: int = 128,
    use_vision_tower: bool = False,
    instance_id: str = "prompt",
) -> List[Dict]:
    """Self-VQA rate a batch of candidates on the pipeline's device, greedy.
    Returns rating-table rows with image_id = '<instance_id>/samples/<i>.png'
    (set instance_id per prompt when rows from several prompts are merged
    into one table). ``generator`` is consumed by the rating calls in
    question order."""
    if questions is None:
        if style in ("rule", "breakdown"):
            questions = geneval_prompt2questions(prompt) or [prompt]
        else:
            questions = [prompt]
    template = MMU_RATING_USER_PROMPT[style]
    user_prompts = [template.format(context=q) for q in questions]
    formatted = [QWEN_TEMPLATE.format(user_prompt=u).strip() for u in user_prompts]

    pixels_256 = torch.as_tensor(pixels_256, device=pipeline.device)
    n = pixels_256.shape[0]
    rows: List[Dict] = []
    if use_vision_tower:
        # resize once for all questions: to the fixed-resolution SigLIP tower's
        # size, or for a NaFlex tower the processor's aspect-preserving
        # patch-budget resize of the uint8 candidates (the lmms adapter's path;
        # equal 256 px inputs land on one size, so the batch stays rectangular)
        vcfg = pipeline.vision_cfg
        if isinstance(vcfg, Siglip2Config):
            px = np.stack([naflex_resize(img, vcfg.patch_size, vcfg.num_patches)
                           for img in pixels_to_uint8(pixels_256)])
        else:
            px = resize_bilinear(pixels_256, vcfg.image_size)
        # the reference conditions the w_und_encoder rating path on the Qwen
        # system prompt (inference_unigen_cot.py:343-353)
        sys_ids = np.asarray([pipeline.prompting._tokenize(QWEN_SYSTEM_PROMPT)[0]])
    for u, q in zip(user_prompts, formatted):
        if use_vision_tower:
            # understand() applies the chat template itself: pass the RAW
            # user prompt, or the rating question gets wrapped twice
            toks = pipeline.understand(px, [u] * n, generator, system_prompt_ids=sys_ids,
                                       max_new_tokens=max_new_tokens, temperature=0.0)
        else:
            # the discrete 'mmu' task consumes pre-templated strings; the
            # candidates are encoded again for each question, as in JAX
            toks = pipeline.understand_discrete(pixels_256, [q] * n, generator,
                                                max_new_tokens=max_new_tokens, temperature=0.0)
        texts = pipeline.decode_text(toks)
        for i, text in enumerate(texts):
            if style == "think":
                for (qq, ans) in parse_qa_pairs(text.strip()):
                    rows.append({"image_id": f"{instance_id}/samples/{i:05}.png",
                                 "prompt": prompt, "raw_answer": f"{qq} {ans}",
                                 "answer": ans})
            else:
                rows.append({"image_id": f"{instance_id}/samples/{i:05}.png",
                             "question": q, "raw_answer": text.strip(),
                             "answer": parse_yesno(text.strip())})
    return rows


def run_cot(
    pipeline: UniGenPipeline,
    prompts: Sequence[str],
    seed: int,
    *,
    n_samples: int = 20,
    topk: int = 4,
    guidance_scale: float = 6.0,
    timesteps: int = 50,
    eval_text_len: int = 128,
    style: str = "rule",
    use_vision_tower: bool = False,
    max_new_tokens: int = 128,
    questions_map: Optional[Dict[str, Sequence[str]]] = None,
    process_index: Optional[int] = None,
    process_count: Optional[int] = None,
    gather: bool = True,
):
    """The full Best-of-N loop, on the device from generation through rating.

    Prompts are sharded over processes (``shard_for_process``) and the rating
    tables are gathered from all of them before selection. Each prompt's
    generators are derived from ``(seed, global prompt index)``, so a
    sharded run samples and selects as the single-process run does.

    Returns (local_results, rating_table, stats): local_results holds this
    process's prompts, each with its uint8 candidates [n_samples, H, W, 3]
    and the selected ones [topk, H, W, 3]; rating_table and stats cover ALL
    prompts (the same on every process).

    ``questions_map`` supplies per-prompt rule-style questions (the DPG
    question file); GenEval prompts derive theirs by regex when absent."""
    indexed = shard_for_process(list(enumerate(prompts)), process_index, process_count)
    local_rows: List[Dict] = []
    local_pixels: Dict[int, np.ndarray] = {}
    for idx, prompt in indexed:
        pixels = pipeline.generate_images(
            [prompt] * n_samples, derived_generator(seed, idx, GEN_STREAM, device=pipeline.device),
            guidance_scale=guidance_scale, timesteps=timesteps, max_text_len=eval_text_len)
        # candidates kept on the host as uint8, what the PNG writers need; the
        # ratings are computed from the device tensor
        local_pixels[idx] = pixels_to_uint8(pixels)
        local_rows.extend(rate_candidates(
            pipeline, pixels, prompt,
            derived_generator(seed, idx, RATE_STREAM, device=pipeline.device), style=style,
            questions=(questions_map or {}).get(prompt), max_new_tokens=max_new_tokens,
            use_vision_tower=use_vision_tower, instance_id=f"{idx:05}"))

    if gather:
        rating_table = [r for sub in gather_objects(local_rows) for r in sub]
    else:
        rating_table = local_rows
    selected, stats = greedy_samples_byscore(rating_table, topk=topk)

    sel_by_instance: Dict[str, List[int]] = defaultdict(list)
    for s in selected:
        sel_by_instance[s.split("/")[0]].append(int(s.split("/")[-1].split(".")[0]))
    results = []
    for idx, prompt in indexed:
        sel_idx = sel_by_instance[f"{idx:05}"]
        results.append({"prompt": prompt, "index": idx,
                        "candidates": local_pixels[idx],
                        "selected": local_pixels[idx][sel_idx],
                        "stats": [s for s in stats if s["instance_id"] == f"{idx:05}"],
                        "ratings": [r for r in rating_table
                                    if r["image_id"].startswith(f"{idx:05}/")]})
    return results, rating_table, stats


def main(argv: Optional[Sequence[str]] = None):
    from ..launch import build_pipeline
    ap = argparse.ArgumentParser(description="CoT-V Best-of-N generation and self-rating "
                                             "with the port")
    ap.add_argument("--metadata-file", required=True)
    ap.add_argument("--question-file", default=None,
                    help="jsonl of {prompt or text, questions}: per-prompt rule questions")
    ap.add_argument("--output-dir", required=True)
    ap.add_argument("--n-samples", type=int, default=20)
    ap.add_argument("--topk", type=int, default=4)
    ap.add_argument("--style", choices=tuple(MMU_RATING_USER_PROMPT), default="rule")
    ap.add_argument("--guidance-scale", type=float, default=6.0)
    ap.add_argument("--steps", type=int, default=50, help="MaskGIT steps")
    ap.add_argument("--text-len", type=int, default=128)
    ap.add_argument("--max-new-tokens", type=int, default=128)
    ap.add_argument("--vision", action="store_true",
                    help="rate through the SigLIP tower (w_und_encoder), not the tokenizer")
    ap.add_argument("--seed", type=int, default=0, help="weights and sampling")
    ap.add_argument("--model", choices=("flagship", "tiny"), default="flagship")
    ap.add_argument("--quantization", choices=("int8", "int4"), default=None)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    pipe = build_pipeline(args.model, device=args.device, seed=args.seed, vision=args.vision,
                          quantization=args.quantization)
    metadata = load_metadata_jsonl(args.metadata_file)
    prompts = [m.get("prompt", m.get("text")) for m in metadata]
    questions_map = None
    if args.question_file:
        questions_map = {row.get("prompt", row.get("text")): row["questions"]
                         for row in load_metadata_jsonl(args.question_file)}
    results, rating_table, stats = run_cot(
        pipe, prompts, args.seed, n_samples=args.n_samples, topk=args.topk,
        guidance_scale=args.guidance_scale, timesteps=args.steps, eval_text_len=args.text_len,
        style=args.style, use_vision_tower=args.vision, max_new_tokens=args.max_new_tokens,
        questions_map=questions_map)
    out = args.output_dir
    all_dir = os.path.join(out, f"t2i_samples_step{args.steps}_scale{args.guidance_scale:g}")
    sel_dir = all_dir + f"_selected_prompt_{args.style}"
    for res in results:
        idx, md = res["index"], metadata[res["index"]]
        for base, imgs in ((all_dir, res["candidates"]), (sel_dir, res["selected"])):
            d = os.path.join(base, f"{idx:05}", "samples")
            os.makedirs(d, exist_ok=True)
            with open(os.path.join(base, f"{idx:05}", "metadata.jsonl"), "w") as f:
                json.dump(md, f)
            for i in range(imgs.shape[0]):
                save_png(imgs[i], os.path.join(d, f"{i:05}.png"))
    if process_index() == 0:
        for name, rows in (("rating_table", rating_table), ("rating_stats", stats)):
            with open(os.path.join(out, f"{name}_{args.style}.jsonl"), "w") as f:
                for row in rows:
                    f.write(json.dumps(row) + "\n")
    print(f"wrote {len(results)} prompts (all candidates + top-k selections) to "
          f"{args.output_dir}")
    return results, rating_table, stats


if __name__ == "__main__":
    main()
