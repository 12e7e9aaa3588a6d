"""DPO data-construction flows: prompt -> visual questions -> pseudo-labels.

Reference: scripts/dataflows/zeroshot_question.py (an LLM converts each t2i prompt
into fine-grained yes/no visual questions via a few-shot instruction, :43-52) and
zeroshot_vqa.py (a VLM answers each (image, question) yes/no to build preference
pseudo-labels). The reference drives vLLM; here the generation backend is
pluggable: the caller passes the functions that answer (the port's pipeline,
``generate_text`` for question synthesis and ``understand`` for VQA, or any
other). The port's copy of ``unigen_tpu/data/dataflows.py``, string work only.
"""
from __future__ import annotations

import re
from typing import Callable, Dict, List, Sequence

QUESTION_FEWSHOT = (
    "Now you need to convert an image description into fine-grained, related "
    "visual questions. The questions should comprehensively cover detailed visual "
    "facts of entities, attributes (e.g., color, count, texture, shape, and size), "
    "and relationships (e.g., spatial and non-spatial) between the entities "
    "mentioned in the description. Make sure all questions are able to be "
    "responded with yes or no and are connected with semicolon.\n"
    "Example: three black keys, four chickens and a fabric blanket.\n"
    "output: Are there keys?; Are there three keys?; Are the keys black?; "
    "Are there chickens?; Are there four chickens?; Is there a blanket?; "
    "Is the blanket fabric?\n"
)

_CAPTION_PREFIX_RE = re.compile(
    r"^(the image (portrays|depicts|shows|displays|captures|appears to be) |"
    r"in (the|this) image,? (we see )?|this is |this image (captures|displays:?|shows) )",
    re.IGNORECASE)


def remove_caption_prefix(caption: str) -> str:
    """Strip caption boilerplate before question synthesis (reference :23-35)."""
    prev = None
    while prev != caption:
        prev = caption
        caption = _CAPTION_PREFIX_RE.sub("", caption).lstrip()
    return caption


def question_prompt(t2i_prompt: str) -> str:
    """ChatML question-synthesis prompt (reference CustomDataset, :41-56)."""
    return ("<|im_start|>system\nYou are a helpful assistant.<|im_end|>\n"
            "<|im_start|>user\n" + QUESTION_FEWSHOT +
            f"Please convert this image description: {remove_caption_prefix(t2i_prompt)} "
            "into fine-grained related visual questions.\n<|im_end|>\n"
            "<|im_start|>assistant\n")


def parse_questions(text: str) -> List[str]:
    """Split a semicolon-joined question list; keep only well-formed questions."""
    out = []
    for q in text.split(";"):
        q = q.strip().strip(".")
        if not q:
            continue
        if not q.endswith("?"):
            q += "?"
        if len(q) > 3:
            out.append(q)
    return out


def vqa_prompt(question: str) -> str:
    """Yes/no VQA prompt for pseudo-labeling (reference zeroshot_vqa.py)."""
    return f"{question} Please answer yes or no."


def build_question_table(prompts: Sequence[Dict], generate: Callable[[str], str]
                         ) -> List[Dict]:
    """prompts: [{'id': ..., 'prompt': ...}]; generate: prompt -> LLM text.
    Returns [{'item_id', 'prompt', 'questions'}] like the DPG question file the
    rater consumes (reference inference_unigen_cot.py:297-304)."""
    out = []
    for item in prompts:
        text = generate(question_prompt(item["prompt"]))
        out.append({"item_id": item.get("id", item.get("item_id")),
                    "prompt": item["prompt"],
                    "questions": parse_questions(text)})
    return out


def pseudo_label_images(images, questions_per_image: Sequence[Sequence[str]],
                        answer: Callable[[object, str], str]) -> List[List[Dict]]:
    """answer: (image, question) -> raw text. Returns per-image yes/no rows used
    to assemble chosen/rejected DPO pairs."""
    from ..evaluation.cot import parse_yesno
    tables = []
    for img, questions in zip(images, questions_per_image):
        rows = []
        for q in questions:
            raw = answer(img, vqa_prompt(q))
            rows.append({"question": q, "raw_answer": raw,
                         "answer": parse_yesno(raw)})
        tables.append(rows)
    return tables


def select_preference_pairs(candidates: List[Dict], threshold: float = 1.0
                            ) -> List[Dict]:
    """Turn scored candidates [{'image': ..., 'score': ...}] per prompt into a
    (chosen, rejected) pair: best vs worst when they differ."""
    ranked = sorted(candidates, key=lambda c: -c["score"])
    if len(ranked) < 2 or ranked[0]["score"] <= ranked[-1]["score"]:
        return []
    return [{"chosen": ranked[0]["image"], "rejected": ranked[-1]["image"],
             "chosen_score": ranked[0]["score"], "rejected_score": ranked[-1]["score"]}]
