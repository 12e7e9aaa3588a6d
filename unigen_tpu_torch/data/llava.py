"""LLaVA-style instruction data: ChatML preprocessing and batch collation.

Port of the host functions of ``unigen_tpu/data/llava.py`` (lines 28-131),
numpy only, kept as a copy of their own (the port imports nothing of the
JAX package):

* ``preprocess_qwen``: ChatML per-turn tokenization, labels masked on the
  user and system turns (the system message is not repeated per turn);
* ``preprocess_plain``: the caption-pretraining form, one ``<caption><sep>``
  a conversation with the emptied user turn masked;
* ``preprocess``: the prompt-type dispatch;
* ``collate_batch``: ids and labels padded to ``max_length``, images stacked
  (NaFlex samples with their patch masks and spatial shapes), the optional
  system-prompt stream.

Not ported yet: ``LlavaDataset`` (JSON files and an image folder, PIL
decoding), with the other loaders (ROADMAP Queue 1 item 12).
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

IGNORE_INDEX = -100
DEFAULT_IMAGE_TOKEN = "<image>"
SYSTEM_MESSAGE = "You are a helpful assistant."


def _chatml_turn(role: str, content: str) -> str:
    return f"<|im_start|>{role}\n{content}<|im_end|>\n"


def preprocess_qwen(sources: Sequence[Sequence[Dict]], tokenizer,
                    system_message: str = SYSTEM_MESSAGE) -> Dict[str, List]:
    """Per-turn ChatML tokenization with assistant-only labels; a leading
    assistant turn is skipped. Returns ragged lists: input_ids, labels,
    input_ids_system."""
    roles = {"human": "user", "gpt": "assistant"}
    input_ids, targets, input_ids_system = [], [], []
    for source in sources:
        first_role = source[0].get("from", source[0].get("role"))
        if roles.get(first_role, first_role) != "user":
            source = source[1:]
        ids: List[int] = []
        labs: List[int] = []
        input_ids_system.append(tokenizer(_chatml_turn("system", system_message))["input_ids"])
        for turn in source:
            role = turn.get("role", turn.get("from"))
            content = turn.get("content", turn.get("value", ""))
            content = content.replace(DEFAULT_IMAGE_TOKEN, "").strip()
            role = roles.get(role, role)
            enc = tokenizer(_chatml_turn(role, content))["input_ids"]
            ids.extend(enc)
            labs.extend([IGNORE_INDEX] * len(enc) if role in ("user", "system") else enc)
        input_ids.append(ids)
        targets.append(labs)
    return {"input_ids": input_ids, "labels": targets, "input_ids_system": input_ids_system}


def preprocess_plain(sources: Sequence[Sequence[Dict]], tokenizer,
                     sep: str = "\n") -> Dict[str, List]:
    """Caption pretraining: each (user, caption) pair becomes the caption,
    ``sep`` and eos, the (blanked) user turn's tokens label-masked."""
    input_ids, targets = [], []
    for source in sources:
        if len(source) != 2:
            raise ValueError("plain conversations are (user, caption) pairs")
        user = ""
        caption = source[1].get("content", source[1].get("value", ""))
        caption = caption.replace(DEFAULT_IMAGE_TOKEN, "").strip()
        ids = tokenizer(user + caption + sep)["input_ids"] + [tokenizer.eos_token_id]
        labs = list(ids)
        prefix = len(tokenizer(user)["input_ids"])
        labs[:prefix] = [IGNORE_INDEX] * prefix
        input_ids.append(ids)
        targets.append(labs)
    return {"input_ids": input_ids, "labels": targets,
            "input_ids_system": [[] for _ in sources]}


def preprocess(sources, tokenizer, prompt_type: str = "qwen",
               system_message: str = SYSTEM_MESSAGE) -> Dict[str, List]:
    """``preprocess_qwen`` for a ``qwen*`` prompt type, ``preprocess_plain``
    for ``plain``."""
    if "qwen" in prompt_type:
        return preprocess_qwen(sources, tokenizer, system_message)
    if prompt_type == "plain":
        return preprocess_plain(sources, tokenizer)
    raise ValueError(f"unknown prompt_type: {prompt_type}")


def collate_batch(samples: List[Dict], pad_id: int, max_length: int,
                  with_system: bool = False) -> Dict[str, np.ndarray]:
    """ids / labels padded (or cut) to ``max_length`` with ``pad_id`` /
    ``IGNORE_INDEX``, images stacked; NaFlex samples (dict images, from
    ``data.transform.naflex_preprocess``) also stack ``pixel_attention_mask``
    and ``spatial_shapes``; with ``with_system`` the system-prompt ids padded
    to the longest."""
    b = len(samples)
    ids = np.full((b, max_length), pad_id, np.int64)
    labels = np.full((b, max_length), IGNORE_INDEX, np.int64)
    for i, s in enumerate(samples):
        seq = s["input_ids"][:max_length]
        ids[i, :len(seq)] = seq
        lab = s["labels"][:max_length]
        labels[i, :len(lab)] = lab
    out = {"input_ids": ids, "labels": labels}
    if isinstance(samples[0]["image"], dict):       # NaFlex patchified images
        out["images"] = np.stack([s["image"]["pixel_values"] for s in samples])
        out["pixel_attention_mask"] = np.stack(
            [s["image"]["pixel_attention_mask"] for s in samples])
        out["spatial_shapes"] = np.stack([s["image"]["spatial_shapes"] for s in samples])
    else:
        out["images"] = np.stack([s["image"] for s in samples])
    if with_system:
        sys_len = max(len(s["input_ids_system"]) for s in samples)
        sys_ids = np.full((b, sys_len), pad_id, np.int64)
        for i, s in enumerate(samples):
            sys_ids[i, :len(s["input_ids_system"])] = s["input_ids_system"]
        out["input_ids_system"] = sys_ids
    return out
