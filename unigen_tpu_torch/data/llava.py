"""LLaVA-style instruction data: JSON conversations + images.

The port's copy of ``unigen_tpu/data/llava.py``, numpy only (the port
imports nothing of the JAX package):

* ``preprocess_qwen``: ChatML per-turn tokenization, labels masked on the
  user and system turns (the system message is not repeated per turn);
* ``preprocess_plain``: the caption-pretraining form, one ``<caption><sep>``
  a conversation with the emptied user turn masked;
* ``preprocess``: the prompt-type dispatch;
* ``collate_batch``: ids and labels padded to ``max_length``, images stacked
  (NaFlex samples with their patch masks and spatial shapes), the optional
  system-prompt stream;
* ``LlavaDataset``: conversations + images -> collated batches, the files
  mixed by per-file weights; the images read by ``data/decode.py`` (JPEG
  and PNG without PIL) in the ``vq`` (±1 pixels), ``siglip`` (384 px) or ``naflex``
  (patches) mode; ``siglip_image_size`` (384, JAX's fixed size, by
  default) lets a tower of another size take the ``siglip`` mode. An
  unreadable image becomes the zero image, as in JAX;
  an image format the port does not decode (WebP, GIF, ...), or a native library
  that cannot be built, raises (``decode.NOT_A_BAD_SAMPLE``). The same files and
  seed give JAX's samples: the ``random.Random(seed)`` calls come in JAX's
  order.
"""
from __future__ import annotations

import json
import os
import random
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from .decode import NOT_A_BAD_SAMPLE, read_image
from .transform import image_transform, naflex_preprocess, siglip_preprocess

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


@dataclass
class LlavaDataset:
    """JSON conversation files + image folder -> infinite batch stream."""

    data_paths: Sequence[str]            # json/jsonl files
    image_root: str
    tokenizer: object
    per_device_batch_size: int
    max_length: int = 512
    resolution: int = 256
    visual_mode: str = "vq"              # 'vq' (±1 px) | 'siglip' (384px) | 'naflex'
    prompt_type: str = "qwen"            # 'qwen' (ChatML) | 'plain' (caption pretrain)
    sampling_ratios: Optional[Sequence[float]] = None  # per-file mixing weights
    system_message: str = SYSTEM_MESSAGE
    with_system: bool = False
    naflex_patch_size: int = 16
    naflex_max_patches: int = 256
    seed: int = 0
    siglip_image_size: int = 384         # JAX's is always 384 (the flagship tower's)

    def __post_init__(self):
        self._datasets: List[List[Dict]] = []
        for path in self.data_paths:
            with open(path) as f:
                if path.endswith(".jsonl"):
                    items = [json.loads(l) for l in f if l.strip()]
                else:
                    items = json.load(f)
            self._datasets.append(items)
        self._rng = random.Random(self.seed)
        if self.sampling_ratios is None:
            total = sum(len(d) for d in self._datasets)
            self.sampling_ratios = [len(d) / total for d in self._datasets]

    def _load_image(self, item: Dict):
        path = os.path.join(self.image_root, item.get("image", ""))
        try:
            img = read_image(path)
            if self.visual_mode == "naflex":
                return naflex_preprocess(img, self.naflex_patch_size, self.naflex_max_patches)
            if self.visual_mode == "siglip":
                return siglip_preprocess(img, self.siglip_image_size)
            return image_transform(img, self.resolution)
        except NOT_A_BAD_SAMPLE:
            raise
        except Exception:
            # the dummy-image fallback (reference :258-261)
            if self.visual_mode == "naflex":
                side = int(self.naflex_max_patches ** 0.5) * self.naflex_patch_size
                return naflex_preprocess(np.zeros((side, side, 3), np.uint8),
                                         self.naflex_patch_size, self.naflex_max_patches)
            size = self.siglip_image_size if self.visual_mode == "siglip" else self.resolution
            return np.zeros((size, size, 3), np.float32)

    def _sample(self) -> Dict:
        ds = self._rng.choices(self._datasets, weights=self.sampling_ratios)[0]
        item = self._rng.choice(ds)
        proc = preprocess([item["conversations"]], self.tokenizer,
                          self.prompt_type, self.system_message)
        return {"input_ids": proc["input_ids"][0], "labels": proc["labels"][0],
                "input_ids_system": proc["input_ids_system"][0],
                "image": self._load_image(item)}

    def __iter__(self) -> Iterator[Dict]:
        while True:
            samples = [self._sample() for _ in range(self.per_device_batch_size)]
            yield collate_batch(samples, self.tokenizer.pad_token_id,
                                self.max_length, self.with_system)
