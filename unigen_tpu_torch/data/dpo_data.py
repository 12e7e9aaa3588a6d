"""DPO preference-pair dataset: (prompt, chosen image, rejected image).

The port's copy of ``unigen_tpu/data/dpo_data.py`` (the reference's
training/train_dpo.py:109-185): json/jsonl entries with image paths, a
per-file sampling strategy (first/end/random with counts or percentages),
±1-normalized 256px transforms, collated to a prompt list and image stacks.
The same files and seed give JAX's items, order and batches. Images are
read by ``data/decode.py``: a pair with an unreadable image is skipped, as
in JAX; an image format the port does not decode (WebP, GIF, ...), or a native
library that cannot be built, raises (``decode.NOT_A_BAD_SAMPLE``).
"""
from __future__ import annotations

import json
import math
import os
import random
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from .decode import NOT_A_BAD_SAMPLE, read_image
from .transform import image_transform


def load_json_or_jsonl(path: str) -> List[Dict]:
    with open(path) as f:
        if "jsonl" in path:
            return [json.loads(l) for l in f if l.strip()]
        return json.load(f)


def apply_sampling(items: List[Dict], strategy: str, number: str,
                   rng: random.Random) -> List[Dict]:
    """'first'/'end'/'random' with count or 'NN%' (reference :128-143)."""
    if "%" in str(number):
        n = math.ceil(int(str(number).split("%")[0]) * len(items) / 100)
    else:
        n = int(number)
    if strategy == "first":
        return items[:n]
    if strategy == "end":
        return items[-n:]
    if strategy == "random":
        items = list(items)
        rng.shuffle(items)
        return items[:n]
    return items  # 'all'


@dataclass
class DPODataset:
    data_paths: Sequence[str]
    image_root: str
    per_device_batch_size: int
    resolution: int = 256
    sampling_strategy: str = "all"
    sampling_number: Optional[Sequence[str]] = None
    seed: int = 0
    shuffle: bool = True

    def __post_init__(self):
        rng = random.Random(self.seed)
        numbers = self.sampling_number or ["100%"] * len(self.data_paths)
        if len(numbers) != len(self.data_paths):
            raise ValueError(f"{len(numbers)} sampling numbers for {len(self.data_paths)} files")
        self.items: List[Dict] = []
        for path, number in zip(self.data_paths, numbers):
            cur = load_json_or_jsonl(path)
            if self.sampling_strategy != "all":
                cur = apply_sampling(cur, self.sampling_strategy, number, rng)
            self.items.extend(cur)
        self._rng = rng

    def __len__(self):
        return len(self.items)

    def _load(self, rel: str) -> np.ndarray:
        return image_transform(read_image(os.path.join(self.image_root, rel)), self.resolution)

    def __iter__(self) -> Iterator[Dict]:
        """Epoch iterator of collated batches (reference DPODataCollator :173-185)."""
        order = list(range(len(self.items)))
        if self.shuffle:
            self._rng.shuffle(order)
        batch: List[Dict] = []
        for idx in order:
            item = self.items[idx]
            try:
                chosen = self._load(item["chosen"])
                rejected = self._load(item["rejected"])
            except NOT_A_BAD_SAMPLE:
                raise
            except Exception:
                continue
            batch.append({"prompt": item["prompt"], "chosen": chosen,
                          "rejected": rejected})
            if len(batch) == self.per_device_batch_size:
                yield {
                    "batch_prompt_list": [b["prompt"] for b in batch],
                    "batch_chosen_image": np.stack([b["chosen"] for b in batch]),
                    "batch_rejected_image": np.stack([b["rejected"] for b in batch]),
                }
                batch = []
