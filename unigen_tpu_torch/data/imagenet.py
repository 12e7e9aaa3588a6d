"""ImageNet as class-conditional text-to-image data.

The port's copy of ``unigen_tpu/data/imagenet.py`` (the reference's
data/imagenet_dataset.py:1024-1083): an ImageFolder whose caption is a
random synonym of the synset's text label (the wnid -> "syn1, syn2"
mapping), with an optional prefix prompt. The standard ILSVRC-2012 mapping
ships as the package's own copy of the data asset
(``assets/imagenet2012_synsets.txt``) and is the default; a custom mapping
file can be supplied for non-standard label sets. Images are read by
``data/decode.py``: an unreadable file is skipped forward, as in JAX; an
image format the port does not decode (WebP, BMP, ...), or a native library that
cannot be built, raises (``decode.NOT_A_BAD_SAMPLE``).
"""
from __future__ import annotations

import os
import random
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional

import numpy as np

from .decode import NOT_A_BAD_SAMPLE, read_image
from .transform import image_transform

IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".ppm", ".bmp", ".pgm", ".tif",
                  ".tiff", ".webp")


DEFAULT_SYNSET_FILE = os.path.join(os.path.dirname(__file__), "assets",
                                   "imagenet2012_synsets.txt")


def load_synset_mapping(path: Optional[str] = None) -> Dict[str, str]:
    """'n01440764: tench, Tinca tinca' lines -> {wnid: 'tench, Tinca tinca'}.

    With no ``path``, loads the ILSVRC-2012 table (1000 classes)."""
    mapping = {}
    with open(path or DEFAULT_SYNSET_FILE) as f:
        for line in f:
            if ":" in line and not line.startswith("#"):
                wnid, _, names = line.partition(":")
                mapping[wnid.strip()] = names.strip()
    return mapping


@dataclass
class ImageNetDataset:
    root: str                                  # ImageFolder layout: root/<wnid>/xxx.JPEG
    per_device_batch_size: int
    synset_mapping: Optional[Dict[str, str]] = None  # default: the ILSVRC-2012 table
    image_size: int = 256
    prefix_prompt: Optional[str] = None
    seed: int = 0

    def __post_init__(self):
        if self.synset_mapping is None:
            self.synset_mapping = load_synset_mapping()
        self.samples: List[tuple] = []
        for wnid in sorted(os.listdir(self.root)):
            d = os.path.join(self.root, wnid)
            if not os.path.isdir(d):
                continue
            for fn in sorted(os.listdir(d)):
                if fn.lower().endswith(IMG_EXTENSIONS):
                    self.samples.append((os.path.join(d, fn), wnid))
        if not self.samples:
            raise ValueError(f"no images under {self.root}")
        self._rng = random.Random(self.seed)

    def __len__(self):
        return len(self.samples)

    def get(self, idx: int) -> Dict:
        """Single sample; bad files skip forward (reference :1057-1070)."""
        for offset in range(len(self.samples)):
            path, wnid = self.samples[(idx + offset) % len(self.samples)]
            try:
                image = image_transform(read_image(path), self.image_size)
            except NOT_A_BAD_SAMPLE:
                raise
            except Exception:
                continue
            names = self.synset_mapping.get(wnid, wnid)
            caption = self._rng.choice(names.split(",")).strip()
            if self.prefix_prompt is not None:
                caption = self.prefix_prompt + caption
            return {"images": image, "input_ids": caption}
        raise RuntimeError("no decodable images")

    def __iter__(self) -> Iterator[Dict]:
        order = list(range(len(self.samples)))
        while True:
            self._rng.shuffle(order)
            batch: List[Dict] = []
            for idx in order:
                batch.append(self.get(idx))
                if len(batch) == self.per_device_batch_size:
                    yield {"images": np.stack([b["images"] for b in batch]),
                           "input_ids": [b["input_ids"] for b in batch]}
                    batch = []
