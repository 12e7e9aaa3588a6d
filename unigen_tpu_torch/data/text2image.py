"""Text-to-image webdataset-style loader over tar shards, dependency-free.

The port's copy of ``unigen_tpu/data/text2image.py`` (the reference's
Text2ImageDataset pipeline, training/data_loader.py:46-358, without the
webdataset package): brace-expanded shard lists, sampling-with-replacement
shard streams, crash-proof tar iteration that skips bad samples (reference
group_by_keys_nothrow / tarfile_to_samples_nothrow, :113-146), caption
processing (json prompt fields, ``<person>`` substitution :97-103, prefix
stripping :170-184, short/long caption mixing by ``short_caption_ratio``
:325-345, captioning-prompt prepend :319-321), image transform, and
fixed-size batching. The same shards and seed give JAX's captions, skips
and samples: the ``random.Random(seed)`` calls come in JAX's order.

Images are decoded by ``data/decode.py`` (JPEG and PNG without PIL) and resized by
``data/transform.py``. A corrupt image is a skipped sample, as in JAX; an
image format the port does not decode (WebP, ...), or a native library that
cannot be built, raises (``decode.NOT_A_BAD_SAMPLE``).
``use_native=None`` (the default) builds and uses the native streamer
(``data/native.py``); ``use_native=False`` and ``pipe:`` URLs take the Python
reader. A shard list of which no file exists raises (JAX's stream would redraw
missing shards forever).
"""
from __future__ import annotations

import json
import os
import random
import re
import tarfile
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from .decode import NOT_A_BAD_SAMPLE, decode_image
from .transform import image_transform

CAPTION_PREFIXES = [
    # common caption boilerplate stripped by the reference (data_loader.py:170-184)
    "The image features ", "The image presents ", "The image depicts ",
    "The image showcases ", "The image shows ", "The image captures ",
    "The image displays ", "In the image, ", "In this image, ",
    "This image depicts ", "This image showcases ", "This image shows ",
    "This image captures ", "This image displays ", "This image features ",
    "This image presents ",
]

CAPTION_PROMPTS = [
    # prepended instruction pool when add_caption_prompt is on
    "Describe the image.",
    "Please describe the image in detail.",
    "What is shown in the image?",
    "Give a detailed description of the picture.",
]

IMG_EXTS = (".jpg", ".jpeg", ".png", ".webp")
TXT_EXTS = (".txt", ".text", ".caption")
JSON_EXTS = (".json",)


def brace_expand(pattern: str) -> List[str]:
    """'shard-{0000..0002}.tar' -> [shard-0000.tar, ...] (webdataset URL syntax)."""
    m = re.search(r"\{(\d+)\.\.(\d+)\}", pattern)
    if not m:
        return [pattern]
    lo, hi = m.group(1), m.group(2)
    width = len(lo)
    out = []
    for i in range(int(lo), int(hi) + 1):
        out.extend(brace_expand(pattern[:m.start()] + f"{i:0{width}d}" + pattern[m.end():]))
    return out


def _open_shard(path: str):
    """Local path or webdataset ``pipe:`` URL -> (tarfile, cleanup).

    ``pipe:<command>`` streams the command's stdout (the reference's gopen
    pipe handling, training/data_loader.py:65-94); everything else opens as
    a local tar."""
    if path.startswith("pipe:"):
        import subprocess
        proc = subprocess.Popen(path[5:], shell=True, stdout=subprocess.PIPE,
                                stderr=subprocess.DEVNULL)

        def cleanup():
            proc.stdout.close()
            proc.wait()

        return tarfile.open(fileobj=proc.stdout, mode="r|*"), cleanup
    tf = tarfile.open(path)
    return tf, tf.close


def iterate_tar_samples(path: str) -> Iterator[Dict]:
    """Group tar members by basename key; skip unreadable samples instead of
    raising (reference *_nothrow handlers, data_loader.py:113-146)."""
    try:
        tf, cleanup = _open_shard(path)
    except (OSError, tarfile.TarError):
        return
    current: Dict = {}
    current_key = None
    try:
        for member in tf:
            if not member.isfile():
                continue
            name = member.name
            dot = name.rfind(".")
            key, ext = (name[:dot], name[dot:].lower()) if dot >= 0 else (name, "")
            if key != current_key:
                if current_key is not None and current:
                    yield current
                current, current_key = {"__key__": key}, key
            try:
                current[ext] = tf.extractfile(member).read()
            except (OSError, tarfile.TarError):
                current = {}
                current_key = None
        if current_key is not None and current:
            yield current
    finally:
        cleanup()


@dataclass
class Text2ImageDataset:
    """Infinite resampled stream of (pixels [H,W,3] in ±1, caption str) batches."""

    shards: Sequence[str]
    per_device_batch_size: int
    resolution: int = 256
    short_caption_ratio: float = 0.5        # reference :325-345
    add_caption_prompt: bool = False        # reference :319-321 (mmu flow)
    external_captions: Optional[Dict[str, str]] = None
    person_substitution: str = "person"     # reference :97-103
    seed: int = 0
    num_batches: Optional[int] = None
    use_native: Optional[bool] = None       # None: build and use the C++ core

    def __post_init__(self):
        self._shards: List[str] = []
        for s in self.shards:
            self._shards.extend(brace_expand(s))
        if not self._shards:
            raise ValueError("no shards")
        if not any(s.startswith("pipe:") or os.path.exists(s) for s in self._shards):
            # JAX's stream would redraw missing shards forever
            raise FileNotFoundError(f"none of the shards exists: {self._shards[:3]}")
        self._rng = random.Random(self.seed)
        if any(s.startswith("pipe:") for s in self._shards):
            # the C++ core reads local files only; pipe: URLs take the python reader
            self.use_native = False
        if self.use_native is None:
            # JAX's "if built" is "build it" here: a failed build raises
            from .native import load_library
            load_library()
            self.use_native = True

    # -- caption processing (reference :97-184, :319-345) ---------------------

    def _extract_caption(self, sample: Dict) -> Optional[str]:
        short, long = None, None
        for ext in JSON_EXTS:
            if ext in sample:
                try:
                    meta = json.loads(sample[ext])
                except json.JSONDecodeError:
                    return None
                long = meta.get("prompt") or meta.get("caption") or meta.get("Task2") \
                    or meta.get("recaption")
                short = meta.get("short_caption") or meta.get("blip2_caption") \
                    or meta.get("Task1")
                if isinstance(long, dict):
                    long = long.get("Caption")
        for ext in TXT_EXTS:
            if ext in sample and long is None:
                long = sample[ext].decode("utf-8", "replace")
        if self.external_captions and sample["__key__"] in self.external_captions:
            long = self.external_captions[sample["__key__"]]
        if short and long:
            caption = short if self._rng.random() < self.short_caption_ratio else long
        else:
            caption = long or short
        if caption is None:
            return None
        caption = caption.replace("<person>", self.person_substitution)
        for prefix in CAPTION_PREFIXES:
            if caption.startswith(prefix):
                caption = caption[len(prefix):]
                if caption:
                    caption = caption[0].upper() + caption[1:]
                break
        if self.add_caption_prompt:
            caption = self._rng.choice(CAPTION_PROMPTS) + "\n" + caption
        return caption.strip()

    def _decode_image(self, sample: Dict) -> Optional[np.ndarray]:
        for ext in IMG_EXTS:
            if ext in sample:
                try:
                    return image_transform(decode_image(sample[ext]), self.resolution)
                except NOT_A_BAD_SAMPLE:
                    raise
                except Exception:
                    return None
        return None

    # -- stream ----------------------------------------------------------------

    def _sample_stream(self) -> Iterator[Dict]:
        if self.use_native:
            # C++ core: background-threaded tar reading + key grouping
            from .native import NativeTarStream
            stream = NativeTarStream(self._shards, seed=self.seed, resample=True)
            try:
                yield from stream
            finally:
                stream.close()
            return
        while True:  # resample shards with replacement (reference :213-216)
            shard = self._rng.choice(self._shards)
            yield from iterate_tar_samples(shard)

    def __iter__(self) -> Iterator[Dict]:
        images, texts = [], []
        produced = 0
        for sample in self._sample_stream():
            caption = self._extract_caption(sample)
            pixels = self._decode_image(sample)
            if caption is None or pixels is None:
                continue  # warn_and_continue semantics (reference :247-259)
            images.append(pixels)
            texts.append(caption)
            if len(images) == self.per_device_batch_size:
                yield {"images": np.stack(images), "input_ids": texts}
                images, texts = [], []
                produced += 1
                if self.num_batches is not None and produced >= self.num_batches:
                    return
