"""The JPEG fixtures of the port's tests and ``chip_smoke.py``'s ``jpeg`` phase.

``unigen_tpu_torch/data/assets/jpeg/`` holds JPEGs written once with PIL from
seed 0 (smooth synthetic images with mild noise, at the sizes and settings
of web caption shards, COCO / LLaVA folders, ImageNet and a few coverage
cases) and ``fixtures.json``: each file's shape and the sha256 of PIL's
``Image.open(f).convert("RGB")`` pixels (``null`` for the truncated file,
on which PIL raises). The card's machine has no PIL: the phase holds the
port's decoder to these hashes. Rewrite them (PIL needed) with

    python tests/torch_jpeg_fixtures.py
"""
import hashlib
import io
import json
import os

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE_DIR = os.path.join(REPO, "unigen_tpu_torch", "data", "assets", "jpeg")

# name: (height, width, PIL mode, save options, what it stands for)
FIXTURES = {
    "web_512x512_420_q90.jpg": (512, 512, "RGB", dict(quality=90, subsampling=2), "web t2i"),
    "web_768x512_420_q85_progressive.jpg": (512, 768, "RGB", dict(
        quality=85, subsampling=2, progressive=True), "web t2i"),
    "web_1024x768_420_q90.jpg": (768, 1024, "RGB", dict(quality=90, subsampling=2), "web t2i"),
    "coco_640x480_420_q85.jpg": (480, 640, "RGB", dict(quality=85, subsampling=2), "COCO / LLaVA"),
    "coco_640x427_grey.jpg": (427, 640, "L", dict(quality=85), "COCO / LLaVA"),
    "imagenet_500x375_420_q75.jpg": (375, 500, "RGB", dict(quality=75, subsampling=2), "ImageNet"),
    "imagenet_500x375_cmyk.jpg": (375, 500, "CMYK", dict(quality=75), "ImageNet"),
    "cov_256x256_444_q95_restart.jpg": (256, 256, "RGB", dict(
        quality=95, subsampling=0, restart_marker_blocks=4), "coverage"),
    "cov_320x240_422_optimized.jpg": (240, 320, "RGB", dict(
        quality=85, subsampling=1, optimize=True), "coverage"),
    "cov_17x9.jpg": (9, 17, "RGB", dict(quality=90), "coverage"),
    "cov_1x1.jpg": (1, 1, "RGB", dict(quality=90), "coverage"),
    # tables past 255: 16-bit DQT, written as SOF1 (extended sequential)
    "cov_96x64_16bit_tables.jpg": (64, 96, "RGB", dict(
        qtables=[[16] * 6 + [300] * 58, [24] * 3 + [700] * 61]), "coverage"),
}
TRUNCATED = "cov_640x480_truncated.jpg"     # coco_640x480_420_q85.jpg cut at 60%


def synthetic(h, w, seed):
    """A smooth uint8 [h, w, 3] image: colour ramps, a soft wave, noise of a
    few levels (a photo's statistics more than a PNG test pattern's)."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    base = rng.uniform(40, 215, size=3)
    fx, fy = rng.uniform(-0.15, 0.15, size=(2, 3)) * 256 / max(h, w, 1)
    period = rng.uniform(30, 90)
    img = (base + fx * x[..., None] + fy * y[..., None]
           + 25 * np.sin((x + 0.7 * y)[..., None] / period + rng.uniform(0, 6, size=3))
           + rng.normal(0, 6.0, size=(h, w, 3)))
    return np.clip(img, 0, 255).astype(np.uint8)


def pixel_sha256(arr) -> str:
    return hashlib.sha256(np.ascontiguousarray(arr, np.uint8).tobytes()).hexdigest()


def write_fixtures(directory=FIXTURE_DIR):
    from PIL import Image
    os.makedirs(directory, exist_ok=True)
    index = {}
    for seed, (name, (h, w, mode, opts, use)) in enumerate(sorted(FIXTURES.items())):
        img = Image.fromarray(synthetic(h, w, seed))
        if mode == "L":
            img = img.convert("L")
        elif mode == "CMYK":
            img = img.convert("CMYK")
        buf = io.BytesIO()
        img.save(buf, format="JPEG", **opts)
        data = buf.getvalue()
        with open(os.path.join(directory, name), "wb") as f:
            f.write(data)
        rgb = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
        index[name] = {"shape": list(rgb.shape), "sha256": pixel_sha256(rgb), "mode": mode,
                       "options": {k: v for k, v in opts.items() if k != "qtables"},
                       "use": use, "bytes": len(data)}
    with open(os.path.join(directory, "coco_640x480_420_q85.jpg"), "rb") as f:
        data = f.read()
    cut = data[:int(len(data) * 0.6)]
    with open(os.path.join(directory, TRUNCATED), "wb") as f:
        f.write(cut)
    index[TRUNCATED] = {"shape": [480, 640, 3], "sha256": None, "mode": "RGB", "options": {},
                        "use": "coverage: PIL raises 'image file is truncated'",
                        "bytes": len(cut)}
    with open(os.path.join(directory, "fixtures.json"), "w") as f:
        json.dump(index, f, indent=1, sort_keys=True)
        f.write("\n")
    return index


if __name__ == "__main__":
    idx = write_fixtures()
    print(f"{len(idx)} fixtures, {sum(v['bytes'] for v in idx.values())} bytes in {FIXTURE_DIR}")
