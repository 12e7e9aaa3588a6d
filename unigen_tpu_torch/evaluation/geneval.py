"""GenEval-protocol text-to-image generation: prompts -> PNG samples.

Port of ``unigen_tpu/evaluation/geneval.py`` and the counterpart of
``scripts/inference_geneval.py``. For each metadata line it generates
``n_samples`` images (guidance 6, 50 steps, 256 px, text budget 128 by
default) and writes ``<outdir>/<idx:05d>/samples/<i:05d>.png`` and
``<outdir>/<idx:05d>/metadata.jsonl``. Prompts are sharded over the
processes of ``torch.distributed`` when it is initialised. PNGs are written
with ``zlib`` and ``struct`` (8-bit RGB, filter 0), with no imaging library.

Run as a module (random weights from ``--seed`` until checkpoints exist)::

    python -m unigen_tpu_torch.evaluation.geneval --metadata-file prompts.jsonl \\
        --output-dir out --n-samples 4 --guidance-scale 6 --steps 50 --mode mask
"""
from __future__ import annotations

import argparse
import json
import os
import struct
import zlib
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..pipeline import UniGenPipeline, pixels_to_uint8

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def png_bytes(img: np.ndarray) -> bytes:
    """An 8-bit RGB image [H, W, 3] uint8 as PNG bytes (every row filter 0)."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected uint8 [H, W, 3], got {img.dtype} {img.shape}")
    h, w, _ = img.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * 3)], axis=1)
    return (_PNG_SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))


def save_png(img: np.ndarray, path: str) -> None:
    with open(path, "wb") as f:
        f.write(png_bytes(img))


def load_png(path: str) -> np.ndarray:
    """Reads back what ``save_png`` writes (8-bit RGB, not interlaced, every
    row filter 0) as uint8 [H, W, 3]; raises on any other PNG."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_PNG_SIGNATURE):
        raise ValueError(f"{path}: not a PNG")
    pos, idat, header = len(_PNG_SIGNATURE), [], None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
    if header is None or header[2:] != (8, 2, 0, 0, 0):
        raise ValueError(f"{path}: not an 8-bit RGB PNG without interlace ({header})")
    w, h = header[:2]
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, 1 + 3 * w)
    if rows[:, 0].any():
        raise ValueError(f"{path}: rows with a filter other than 0")
    return rows[:, 1:].reshape(h, w, 3).copy()


def shard_for_process(items: Sequence, process_index: Optional[int] = None,
                      process_count: Optional[int] = None) -> List:
    """Every ``process_count``-th item from ``process_index``: the rank and
    world size of ``torch.distributed`` when it is initialised, else 0 of 1."""
    dist = torch.distributed.is_available() and torch.distributed.is_initialized()
    if process_index is None:
        process_index = torch.distributed.get_rank() if dist else 0
    if process_count is None:
        process_count = torch.distributed.get_world_size() if dist else 1
    return list(items)[process_index::process_count]


def _fetch_async(pixels: torch.Tensor):
    """Starts the copy of a batch of pixels to pinned host memory and
    returns (host tensor, event that marks its arrival). The copy is queued
    behind the batch's own work only, so waiting on the event does not wait
    for work queued after it. A CPU tensor is returned as it is, with no
    event."""
    if pixels.device.type != "cuda":
        return pixels, None
    host = torch.empty(pixels.shape, dtype=torch.float32, pin_memory=True)
    host.copy_(pixels.float(), non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return host, event


def run_geneval(
    pipeline: UniGenPipeline,
    metadata: List[Dict],
    output_dir: str,
    generator: Optional[torch.Generator],
    *,
    n_samples: int = 4,
    guidance_scale: float = 6.0,
    timesteps: int = 50,
    temperature: float = 1.0,
    eval_text_len: int = 128,
    mode: str = "mask",
    process_index: Optional[int] = None,
    process_count: Optional[int] = None,
) -> List[str]:
    """Writes this process's shard of ``metadata`` and returns its prompt
    directories. One-deep pipelined: prompt i + 1 is enqueued on the device
    before prompt i's pixels are waited for and written, so the PNG writes
    overlap the next prompt's sampling; prompt i's copy to the host is
    queued right behind its own work and waited for by its event, not by a
    synchronisation of the stream. ``generator`` is consumed in prompt
    order, one ``generate_images`` call a prompt."""
    written = []

    def flush(idx, md, fetched):
        pixels, event = fetched
        if event is not None:
            event.synchronize()                 # prompt idx's pixels only
        imgs = pixels_to_uint8(pixels)
        outpath = os.path.join(output_dir, f"{idx:0>5}")
        sample_dir = os.path.join(outpath, "samples")
        os.makedirs(sample_dir, exist_ok=True)
        with open(os.path.join(outpath, "metadata.jsonl"), "w") as f:
            json.dump(md, f)
        for i in range(n_samples):
            save_png(imgs[i], os.path.join(sample_dir, f"{i:05}.png"))
        written.append(outpath)

    pending = None
    for idx, md in shard_for_process(list(enumerate(metadata)), process_index, process_count):
        pixels = pipeline.generate_images(
            [md.get("prompt", md.get("text"))] * n_samples, generator,
            guidance_scale=guidance_scale, timesteps=timesteps, temperature=temperature,
            max_text_len=eval_text_len, mode=mode)
        fetched = _fetch_async(pixels)
        if pending is not None:
            flush(*pending)
        pending = (idx, md, fetched)
    if pending is not None:
        flush(*pending)
    return written


def load_metadata_jsonl(path: str) -> List[Dict]:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def main(argv: Optional[Sequence[str]] = None) -> List[str]:
    from ..launch import build_pipeline
    ap = argparse.ArgumentParser(description="GenEval image generation with the port")
    ap.add_argument("--metadata-file", required=True)
    ap.add_argument("--output-dir", required=True)
    ap.add_argument("--n-samples", type=int, default=4)
    ap.add_argument("--guidance-scale", type=float, default=6.0)
    ap.add_argument("--steps", type=int, default=50, help="MaskGIT steps (mode mask)")
    ap.add_argument("--text-len", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0, help="weights and sampling")
    ap.add_argument("--mode", choices=("mask", "ar"), default="mask")
    ap.add_argument("--model", choices=("flagship", "tiny"), default="flagship")
    ap.add_argument("--quantization", choices=("int8", "int4"), default=None)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    pipe = build_pipeline(args.model, device=args.device, seed=args.seed,
                          quantization=args.quantization)
    gen = torch.Generator(device=pipe.device)
    gen.manual_seed(args.seed)
    written = run_geneval(pipe, load_metadata_jsonl(args.metadata_file), args.output_dir, gen,
                          n_samples=args.n_samples, guidance_scale=args.guidance_scale,
                          timesteps=args.steps, eval_text_len=args.text_len, mode=args.mode)
    print(f"wrote {len(written)} prompt dirs to {args.output_dir}")
    return written


if __name__ == "__main__":
    main()
