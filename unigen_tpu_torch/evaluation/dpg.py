"""DPG-bench text-to-image entry point: one 2x2 grid PNG per prompt.

Port of ``unigen_tpu/evaluation/dpg.py`` and the counterpart of
``scripts/inference_dpg.py`` and ``scripts/prepare_dpg_metadata.py``:
guidance 6, 50 steps, 4 samples and a text budget of 256 by default; each
prompt's samples become one ``<item_id>.png`` grid.

Run as a module (random weights from ``--seed`` until checkpoints exist)::

    python -m unigen_tpu_torch.evaluation.dpg prepare <prompts_dir_or_csv> dpg.jsonl \\
        [questions.jsonl]
    python -m unigen_tpu_torch.evaluation.dpg generate --prompts-file dpg.jsonl \\
        --output-dir out
"""
from __future__ import annotations

import argparse
import csv
import json
import os
from collections import defaultdict
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..device import fetch_async
from ..pipeline import UniGenPipeline, pixels_to_uint8
from .geneval import save_png, shard_for_process


def make_grid_2x2(imgs: np.ndarray) -> np.ndarray:
    """[4, H, W, 3] uint8 -> [2H, 2W, 3] grid (the reference's make_grid)."""
    top = np.concatenate([imgs[0], imgs[1]], axis=1)
    bottom = np.concatenate([imgs[2], imgs[3]], axis=1)
    return np.concatenate([top, bottom], axis=0)


def run_dpg(
    pipeline: UniGenPipeline,
    prompts: List[Dict],       # [{"item_id": ..., "text": ...}]
    output_dir: str,
    generator: Optional[torch.Generator],
    *,
    n_samples: int = 4,
    guidance_scale: float = 6.0,
    timesteps: int = 50,
    temperature: float = 1.0,
    eval_text_len: int = 256,
    process_index: Optional[int] = None,
    process_count: Optional[int] = None,
) -> List[str]:
    """Writes this process's shard of ``prompts`` as grids and returns their
    paths. One-deep pipelined as ``geneval.run_geneval``: item i + 1 is
    enqueued before item i's pixels, fetched by a pinned copy and an event,
    are waited for and written. ``generator`` is consumed in item order."""
    os.makedirs(output_dir, exist_ok=True)
    written = []

    def flush(item, fetched):
        pixels, event = fetched
        if event is not None:
            event.synchronize()                 # item's pixels only
        path = os.path.join(output_dir, f"{item['item_id']}.png")
        save_png(make_grid_2x2(pixels_to_uint8(pixels)), path)
        written.append(path)

    pending = None
    for item in shard_for_process(prompts, process_index, process_count):
        pixels = pipeline.generate_images(
            [item["text"]] * n_samples, generator, guidance_scale=guidance_scale,
            timesteps=timesteps, temperature=temperature, max_text_len=eval_text_len)
        fetched = fetch_async(pixels.float())
        if pending is not None:
            flush(*pending)
        pending = (item, fetched)
    if pending is not None:
        flush(*pending)
    return written


def prepare_dpg_metadata(src: str, out: str, questions_out: Optional[str] = None) -> None:
    """DPG-bench prompt files -> the jsonl ``run_dpg`` reads ({item_id,
    text} rows): a directory of ``<item_id>.txt`` files, or the DPG csv,
    whose question columns go to ``questions_out`` ({item_id, prompt, text,
    questions} rows, the CoT-V question file) when it is given."""
    rows = []
    questions = defaultdict(list)
    texts = {}
    if os.path.isdir(src):
        # ELLA/dpg_bench layout: one .txt per prompt, stem = item_id
        for fn in sorted(os.listdir(src)):
            if fn.endswith(".txt"):
                with open(os.path.join(src, fn)) as f:
                    rows.append({"item_id": fn[:-4], "text": f.read().strip()})
    else:
        seen = set()
        with open(src, newline="") as f:
            for rec in csv.DictReader(f):
                item = rec.get("item_id") or rec.get("id")
                text = rec.get("text") or rec.get("prompt")
                if not item or not text:
                    continue
                if item not in seen:
                    seen.add(item)
                    rows.append({"item_id": item, "text": text.strip()})
                    texts[item] = text.strip()
                q = (rec.get("question_for_vqa") or rec.get("question")
                     or rec.get("tuple"))
                if q:
                    questions[item].append(q.strip())
    with open(out, "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")
    print(f"wrote {len(rows)} prompts to {out}")
    if questions_out and questions:
        with open(questions_out, "w") as f:
            for item, qs in questions.items():
                f.write(json.dumps({"item_id": item, "prompt": texts.get(item),
                                    "text": texts.get(item),
                                    "questions": qs}) + "\n")
        print(f"wrote questions for {len(questions)} prompts to {questions_out}")


def main(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser(description="DPG-bench generation with the port")
    sub = ap.add_subparsers(dest="command", required=True)
    gen = sub.add_parser("generate", help="one 2x2 grid PNG per prompt")
    gen.add_argument("--prompts-file", required=True, help="jsonl of {item_id, text}")
    gen.add_argument("--output-dir", required=True)
    gen.add_argument("--n-samples", type=int, default=4)
    gen.add_argument("--guidance-scale", type=float, default=6.0)
    gen.add_argument("--steps", type=int, default=50, help="MaskGIT steps")
    gen.add_argument("--text-len", type=int, default=256)
    gen.add_argument("--seed", type=int, default=0, help="weights and sampling")
    gen.add_argument("--model", choices=("flagship", "tiny"), default="flagship")
    gen.add_argument("--quantization", choices=("int8", "int4"), default=None)
    gen.add_argument("--device", default=None, help="cuda (default) or cpu")
    prep = sub.add_parser("prepare", help="DPG prompt files -> the jsonl generate reads")
    prep.add_argument("src", help="a directory of <item_id>.txt or the DPG csv")
    prep.add_argument("out")
    prep.add_argument("questions_out", nargs="?", default=None)
    args = ap.parse_args(argv)
    if args.command == "prepare":
        return prepare_dpg_metadata(args.src, args.out, args.questions_out)
    from ..launch import build_pipeline
    from .geneval import load_metadata_jsonl
    pipe = build_pipeline(args.model, device=args.device, seed=args.seed,
                          quantization=args.quantization)
    generator = torch.Generator(device=pipe.device)
    generator.manual_seed(args.seed)
    written = run_dpg(pipe, load_metadata_jsonl(args.prompts_file), args.output_dir, generator,
                      n_samples=args.n_samples, guidance_scale=args.guidance_scale,
                      timesteps=args.steps, eval_text_len=args.text_len)
    print(f"wrote {len(written)} grids to {args.output_dir}")
    return written


if __name__ == "__main__":
    main()
