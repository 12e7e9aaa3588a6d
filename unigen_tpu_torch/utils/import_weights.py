"""One-time conversion of reference (torch / HF) checkpoints to the native format.

Port of ``scripts/import_weights.py``: converts the reference's torch key
layout (single or sharded safetensors, or ``pytorch_model*.bin``) into the
native format (``utils/persistence.py``: ``/``-joined JAX-layout tree paths
in safetensors plus ``config.json``), which both packages read and every
``launch`` loader takes without converting again. It is a conversion of
files on the host: nothing is computed on a device.

    python -m unigen_tpu_torch.utils.import_weights \\
        config=configs/unigen_1_5b/unigen_sft.yaml unigen_src=/ckpts/unigen-1.5b \\
        [magvit_src=/ckpts/magvitv2] [vision_src=/ckpts/siglip] out=/ckpts/converted

Each ``*_src`` is optional; what is given is written to ``<out>/unigen``,
``<out>/magvitv2`` and ``<out>/<tower name>``. ``unigen_src`` may be the
checkpoint root (its ``unwrapped_model/`` is taken, the reference
train.py:1105-1118 layout) or the unwrapped directory itself. The sizes are
the config's: the UniGen config its YAML and tokenizer imply (bf16), and
MAGViTv2 and the tower with ``model.vq_model`` / ``model.vision_tower``'s size
overrides, in float32, as JAX's script converts them (which ignores those
overrides; no shipped config sets one). Any other ``key=value`` is a config
override. Exits 2 when there is nothing to convert.
"""
from __future__ import annotations

import os
import sys
from typing import Dict, Optional

import torch

from .. import launch
from .. import weights as W
from ..models.builder import get_vision_tower_config
from .configuration import initialize_config
from .hf_import import import_magvit, import_unigen, load_state_dict
from .persistence import save_pretrained


def convert(config, unigen_src: Optional[str] = None, magvit_src: Optional[str] = None,
            vision_src: Optional[str] = None, out: str = "converted") -> Dict[str, str]:
    """Returns {component: output directory} for everything converted."""
    written = {}
    if unigen_src:
        prompting = launch.build_prompting_from_config(config, launch.load_tokenizer(config))
        cfg = launch.build_unigen_config(config, prompting)
        resolved = os.path.join(unigen_src, "unwrapped_model") \
            if os.path.isdir(os.path.join(unigen_src, "unwrapped_model")) else unigen_src
        dst = os.path.join(out, "unigen")
        save_pretrained(W.unigen_to_jax(import_unigen(resolved, cfg), cfg), dst, config=cfg)
        written["unigen"] = dst
    if magvit_src:
        cfg = launch.vq_config(config, torch.float32)
        dst = os.path.join(out, "magvitv2")
        save_pretrained(W.magvit_to_jax(import_magvit(magvit_src, cfg)), dst, config=cfg)
        written["magvitv2"] = dst
    if vision_src:
        name = config["model"].get("vision_tower", {}).get("name", "siglip")
        cfg = launch.vision_tower_config(config) or get_vision_tower_config(name)[1]
        _, to_jax, _, convert_hf = launch.tower_codec(cfg)
        dst = os.path.join(out, name)
        save_pretrained(to_jax(convert_hf(load_state_dict(vision_src), cfg), cfg), dst,
                        config=cfg)
        written[name] = dst
    return written


def main(argv=None) -> None:
    args = sys.argv[1:] if argv is None else list(argv)
    kw = dict(a.split("=", 1) for a in args if "=" in a)
    config = initialize_config(kw.get("config"),
                               [a for a in args if not a.split("=", 1)[0].endswith("_src")
                                and not a.startswith("out=")])
    written = convert(config, unigen_src=kw.get("unigen_src"), magvit_src=kw.get("magvit_src"),
                      vision_src=kw.get("vision_src"), out=kw.get("out", "converted"))
    if not written:
        print("nothing to convert: pass unigen_src= / magvit_src= / vision_src=", file=sys.stderr)
        sys.exit(2)
    for comp, dst in written.items():
        print(f"converted {comp} -> {dst}")


if __name__ == "__main__":
    main()
