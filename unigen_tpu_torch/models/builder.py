"""Vision-tower dispatch by name: the port's copy of ``unigen_tpu/models/builder.py``."""
from __future__ import annotations

from . import siglip, siglip2


def get_vision_tower_config(vision_tower_name: str):
    """'siglip2' + 'naflex' -> SigLIP2-NaFlex, 'siglip' -> the
    fixed-resolution SigLIP tower. Returns (module, config); the module's
    ``forward`` runs the tower, ``weights.init_siglip`` / ``init_siglip2``
    draw its parameters."""
    name = vision_tower_name.lower()
    if "siglip2" in name and "naflex" in name:
        return siglip2, siglip2.Siglip2Config.naflex()
    if "siglip" in name:
        return siglip, siglip.SiglipConfig.so400m()
    raise ValueError(f"Unknown vision tower: {vision_tower_name}")
