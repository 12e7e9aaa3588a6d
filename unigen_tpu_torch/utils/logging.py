"""Metrics and logging: meters, the JSONL metric sink, grad-norm dumps.

The port's copy of the host half of ``unigen_tpu/utils/logging.py``:
stdout for INFO and below, stderr from WARNING; ``metrics.jsonl`` always,
wandb only when asked for and importable (looked up by name at that
point: neither machine has it).
"""
from __future__ import annotations

import importlib
import json
import logging
import os
import sys
import time
from typing import Any, Dict, Optional

import torch


def get_logger(name: str = "unigen_tpu_torch") -> logging.Logger:
    """stdout for <= INFO, stderr for >= WARNING."""
    logger = logging.getLogger(name)
    if logger.handlers:
        return logger
    logger.setLevel(logging.INFO)
    fmt = logging.Formatter("%(asctime)s %(levelname)s %(name)s: %(message)s")
    out = logging.StreamHandler(sys.stdout)
    out.setLevel(logging.INFO)
    out.addFilter(lambda r: r.levelno < logging.WARNING)
    out.setFormatter(fmt)
    err = logging.StreamHandler(sys.stderr)
    err.setLevel(logging.WARNING)
    err.setFormatter(fmt)
    logger.addHandler(out)
    logger.addHandler(err)
    logger.propagate = False
    return logger


def set_verbosity(level: int) -> None:
    """Library-wide verbosity (HF-style)."""
    get_logger().setLevel(level)


def set_verbosity_info() -> None:
    set_verbosity(logging.INFO)


def set_verbosity_warning() -> None:
    set_verbosity(logging.WARNING)


def set_verbosity_error() -> None:
    set_verbosity(logging.ERROR)


def set_verbosity_debug() -> None:
    set_verbosity(logging.DEBUG)


class AverageMeter:
    """Running value / average / count; ``update`` reads a device tensor back."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        val = float(val)
        self.val = val
        self.sum += val * n
        self.count += n

    @property
    def avg(self) -> float:
        return self.sum / max(self.count, 1)


class MetricLogger:
    """Scalar metric sink: ``<output_dir>/metrics.jsonl``, and wandb when
    ``use_wandb`` and the package is there."""

    def __init__(self, output_dir: Optional[str] = None, use_wandb: bool = False,
                 wandb_kwargs: Optional[Dict] = None):
        self._file = None
        if output_dir:
            os.makedirs(output_dir, exist_ok=True)
            self._file = open(os.path.join(output_dir, "metrics.jsonl"), "a")
        self._wandb = None
        if use_wandb:
            try:
                self._wandb = importlib.import_module("wandb").init(**(wandb_kwargs or {}))
            except ImportError:
                get_logger().warning("wandb requested but not installed; JSONL only")

    def log(self, metrics: Dict[str, Any], step: int) -> None:
        clean = {k: (float(v) if hasattr(v, "item") or isinstance(v, (int, float)) else v)
                 for k, v in metrics.items()}
        clean["step"] = step
        clean["time"] = time.time()
        if self._file:
            self._file.write(json.dumps(clean) + "\n")
            self._file.flush()
        if self._wandb:
            self._wandb.log(clean, step=step)

    def close(self):
        if self._file:
            self._file.close()


def grad_norms_by_param(grads: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """{"grad_norm/<path>": fp32 L2 norm} of a {path: gradient} mapping
    (``training.optimizer.named_leaves`` paths)."""
    return {f"grad_norm/{path}": float(torch.linalg.vector_norm(g, dtype=torch.float32))
            for path, g in grads.items()}
