"""PyTorch/CUDA port of unigen_tpu for NVIDIA Hopper (H100).

The package mirrors ``unigen_tpu``'s module layout and holds the JAX package's
numerics as its reference. It imports ``torch`` and never ``jax`` or
``unigen_tpu``. Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; the hand-written kernels under ``csrc/`` are built with
``nvcc`` at first use into ``build/``.
"""
from .device import resolve_device  # noqa: F401

__version__ = "0.1.0"
