"""Serving of the port: the microbatching text-to-image engine."""
from .images import ImageResult, ImageServingEngine

__all__ = ["ImageServingEngine", "ImageResult"]
