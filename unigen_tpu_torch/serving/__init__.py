"""Serving of the port: the continuous-batching text / VQA engine, its HTTP
front end, and the microbatching text-to-image engine."""
from .engine import EngineStats, GenerationResult, ServingEngine
from .images import ImageResult, ImageServingEngine
from .server import ServingHTTPServer

__all__ = ["ServingEngine", "GenerationResult", "EngineStats", "ServingHTTPServer",
           "ImageServingEngine", "ImageResult"]
