"""Microbatching text-to-image serving.

Port of ``unigen_tpu/serving/images.py``. MaskGIT is a batch program of a
fixed number of steps: no slot frees mid-flight, every request runs all
steps together. So the serving shape is a microbatcher, not continuous
batching: collect up to ``batch`` prompts (waiting at most ``max_wait_s``
once one is queued), pad the tail with empty prompts to the one batch
shape, run the sampler, resolve the futures with uint8 images.

- The protocol (guidance scale, timesteps, temperature, schedule) is fixed
  per engine, so every batch has the same shape and launches.
- Row independence: the sampler draws its noise elementwise over the fixed
  [batch, ...] shape, so a request's image depends only on its row and the
  batch's generator (``ops.sampling.derived_generator`` of the seed and the
  batch counter), never on what shares or pads the microbatch.
- One scheduler thread drives the device. The kernels queue on that
  thread's current CUDA stream, which is the default stream, as in the
  caller's thread, so the engine's images equal a direct ``generate_images``
  call on the same generator.
"""
from __future__ import annotations

import itertools
import queue
import threading
import time
from typing import Any, List, Optional, Tuple

import numpy as np

from ..ops.sampling import derived_generator
from ..pipeline import UniGenPipeline, pixels_to_uint8


class ImageResult:
    """Future for one image request; ``result()`` blocks for the uint8 pixels."""

    def __init__(self, rid: int):
        self.request_id = rid
        self._event = threading.Event()
        self._image: Optional[np.ndarray] = None
        self._error: Optional[BaseException] = None
        # client-observed latency marks (perf_counter seconds)
        self.submit_t: float = time.perf_counter()
        self.done_t: Optional[float] = None

    def _resolve(self, image: np.ndarray) -> None:
        self._image = image
        self.done_t = time.perf_counter()
        self._event.set()

    def _fail(self, err: BaseException) -> None:
        self._error = err
        self._event.set()

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"image request {self.request_id} not done after {timeout}s")
        if self._error is not None:
            raise self._error
        return self._image


class ImageServingEngine:
    """Text-to-image request server over a UniGen pipeline.

    Usage::

        eng = ImageServingEngine(pipeline, batch=6)
        fut = eng.submit("a red cube on a blue sphere")
        image = fut.result()          # uint8 [H, W, 3]
        eng.close()

    One scheduler thread drives the device; submissions come from any
    thread. The GenEval protocol (guidance 6.0, 50 steps) is the default.
    """

    def __init__(self, pipeline: UniGenPipeline, *, batch: int = 6,
                 max_wait_s: float = 0.25, guidance_scale: float = 6.0,
                 timesteps: int = 50, temperature: float = 1.0,
                 max_text_len: int = 128, mask_schedule: str = "cosine",
                 mode: str = "mask", seed: int = 0):
        self.pipeline = pipeline
        self.batch = batch
        self.max_wait_s = max_wait_s
        self.protocol = dict(guidance_scale=guidance_scale, timesteps=timesteps,
                             temperature=temperature, max_text_len=max_text_len,
                             mask_schedule=mask_schedule, mode=mode)
        self.seed = seed
        self._batch_counter = itertools.count()
        self._rid = itertools.count()
        self._queue: "queue.Queue[Optional[Tuple[str, ImageResult]]]" = queue.Queue()
        self._closing = False
        self.batches_run = 0
        self.requests_completed = 0
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="unigen-image-serving")
        self._thread.start()

    @property
    def healthy(self) -> bool:
        """True while the scheduler thread is serving (liveness probes)."""
        return self._thread.is_alive() and not self._closing

    def submit(self, prompt: str) -> ImageResult:
        """Queue one text prompt; returns a future resolving to uint8 pixels."""
        if self._closing:
            raise RuntimeError("engine is closed")
        fut = ImageResult(next(self._rid))
        self._queue.put((str(prompt), fut))
        # the scheduler may have died between the check and the put; nothing
        # will drain the item then: fail it (idempotent with the death drain)
        if self._closing and not self._thread.is_alive():
            fut._fail(RuntimeError("engine is closed"))
        return fut

    # -- scheduler -------------------------------------------------------------

    def _collect(self) -> List[Tuple[str, ImageResult]]:
        """One microbatch: block for the first request, then fill slots until
        the batch is full or ``max_wait_s`` has elapsed. After the shutdown
        sentinel, stragglers that raced past the closed check in ``submit``
        are still drained into batches so their futures resolve."""
        items: List[Tuple[str, ImageResult]] = []
        first = self._queue.get()
        if first is None:
            self._closing = True
        else:
            items.append(first)
            deadline = time.monotonic() + self.max_wait_s
            while len(items) < self.batch and not self._closing:
                try:
                    nxt = self._queue.get(
                        timeout=max(0.0, deadline - time.monotonic()))
                except queue.Empty:
                    break
                if nxt is None:
                    self._closing = True
                else:
                    items.append(nxt)
        if self._closing:
            try:
                while len(items) < self.batch:
                    nxt = self._queue.get(block=False)
                    if nxt is not None:
                        items.append(nxt)
            except queue.Empty:
                pass
        return items

    def _loop(self) -> None:
        while True:
            items = self._collect()
            if not items and self._closing:
                return
            try:
                prompts = [p for p, _ in items]
                padded = prompts + [""] * (self.batch - len(prompts))
                generator = derived_generator(self.seed, next(self._batch_counter),
                                              device=self.pipeline.device)
                pixels = self.pipeline.generate_images(padded, generator, **self.protocol)
                images = pixels_to_uint8(pixels)
                for i, (_, fut) in enumerate(items):
                    fut._resolve(images[i])
                    self.requests_completed += 1
                self.batches_run += 1
            except BaseException as e:
                self._closing = True  # reject new submissions: no serving thread
                for _, fut in items:
                    fut._fail(e)
                # drain everything queued so no caller blocks forever
                try:
                    while True:
                        nxt = self._queue.get(block=False)
                        if nxt is not None:
                            nxt[1]._fail(e)
                except queue.Empty:
                    pass
                raise
            if self._closing and self._queue.empty():
                return

    # -- lifecycle ---------------------------------------------------------------

    def close(self, timeout: Optional[float] = 300.0) -> None:
        """Finish all queued requests, then stop the scheduler."""
        self._closing = True          # reject new submissions immediately
        self._queue.put(None)
        self._thread.join(timeout)
        if self._thread.is_alive():
            return  # still draining a long backlog: don't steal its queue
        # fail anything that raced into the queue after the scheduler exited
        try:
            while True:
                item = self._queue.get(block=False)
                if item is not None:
                    item[1]._fail(RuntimeError("engine is closed"))
        except queue.Empty:
            pass

    def __enter__(self) -> "ImageServingEngine":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()
