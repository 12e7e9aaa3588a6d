"""Retry with exponential backoff and jitter.

Port of ``unigen_tpu/utils/retry.py`` (the reference's ``backoff_on``,
components/core.py:54-70), with the port's logger: the same delays, the
same jitter draw (``random.random()``) and the same re-raise on the last
try.
"""
from __future__ import annotations

import functools
import random
import time
from typing import Callable, Tuple, Type

from .logging import get_logger

logger = get_logger(__name__)


def backoff_on(exceptions: Tuple[Type[BaseException], ...] = (Exception,),
               max_tries: int = 5, base_delay: float = 0.5,
               max_delay: float = 30.0, jitter: float = 0.1) -> Callable:
    """Retry the decorated function on ``exceptions``: up to ``max_tries``
    calls, sleeping ``min(delay, max_delay) * (1 + jitter * U)`` between
    them, the delay doubling from ``base_delay``; the last failure raises."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            delay = base_delay
            for attempt in range(max_tries):
                try:
                    return fn(*args, **kwargs)
                except exceptions as e:
                    if attempt == max_tries - 1:
                        raise
                    sleep = min(delay, max_delay) * (1 + jitter * random.random())
                    logger.warning(f"{fn.__name__} failed ({e!r}); retry "
                                   f"{attempt + 1}/{max_tries - 1} in {sleep:.1f}s")
                    time.sleep(sleep)
                    delay *= 2
        return wrapper
    return deco
