"""Read a loader's next batches on a background thread.

The training entries' steps leave the host little time between them (the
host's enqueue of a step takes most of the step), so a loader that decodes
and resizes images in the training loop adds its time to every step. The
reference hides it in DataLoader worker processes; here one thread reads up
to ``DEPTH`` batches ahead of the step, in the loader's own order, while the
main thread launches the step or waits on the card (the decoder's ``zlib``,
the native unfilter and ``F.interpolate`` release the GIL). An exception in
the loader is raised in the consumer at the batch where it happened.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator, TypeVar

T = TypeVar("T")

_END = object()
DEPTH = 2       # batches read ahead of the step


class _Raised:
    def __init__(self, error: Exception):
        self.error = error


def prefetch(iterable: Iterable[T]) -> Iterator[T]:
    """``iterable``'s items, read ``DEPTH`` ahead on a daemon thread.
    Closing the iterator stops the thread."""
    q: "queue.Queue" = queue.Queue(maxsize=DEPTH)
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.05)
                return True
            except queue.Full:
                pass
        return False

    def produce():
        try:
            for item in iterable:
                if not put(item):
                    return
            put(_END)
        except Exception as e:  # raised in the consumer
            put(_Raised(e))

    thread = threading.Thread(target=produce, name="prefetch", daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is _END:
                return
            if isinstance(item, _Raised):
                raise item.error
            yield item
    finally:
        stop.set()
        thread.join()
