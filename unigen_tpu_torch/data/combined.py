"""Combined multi-task loader (the reference joins its t2i/lm/mmu loaders with
Lightning's CombinedLoader in max_size_cycle mode, train.py:39,451). Here: a
plain iterator that cycles shorter streams so every step sees all task flows.
The port's copy of ``unigen_tpu/data/combined.py``.
"""
from __future__ import annotations

from typing import Dict, Iterator, Mapping


def combined_loader(flows: Mapping[str, Iterator], mode: str = "max_size_cycle"
                    ) -> Iterator[Dict[str, Dict]]:
    """Yield {flow_name: batch} dicts; infinite streams just zip, finite streams
    cycle (max_size_cycle) or stop the whole loader (min_size)."""
    iters = {}
    for name, flow in flows.items():
        it = iter(flow)
        if mode == "max_size_cycle":
            # cycle on exhaustion without materializing the stream
            def cycling(f=flow):
                while True:
                    yielded = False
                    for item in iter(f):
                        yielded = True
                        yield item
                    if not yielded:
                        return
            it = cycling()
        iters[name] = it
    while True:
        batch = {}
        for name, it in iters.items():
            try:
                batch[name] = next(it)
            except StopIteration:
                return
        yield batch
