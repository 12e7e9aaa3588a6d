"""Profiling hooks on ``torch.profiler``.

Port of ``unigen_tpu/utils/profiling.py``: ``trace(log_dir)`` records the
enclosed block (the host's operators and, with a card, its kernels) and
writes it as a Chrome trace that Perfetto or ``chrome://tracing`` open and
``utils/trace_analysis.py`` reads; ``annotate`` names a span inside it;
``step_marker`` marks a train step. Usage::

    from unigen_tpu_torch.utils import profiling, trace_analysis
    with profiling.trace("/tmp/tr"):
        with profiling.step_marker(0):
            run_step()
    trace_analysis.print_table(trace_analysis.op_table("/tmp/tr"))
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from .logging import get_logger

logger = get_logger(__name__)


def start_profiler_server(port: int = 9999) -> None:
    """JAX's live profiler endpoint (``jax.profiler.start_server``) has no
    counterpart in PyTorch: ``torch.profiler`` records only inside the
    process, between a start and a stop, and on-demand capture goes through
    the separate dynolog daemon (``KINETO_USE_DAEMON``), which the port does
    not depend on. So this raises; trace a block with ``trace`` instead."""
    raise NotImplementedError(
        f"no live profiler server on port {port}: PyTorch offers no in-process profiler "
        "endpoint (on-demand capture needs the external dynolog daemon); use "
        "profiling.trace(log_dir) around the block instead")


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[profile]:
    """Record the enclosed block with ``torch.profiler`` (the CPU's operators,
    and the card's kernels when CUDA is available) and write it to
    ``log_dir/trace-<time>-<pid>.json``, a Chrome trace. Yields the profiler;
    the card is synchronised before the recording stops."""
    os.makedirs(log_dir, exist_ok=True)
    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        try:
            yield prof
        finally:
            if cuda:
                torch.cuda.synchronize()
    path = os.path.join(log_dir, f"trace-{time.strftime('%Y%m%d-%H%M%S')}-{os.getpid()}.json")
    prof.export_chrome_trace(path)
    logger.info(f"trace written to {path}")


def annotate(name: str):
    """A named span inside a trace (``record_function``)."""
    return record_function(name)


def step_marker(step: int):
    """A span marking train step ``step`` on the trace's timeline."""
    return record_function(f"train#{step}")
