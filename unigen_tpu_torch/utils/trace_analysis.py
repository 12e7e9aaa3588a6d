"""Analysis of ``torch.profiler`` traces: per-op device-time tables.

Port of ``unigen_tpu/utils/trace_analysis.py`` and the port's one reader of
profiler events. Two sources give the same ``Event`` list:

- ``load_events(trace_dir)``: the newest Chrome trace under a directory,
  as ``profiling.trace`` writes it (device records are the ``kernel``,
  ``gpu_memcpy`` and ``gpu_memset`` events, GPU annotations the
  ``gpu_user_annotation`` ones);
- ``profiler_events(prof)``: a live ``torch.profiler.profile``.

Over them: ``op_table`` (device time by kernel name, each event's time
exclusive of the events nested in it, by JAX's stack sweep; the host's
operators when the trace holds no device event, as JAX falls back to its
CPU plane), ``device_busy_ms``, ``busy_ms`` (the union of the device
intervals), ``kernel_times`` (by name, raw durations), ``annotated_ms``
(device time inside GPU annotations of a prefix), and ``device_traces`` /
``traces_ms`` (the kernels of a function's calls, one trace of whole calls
or traced until two traces agree, and their device ms a call). Usage::

    from unigen_tpu_torch.utils import profiling, trace_analysis
    with profiling.trace("/tmp/tr"):
        run_step()
    trace_analysis.print_table(trace_analysis.op_table("/tmp/tr"))

or ``python -m unigen_tpu_torch.utils.trace_analysis /tmp/tr [top_n]``.
"""
from __future__ import annotations

import glob
import gzip
import json
import os
import sys
from typing import Callable, Dict, Hashable, Iterable, List, NamedTuple, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class NoDeviceTime(RuntimeError):
    """The profiler recorded no device event where one was expected."""


class Event(NamedTuple):
    name: str
    start: float        # microseconds
    end: float
    lane: Hashable      # events of one lane (a thread, a stream) may nest
    kind: str           # "device", "device_annotation", "cpu" or "annotation"


def trace_files(trace_dir: str) -> List[str]:
    """The Chrome traces under ``trace_dir``, oldest first."""
    files = [f for pat in ("*.json", "*.json.gz")
             for f in glob.glob(os.path.join(trace_dir, "**", pat), recursive=True)]
    return sorted(files, key=os.path.getmtime)


def load_events(trace_dir: str) -> List[Event]:
    """The events of the newest Chrome trace under ``trace_dir``."""
    files = trace_files(trace_dir)
    if not files:
        raise FileNotFoundError(f"no Chrome trace (*.json) under {trace_dir}")
    opener = gzip.open if files[-1].endswith(".gz") else open
    with opener(files[-1], "rt") as f:
        records = json.load(f)["traceEvents"]
    kinds = {**dict.fromkeys(DEVICE_CATS, "device"), "gpu_user_annotation": "device_annotation",
             "cpu_op": "cpu", "user_annotation": "annotation"}
    return [Event(r["name"], float(r["ts"]), float(r["ts"]) + float(r.get("dur", 0.0)),
                  (r.get("pid"), r.get("tid")), kinds[r.get("cat")])
            for r in records if r.get("ph") == "X" and r.get("cat") in kinds]


def profiler_events(prof) -> List[Event]:
    """The events of a finished ``torch.profiler.profile``."""
    from torch.autograd import DeviceType
    out = []
    for e in prof.events():
        device = e.device_type == DeviceType.CUDA
        kind = ("device" if device else "cpu") if not e.is_user_annotation else (
            "device_annotation" if device else "annotation")
        lane = (e.device_index, getattr(e, "device_resource_id", None)) if device else e.thread
        out.append(Event(e.name, e.time_range.start, e.time_range.end, lane, kind))
    return out


def _exclusive_times(intervals: Iterable[Tuple[float, float, Hashable]], scale: float
                     ) -> List[Tuple[Hashable, float]]:
    """(key, exclusive time / ``scale``) of each (start, end, key) interval:
    its duration less the intervals nested in it, by JAX's stack sweep over
    the intervals sorted by start (the longer first on a tie). The same
    arithmetic as JAX's ``_exclusive_times`` (picoseconds, ``scale`` 1e9 for
    milliseconds); Chrome traces are in microseconds (``scale`` 1e3)."""
    evs = sorted(intervals, key=lambda e: (e[0], -e[1]))
    out: List[Tuple[Hashable, float]] = []
    stack: List[list] = []  # [start, end, key, child time]

    def close():
        top = stack.pop()
        out.append((top[2], (top[1] - top[0] - top[3]) / scale))
        if stack:
            stack[-1][3] += top[1] - top[0]
    for s, e, key in evs:
        while stack and s >= stack[-1][1]:
            close()
        stack.append([s, e, key, 0])
    while stack:
        close()
    return out


def op_table_of(events: List[Event], top_n: Optional[int] = None) -> List[dict]:
    """Time by op name, exclusive of nested events, lane by lane: the device's
    kernels and copies, or the host's operators (``cpu_op``) when there is
    no device event. Rows ``{name, total_ms, count, pct}``, longest first."""
    chosen = [e for e in events if e.kind == "device"] or [e for e in events if e.kind == "cpu"]
    lanes: Dict[Hashable, List[Event]] = {}
    for e in chosen:
        lanes.setdefault(e.lane, []).append(e)
    agg: Dict[str, Tuple[float, int]] = {}
    for evs in lanes.values():
        for name, ms in _exclusive_times(((e.start, e.end, e.name) for e in evs), 1e3):
            t, c = agg.get(name, (0.0, 0))
            agg[name] = (t + ms, c + 1)
    total = sum(t for t, _ in agg.values()) or 1.0
    rows = [{"name": k, "total_ms": round(t, 3), "count": c,
             "pct": round(100.0 * t / total, 2)}
            for k, (t, c) in sorted(agg.items(), key=lambda kv: -kv[1][0])]
    return rows[:top_n] if top_n else rows


def op_table(trace_dir: str, top_n: Optional[int] = None) -> List[dict]:
    """``op_table_of`` the newest trace under ``trace_dir``."""
    return op_table_of(load_events(trace_dir), top_n)


def device_busy_ms(trace_dir: str) -> float:
    """The summed exclusive time of the trace's device events (ms)."""
    return sum(r["total_ms"] for r in op_table(trace_dir))


def busy_ms(events: List[Event]) -> float:
    """The union of the device intervals, GPU annotations included (which
    overlap their kernels and are not counted twice), in ms."""
    busy_us, end = 0.0, float("-inf")
    for start, stop in sorted((e.start, e.end) for e in events if e.kind.startswith("device")):
        busy_us += max(0.0, stop - max(start, end))
        end = max(end, stop)
    return busy_us / 1e3


def kernel_times(events: List[Event]) -> Dict[str, Tuple[float, int]]:
    """{kernel name: (ms, launches)} of the device events, raw durations."""
    by_name: Dict[str, Tuple[float, int]] = {}
    for e in events:
        if e.kind == "device":
            ms, count = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + (e.end - e.start) / 1e3, count + 1)
    return by_name


def annotated_ms(events: List[Event], prefix: str) -> Dict[str, float]:
    """{name without ``prefix``: device ms} of the device events whose name
    starts with ``prefix`` (the GPU side of ``record_function`` spans)."""
    parts: Dict[str, float] = {}
    for e in events:
        if e.kind.startswith("device") and e.name.startswith(prefix):
            key = e.name[len(prefix):]
            parts[key] = parts.get(key, 0.0) + (e.end - e.start) / 1e3
    return parts


def whole_calls(trace: List[Tuple[str, float]], iters: int) -> bool:
    """Whether a trace (in launch order) holds ``iters`` calls that each
    launched the same kernels in the same order; never for one call, which
    has nothing to be held against."""
    if iters < 2 or not trace or len(trace) % iters:
        return False
    k = len(trace) // iters
    names = [name for name, _ in trace]
    return all(names[i * k:(i + 1) * k] == names[:k] for i in range(1, iters))


def device_traces(fn: Callable[[], object], iters: int) -> List[List[Tuple[str, float]]]:
    """The device kernels that ``iters`` calls of ``fn`` launch, as one
    [(name, microseconds)] list a trace in launch order, after a warm-up
    call. A trace now and then comes back with some or all of its device
    records missing, so one trace is kept alone only when it holds
    ``iters`` equal calls (``whole_calls``); else traces are taken until two
    hold the same number of device records (at most four), and every trace
    is returned. Raises ``NoDeviceTime`` if none holds one."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    traces = []
    while len(traces) < 4:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        traces.append([(e.name, e.end - e.start) for e in
                       sorted(profiler_events(prof), key=lambda e: e.start)
                       if e.kind == "device"])
        counts = [len(t) for t in traces if t]
        if len(counts) > len(set(counts)) or (len(traces) == 1 and whole_calls(traces[0], iters)):
            break
    if not any(traces):
        raise NoDeviceTime(f"the profiler recorded no device time in {len(traces)} traces")
    return traces


def traces_ms(traces: List[List[Tuple[str, float]]], iters: int) -> float:
    """Device ms a call: the summed kernel durations, the mean over the
    fullest traces, over ``iters`` calls."""
    most = max(len(t) for t in traces)
    kept = [sum(us for _, us in t) for t in traces if len(t) == most]
    return sum(kept) / len(kept) / 1e3 / iters


def print_table(rows: List[dict], top_n: int = 15, file=None) -> None:
    file = file or sys.stderr
    total = sum(r["total_ms"] for r in rows)
    print(f"{'op':<64} {'ms':>10} {'count':>7} {'%':>6}", file=file)
    for r in rows[:top_n]:
        print(f"{r['name'][:64]:<64} {r['total_ms']:>10.3f} {r['count']:>7} "
              f"{r['pct']:>6.2f}", file=file)
    print(f"{'TOTAL device busy':<64} {total:>10.3f}", file=file)


def main(argv: Optional[List[str]] = None) -> None:
    """``python -m unigen_tpu_torch.utils.trace_analysis TRACE_DIR [TOP_N]``."""
    argv = sys.argv[1:] if argv is None else argv
    d = argv[0] if argv else "/tmp/unigen_trace"
    n = int(argv[1]) if len(argv) > 1 else 15
    print_table(op_table(d), top_n=n, file=sys.stdout)


if __name__ == "__main__":
    main()
