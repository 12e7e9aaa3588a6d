"""The port's retry, profiling and trace analysis against the JAX package's
(``unigen_tpu/utils/{retry,profiling,trace_analysis}.py``) on the CPU:
the same sleeps and the same raise for ``backoff_on`` (``time.sleep`` and
``random.random`` patched on both sides), JAX's stack sweep of exclusive
times on the same nested intervals (exact), and a traced CPU matmul read
back by ``op_table`` (tests/test_aux.py::test_profiling_trace_writes)."""
import io
import json
import os
import random
import sys
import time
import types

import numpy as np
import pytest
import torch

from unigen_tpu.utils import retry as JR
from unigen_tpu.utils import trace_analysis as JTA
from unigen_tpu_torch.utils import profiling as PR
from unigen_tpu_torch.utils import retry as TR
from unigen_tpu_torch.utils import trace_analysis as TA


def _sleeps(backoff_on, fails, monkeypatch, **kw):
    """(sleeps, result or the exception's repr, calls) of a function that
    fails ``fails`` times, retried by ``backoff_on(**kw)``, with the jitter
    draws a fixed sequence."""
    draws = iter(np.random.default_rng(0).random(16).tolist())
    sleeps = []
    monkeypatch.setattr(time, "sleep", sleeps.append)
    monkeypatch.setattr(random, "random", lambda: next(draws))
    calls = {"n": 0}

    @backoff_on((ValueError,), **kw)
    def flaky():
        calls["n"] += 1
        if calls["n"] <= fails:
            raise ValueError(f"boom {calls['n']}")
        return 42
    try:
        out = flaky()
    except ValueError as e:
        out = repr(e)
    return sleeps, out, calls["n"]


@pytest.mark.parametrize("fails,kw", [
    (2, dict(max_tries=3, base_delay=0.01)),                           # tests/test_aux.py:69
    (1, dict(max_tries=2, base_delay=0.01)),
    (9, dict(max_tries=2, base_delay=0.01)),                           # the last try raises
    (6, dict(max_tries=7, base_delay=0.5, max_delay=3.0, jitter=0.3)),  # the cap
    (9, dict()),                                                        # the defaults, raises
])
def test_backoff_on_matches_jax(fails, kw, monkeypatch):
    want = _sleeps(JR.backoff_on, fails, monkeypatch, **kw)
    got = _sleeps(TR.backoff_on, fails, monkeypatch, **kw)
    assert got == want
    assert got[1] == (42 if fails < kw.get("max_tries", 5) else f"ValueError('boom {got[2]}')")


def _nested_intervals(seed):
    """Random properly nested intervals (a tree of spans with gaps), as
    JAX's XPlane events: ``offset_ps``, ``duration_ps``, ``metadata_id``."""
    rng = np.random.default_rng(seed)
    out = []

    def span(start, end, depth):
        t = start
        while t < end:
            s = t + int(rng.integers(0, 50))
            e = min(end, s + int(rng.integers(1, 400)))
            if s >= e:
                break
            out.append(types.SimpleNamespace(offset_ps=s, duration_ps=e - s,
                                             metadata_id=int(rng.integers(0, 6))))
            if depth < 3 and e - s > 4:
                span(s, e, depth + 1)
            t = e
    span(0, 5000, 0)
    # a tie: two events starting together, the longer one the parent
    out.append(types.SimpleNamespace(offset_ps=6000, duration_ps=100, metadata_id=1))
    out.append(types.SimpleNamespace(offset_ps=6000, duration_ps=40, metadata_id=2))
    rng.shuffle(out)
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_exclusive_times_match_jax(seed):
    evs = _nested_intervals(seed)
    want = JTA._exclusive_times(evs)
    got = TA._exclusive_times(((e.offset_ps, e.offset_ps + e.duration_ps, e.metadata_id)
                               for e in evs), 1e9)
    assert len(got) == len(evs) > 20
    assert got == want


def test_op_table_prefers_device_events(tmp_path):
    """A Chrome trace with kernels on two streams and nested host operators:
    the table holds the kernels only, each name's exclusive time JAX's sweep
    summed over its stream; with the kernels removed, the host operators'."""
    evs = _nested_intervals(2)
    records = [{"ph": "X", "cat": "cpu_op", "name": f"op{e.metadata_id}", "pid": 1, "tid": 1,
                "ts": e.offset_ps / 1e3, "dur": e.duration_ps / 1e3} for e in evs]
    kernels = [{"ph": "X", "cat": "kernel", "name": f"k{i % 3}", "pid": 0, "tid": 7 + i % 2,
                "ts": 10.0 * i, "dur": 4.0 + i} for i in range(8)]
    annotation = {"ph": "X", "cat": "gpu_user_annotation", "name": "span", "pid": 0, "tid": 7,
                  "ts": 0.0, "dur": 100.0}
    for name, recs in (("device", records + kernels + [annotation]), ("cpu", records)):
        d = tmp_path / name
        d.mkdir()
        (d / "trace.json").write_text(json.dumps({"traceEvents": recs}))
        rows = {r["name"]: (r["total_ms"], r["count"]) for r in TA.op_table(str(d))}
        want = {}
        src = kernels if name == "device" else records
        for lane in {(r["pid"], r["tid"]) for r in src}:
            mine = [r for r in src if (r["pid"], r["tid"]) == lane]
            spans = [types.SimpleNamespace(offset_ps=round(r["ts"] * 1e6),
                                           duration_ps=round(r["dur"] * 1e6),
                                           metadata_id=r["name"]) for r in mine]
            for key, ms in JTA._exclusive_times(spans):
                t, c = want.get(key, (0.0, 0))
                want[key] = (t + ms, c + 1)
        assert set(rows) == set(want)
        for key, (ms, count) in want.items():
            assert rows[key][1] == count
            assert rows[key][0] == pytest.approx(round(ms, 3), abs=1e-3)
    assert TA.device_busy_ms(str(tmp_path / "device")) == pytest.approx(
        sum(4.0 + i for i in range(8)) / 1e3, abs=1e-6)


def test_profiling_trace_writes(tmp_path, monkeypatch):
    """tests/test_aux.py::test_profiling_trace_writes on the port: a traced
    CPU matmul inside an annotation and a step marker writes a trace that
    ``op_table`` and the ``python -m`` entry read (the host's operators,
    with no device in the trace); the live server raises."""
    d = str(tmp_path / "trace")
    with PR.trace(d):
        with PR.step_marker(0), PR.annotate("test-region"):
            _ = torch.ones((8, 8)) @ torch.ones((8, 8))
    found = [f for _, _, files in os.walk(d) for f in files]
    assert found, "no trace files written"
    rows = TA.op_table(d)
    assert rows and any("mm" in r["name"] for r in rows)
    names = {e.name for e in TA.load_events(d)}
    assert {"test-region", "train#0"} <= names
    out = io.StringIO()
    monkeypatch.setattr(sys, "stdout", out)
    TA.main([d, "3"])                 # python -m unigen_tpu_torch.utils.trace_analysis DIR 3
    lines = out.getvalue().splitlines()
    assert len(lines) == 5 and lines[-1].startswith("TOTAL device busy")
    with pytest.raises(NotImplementedError, match="profiling.trace"):
        PR.start_profiler_server(9999)
