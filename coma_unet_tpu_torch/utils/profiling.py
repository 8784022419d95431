"""Profiling (counterpart of `coma_unet_tpu/utils/profiling.py`): a
`torch.profiler` trace around any stretch of work, written as a
Chrome/Perfetto trace JSON, a wall-clock step timer that forces the
device to finish before it stops the clock, and the program's spans.

    with trace("/tmp/trace"):       # -> /tmp/trace/trace.<pid>.<ns>.json
        run_steps()
    timer = StepTimer()
    with timer.measure(loss):       # float(torch.sum(loss)) before the stop
        loss.add_(step())
    timer.p50()

Spans name the phases of the program's work: a train step (`train.step`)
and inside it each forward (`train.forward`), each loss term
(`train.loss`), the backward (`train.backward`), the gradient norm
(`train.grad_norm`) and the optimizer's update (`train.optimizer`); a
batch's copy to the device (`data.to_device`) and a synthesis forward
(`infer.forward`). `span(name)` stamps its block with `time.time_ns()`,
the clock of the traces `torch.profiler` exports (their
`baseTimeNanoseconds` plus `ts` in microseconds), and appends a `Span`
to `SPANS`, a ring of the last `SPAN_RING` spans of the process. The
recorder is always on: a span costs a few microseconds of host time and
never touches the device, so device work is put down to the span open on
the host when it was launched. `trace` writes the spans of its block into
its file, in a row of their own.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from collections import deque
from typing import Deque, Iterator, List, NamedTuple, Optional

import numpy as np
import torch


SPAN_RING = 4096   # the last 585 RnC train steps, of 7 spans each


class Span(NamedTuple):
    """A closed span: `time.time_ns()` at entry and exit; `parent` is the
    id of the span open around it on its thread (0 for none), `root` the
    id of the outermost one, shared by every span of one step or
    request."""
    name: str
    start_ns: int
    end_ns: int
    parent: int
    root: int
    id: int


SPANS: Deque[Span] = deque(maxlen=SPAN_RING)
_ids = itertools.count(1)
_open = threading.local()


class _Open:
    __slots__ = ("name", "id", "parent", "root", "start")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> "_Open":
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        self.id = next(_ids)
        if stack:
            self.parent, self.root = stack[-1].id, stack[-1].root
        else:
            self.parent, self.root = 0, self.id
        stack.append(self)
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        end = time.time_ns()
        _open.stack.pop()
        SPANS.append(Span(self.name, self.start, end, self.parent, self.root,
                          self.id))
        return False   # a block that raises is recorded and raises on


def span(name: str) -> _Open:
    """`with span(name):` records the block as a `Span` in `SPANS`, also
    when it raises."""
    return _Open(name)


SPAN_PID = 2 ** 31 - 1   # the spans' row in an exported trace


def _write_spans(path: str, spans: List[Span]) -> None:
    """Add `spans` to the chrome trace at `path` on its clock, nested by
    time in one row ("program spans")."""
    with open(path) as f:
        doc = json.load(f)
    base = doc.get("baseTimeNanoseconds", 0)
    events = doc.setdefault("traceEvents", [])
    events.append({"ph": "M", "name": "process_name", "pid": SPAN_PID,
                   "tid": 0, "args": {"name": "program spans"}})
    for s in spans:
        events.append({"ph": "X", "cat": "span", "name": s.name,
                       "pid": SPAN_PID, "tid": 0,
                       "ts": (s.start_ns - base) / 1e3,
                       "dur": (s.end_ns - s.start_ns) / 1e3,
                       "args": {"id": s.id, "parent": s.parent,
                                "root": s.root}})
    with open(path, "w") as f:
        json.dump(doc, f)


@contextlib.contextmanager
def trace(log_dir: Optional[str]) -> Iterator[None]:
    """`with trace(log_dir):` profiles the block with `torch.profiler` (CPU
    and, where present, CUDA activity) and writes its trace as
    `<log_dir>/trace.<pid>.<ns>.json`, which Perfetto and chrome://tracing
    read, with the spans recorded during the block in a row of their own.
    No-op when `log_dir` is falsy."""
    if not log_dir:
        yield
        return
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    started = time.time_ns()
    prof.start()
    try:
        yield
    finally:  # a block that raises is traced too
        prof.stop()
        path = os.path.join(log_dir, f"trace.{os.getpid()}.{time.time_ns()}.json")
        prof.export_chrome_trace(path)
        _write_spans(path, [s for s in list(SPANS) if s.end_ns >= started])


class StepTimer:
    """Wall-clock timer that forces completion by fetching a scalar."""

    def __init__(self):
        self.times = []

    @contextlib.contextmanager
    def measure(self, result_fetch=None):
        """Times the block; after it, `result_fetch` (a tensor or array,
        summed, or a scalar) is read back to the host before the clock
        stops, so work queued on the device counts."""
        t0 = time.perf_counter()
        yield
        if isinstance(result_fetch, torch.Tensor):
            float(torch.sum(result_fetch))
        elif hasattr(result_fetch, "shape"):
            float(np.sum(result_fetch))
        elif result_fetch is not None:
            float(result_fetch)
        self.times.append(time.perf_counter() - t0)

    def p50(self) -> float:
        return float(np.median(self.times)) if self.times else float("nan")
