"""Profiling (counterpart of `coma_unet_tpu/utils/profiling.py`): a
`torch.profiler` trace around any stretch of work, written as a
Chrome/Perfetto trace JSON, and a wall-clock step timer that forces the
device to finish before it stops the clock.

    with trace("/tmp/trace"):       # -> /tmp/trace/trace.<pid>.<ns>.json
        run_steps()
    timer = StepTimer()
    with timer.measure(loss):       # float(torch.sum(loss)) before the stop
        loss.add_(step())
    timer.p50()
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import numpy as np
import torch


@contextlib.contextmanager
def trace(log_dir: Optional[str]) -> Iterator[None]:
    """`with trace(log_dir):` profiles the block with `torch.profiler` (CPU
    and, where present, CUDA activity) and writes its trace as
    `<log_dir>/trace.<pid>.<ns>.json`, which Perfetto and chrome://tracing
    read. No-op when `log_dir` is falsy."""
    if not log_dir:
        yield
        return
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield
    finally:  # a block that raises is traced too
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            log_dir, f"trace.{os.getpid()}.{time.time_ns()}.json"))


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
