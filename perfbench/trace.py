"""The traced window: `torch.profiler` with the CUDA activity alone around
the generator's window, its chrome trace written under the run's TMPDIR
(`harness.scratch_dir`) and read back into device intervals.

The profiler records no host operations: on one H100, recording every
PyTorch op on the host stretched a 128^3 train step from 81 ms to 147 ms
and left the device idle half of the window. The benchmark marks its places
on the device's own timeline instead, with marker kernels (`mark`: a spin
kernel of one cycle): one at the window's start, and a pair around each
call into a layer that a reader times (the optimizer's step). The window is
the generator's own, from its start marker for the seconds that the
generator measured on the host clock, a window that ends with a
synchronize, so it holds all of its device work. Time on the device is the union of the kernel, memcpy
and memset intervals inside it, the markers left out.
"""

from __future__ import annotations

import json
import re
from collections import defaultdict
from dataclasses import dataclass
from typing import Callable, Dict, List, Tuple

import torch

from perfbench.harness import Context, scratch_dir

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
MARKER = "spin_kernel"
SPINS = 16   # spin kernels before the window: a profile can miss the
             # first kernels of a process's first profiled call


def mark(ctx: Context) -> None:
    """A marker kernel on the device's timeline, while a window is traced."""
    if ctx.tracing and ctx.device.type == "cuda":
        torch.cuda._sleep(1)


def traced(ctx: Context, window: Callable):
    """Run `window()` (which returns a `harness.Window`) under the
    profiler; (its result, the Trace)."""
    from torch.profiler import ProfilerActivity, profile

    cuda = ctx.device.type == "cuda"
    activity = ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU
    with profile(activities=[activity]) as prof:
        if cuda:
            for _ in range(SPINS):
                torch.cuda._sleep(1000)
        ctx.sync()
        ctx.tracing = True
        try:
            mark(ctx)
            result = window()
        finally:
            ctx.tracing = False
    path = scratch_dir() / f"{ctx.cell.name}.trace.json"
    prof.export_chrome_trace(str(path))
    trace = Trace.read(path, result.seconds, skip=SPINS if cuda else 0)
    ctx.note(f"trace: {path} ({path.stat().st_size / 2 ** 20:.1f} MiB)")
    return result, trace


def short_name(name: str) -> str:
    """A kernel's name without namespaces, template arguments and
    parameters."""
    name = name.replace("(anonymous namespace)::", "")
    base = re.split(r"[<(]", name, maxsplit=1)[0].strip()
    return (base.split()[-1] if base else name).split("::")[-1] or name


@dataclass
class Trace:
    start: float                                  # us
    end: float
    device: List[Tuple[float, float, str, str]]   # (ts, end, name, cat)
    marked: List[Tuple[float, float]]             # between marker pairs
    busy_intervals: List[Tuple[float, float]]

    @classmethod
    def read(cls, path, seconds: float, skip: int) -> "Trace":
        """The window of `seconds` from its start marker, the first marker
        after the `skip` warm-up spins (without any: the first device
        event)."""
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        spans = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)),
                        e["name"], e["cat"]) for e in events
                       if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS)
        markers = [s for s in spans if MARKER in s[2]]
        work = [s for s in spans if MARKER not in s[2]]
        if len(markers) > skip:
            start = markers[skip][0]
            pairs = markers[skip + 1:]
        else:
            start = work[0][0] if work else 0.0
            pairs = []
        end = start + seconds * 1e6
        device = [(max(a, start), min(b, end), n, c) for a, b, n, c in work
                  if b > start and a < end]
        marked = [(pairs[i][1], pairs[i + 1][0])
                  for i in range(0, len(pairs) - 1, 2)]
        return cls(start, end, device, marked,
                   _union([(a, b) for a, b, _, _ in device]))

    @property
    def window_s(self) -> float:
        return (self.end - self.start) / 1e6

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals) / 1e6

    def kernel_seconds(self) -> Dict[str, Tuple[float, int]]:
        """Device seconds and records by short kernel name (memcpy and
        memset by their own names)."""
        out: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
        for a, b, name, cat in self.device:
            key = short_name(name) if cat == "kernel" else name
            out[key][0] += (b - a) / 1e6
            out[key][1] += 1
        return {k: (v[0], int(v[1])) for k, v in out.items()}

    def device_seconds_where(self, keep: Callable[[str, str], bool]) -> float:
        return sum(b - a for a, b, name, cat in self.device
                   if keep(name, cat)) / 1e6

    def device_seconds_marked(self) -> float:
        """Device seconds of the work that starts between a pair of
        markers: the marked layer's own."""
        total, i = 0.0, 0
        for a, b, _, _ in self.device:
            while i < len(self.marked) and self.marked[i][1] < a:
                i += 1
            if i < len(self.marked) and self.marked[i][0] <= a:
                total += b - a
        return total / 1e6

    def idle_gaps(self) -> List[Tuple[float, float, str]]:
        """(start, end, the device operation that ended the gap, or "" for
        the gap that the window's end closes)."""
        gaps, t = [], self.start
        ops = iter(sorted(self.device))
        for a, b in self.busy_intervals:
            if a > t:
                nxt = next((n for s, _, n, _ in ops if s >= a), "")
                gaps.append((t, a, nxt))
            t = max(t, b)
        if self.end > t:
            gaps.append((t, self.end, ""))
        return gaps

    def breakdown(self) -> dict:
        """The device operations that took the most time, and the idle
        gaps summed by the operation whose launch each gap waited for."""
        ops = sorted(self.kernel_seconds().items(), key=lambda kv: -kv[1][0])
        gaps: Dict[str, float] = defaultdict(float)
        for a, b, nxt in self.idle_gaps():
            gaps["before " + short_name(nxt) if nxt else "at the window's end"] += (b - a) / 1e6
        top_gaps = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[k, v[0]] for k, v in ops[:10]],
                "idle_gaps": [[k, v] for k, v in top_gaps]}


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out
