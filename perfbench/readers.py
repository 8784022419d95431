"""What the per-layer readers (`metrics/<name>.py`) share: the kernel
classes (`metrics/kernel_classes.json`) and the arithmetic of a share of
the chip's peak, of a roofline and of the device's idle time. A reader
returns None where its window holds nothing to read."""

from __future__ import annotations

import re
from functools import lru_cache
from typing import Dict, List, Optional

from perfbench.harness import ROOT, Run, load_json
from perfbench.reference.work import peak_rates


@lru_cache(maxsize=1)
def classes() -> Dict[str, List[re.Pattern]]:
    raw = load_json(ROOT / "metrics" / "kernel_classes.json")["classes"]
    return {k: [re.compile(p) for p in v] for k, v in raw.items()}


def class_of(name: str, cat: str) -> Optional[str]:
    if cat != "kernel":
        return "memcpy" if cat == "gpu_memcpy" else "memset"
    for cls, patterns in classes().items():
        if any(p.search(name) for p in patterns):
            return cls
    return None


def mfu(run: Run) -> Optional[float]:
    """The reference's operations of the untraced window's units over that
    window's time on the host clock at the chip's peak rate, in %."""
    if run.window.units == 0 or run.window.seconds <= 0.0:
        return None
    flops_per_s, _ = peak_rates(run.ctx)
    return 100.0 * run.work.flops * run.window.units / (
        run.window.seconds * flops_per_s)


def conv_roofline(run: Run) -> Optional[float]:
    """The least time of the window's conv work (`Work.conv_least_s`) over
    the device time of the kernels classed as conv, in %."""
    spent = run.trace.device_seconds_where(lambda n, c: class_of(n, c) == "conv")
    if spent <= 0.0:
        return None
    least = run.work.conv_least_s(*peak_rates(run.ctx)) * run.traced.units
    return 100.0 * least / spent


def device_idle(run: Run) -> Optional[float]:
    """The share of the traced window in which no kernel, memcpy or
    memset ran, in %."""
    if run.trace.busy_s <= 0.0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)


def report(run: Run) -> None:
    """Notes for the traced run: the device time no class matched, and the
    profiler's records of each kernel family against the launches the
    program counted (`ops._build.LAUNCHES`)."""
    trace, ctx = run.trace, run.ctx
    loose: Dict[str, float] = {}
    for a, b, name, cat in trace.device:
        if class_of(name, cat) is None:
            loose[name] = loose.get(name, 0.0) + (b - a) / 1e6
    total = sum(loose.values())
    top = sorted(loose.items(), key=lambda kv: -kv[1])[:5]
    ctx.note(f"unclassified kernel time {total:.6f} s of {trace.busy_s:.6f} s busy"
             + "".join(f"; {s:.6f} s {n[:80]}" for n, s in top))
    families = load_json(ROOT / "metrics" / "kernel_classes.json")["families"]
    seconds = trace.kernel_seconds()
    parts = []
    for family, kernel in families.items():
        launched = (run.launches or {}).get(family, 0)
        records = seconds.get(kernel, (0.0, 0))[1]
        if launched or records:
            parts.append(f"{family} {records} records of {launched} launches")
    ctx.note("profiler records against launches: " + ("; ".join(parts) or "none"))
