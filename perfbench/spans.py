"""The program's spans (`coma_unet_tpu_torch.utils.profiling.SPANS`) on the
traced window's clock, for the per-layer readers that read them.

A span is stamped with `time.time_ns()`; the chrome trace that
`trace.traced` writes gives each event's `ts` in microseconds after its
`baseTimeNanoseconds`, on the same clock, for the launch records
(`cuda_runtime` or `cuda_driver` events sharing a device record's
`correlation`). Each device record of the traced window (kernel, memcpy,
memset; the marker kernels left out, as `Trace.read` does) is put down to
the innermost span open at the host time of its launch. That goes by time,
not by thread: the backward's launches come from autograd's device thread
while `train.backward` is open on the caller's. The device records' own
times drift against the host's clock in the trace (`_clock`), so each idle
gap of the window (`Trace.idle_gaps`) is first mapped onto the host's
clock, then split over the innermost span open across each part of it;
the parts that no span covers are "outside". A gap that ends with work
launched before it began waited on the device, not on the host: its time
is also summed apart.

The unit of a cell is its `train.step` or `infer.forward` span. The
unprofiled window is the one `harness.run_cell` runs with `--trace 1`
before the traced one, with the profiler off and the spans recording: its
units are the last `run.window.units` unit spans that close before the
traced window's start, its spans those that close after the unit span
before them. The traced window's units are the first `run.traced.units`
unit spans that open after its start.

`phases(run)` computes all of it once a run and notes one table; it is
None where the window holds nothing to read: no device record (a CPU run),
no trace clock, or a program without spans.
"""

from __future__ import annotations

import bisect
import json
import re
from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from perfbench.harness import Run, scratch_dir
from perfbench.trace import DEVICE_CATS, MARKER

UNITS = ("train.step", "infer.forward")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
WAITED_US = 100.0    # a synchronize or copy call this long waited for the device
SYNC_COPY = re.compile(r"DtoH.*Pageable")   # a copy the host waits for
OUTSIDE = "outside"
NO_LAUNCH = "no launch record"


@dataclass
class Phases:
    """What the spans give of one traced run, each "a unit" divided by
    the window's units; dicts keyed by span name, `OUTSIDE` and, for the
    device, `NO_LAUNCH`."""
    unit: str                           # "train.step" or "infer.forward"
    unit_host_ms: float                 # mean host ms of the unprofiled units
    host_unprofiled: Dict[str, float]   # host ms a unit
    host_traced: Dict[str, float]
    device_ms: Dict[str, float]         # device ms a unit launched inside
    records: Dict[str, float]           # device records a unit launched inside
    idle_ms: Dict[str, float]           # idle ms a unit while innermost
    queued_idle_ms: float               # idle a unit before work already launched
    total_records: int
    no_launch: int                      # records without a launch record
    outside: int                        # records launched outside every span
    in_unit: int                        # records launched inside a unit's tree
    clock_us: Tuple[float, float]       # device clock's lead at the window's ends
    anchors: int                        # the clock's anchors (`_clock`)
    early_raw_us: float                 # most a record starts before its launch
    early_us: float                     # the same on the corrected clock
    lead_us: float                      # most a record starts before its span

    @property
    def idle_in_program_ms(self) -> float:
        return sum(v for k, v in self.idle_ms.items() if k != OUTSIDE)


@dataclass
class _Span:
    name: str
    a: float            # us on the trace's clock
    b: float
    root_name: str
    depth: int


_last: Optional[Tuple[Run, Optional[Phases]]] = None


def phases(run: Run) -> Optional[Phases]:
    """The run's `Phases` (None where there is nothing to read), computed
    and noted once a run."""
    global _last
    if _last is None or _last[0] is not run:
        found = _compute(run)
        if found is not None:
            run.ctx.note(table(found))
        _last = (run, found)
    return _last[1]


def _program_spans():
    from coma_unet_tpu_torch.utils import profiling

    return list(getattr(profiling, "SPANS", ()))


def _compute(run: Run) -> Optional[Phases]:
    trace = run.trace
    if not trace.device or run.traced.units == 0:
        return None
    records = _program_spans()
    if not records:
        return None
    with open(scratch_dir() / f"{run.ctx.cell.name}.trace.json") as f:
        doc = json.load(f)
    base = doc.get("baseTimeNanoseconds")
    if base is None:
        return None
    spans = _on_clock(records, base)
    unit = next((u for u in UNITS if any(s.name == u for s in spans)), None)
    if unit is None:
        return None
    units = [s for s in spans if s.name == unit]
    before = [s for s in units if s.b < trace.start][-run.window.units:]
    after = [s for s in units if s.a >= trace.start][:run.traced.units]
    if not before or not after:
        return None
    prior = [s for s in units if s.b < before[0].a]
    lo = prior[-1].b if prior else float("-inf")
    host_unprofiled = _host(spans, lo, before[-1].b, len(before))
    host_traced = _host(spans, before[-1].b, after[-1].b, len(after))

    starts, inner = _segments([s for s in spans if s.b >= before[-1].b])
    launches, waits = {}, []
    for e in doc["traceEvents"]:
        if e.get("ph") == "X" and e.get("cat") in LAUNCH_CATS:
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launches.setdefault(corr, float(e["ts"]))
            if "Synchronize" in e["name"] or "Memcpy" in e["name"]:
                waits.append((float(e["ts"]), float(e.get("dur", 0.0)), corr))
    device = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), e["name"],
               launches.get((e.get("args") or {}).get("correlation")),
               (e.get("args") or {}).get("correlation"))
              for e in doc["traceEvents"]
              if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    lag, anchors = _clock(device, waits, trace.start)
    device_ms: Dict[str, float] = defaultdict(float)
    counts: Dict[str, int] = defaultdict(int)
    launched_at: Dict[float, float] = {}
    total = in_unit = 0
    lead = early = early_raw = float("-inf")
    for a, b, name, launch, _ in device:
        if MARKER in name or b <= trace.start or a >= trace.end:
            continue
        total += 1
        if launch is None:
            key = NO_LAUNCH
        else:
            at, begins = launch, max(a, trace.start)
            launched_at[begins] = max(launched_at.get(begins, at), at)
            early_raw = max(early_raw, at - a)
            early = max(early, at - (a - lag(a)))
            s = _innermost(starts, inner, at)
            if s is None:
                key = OUTSIDE
            else:
                key = s.name
                lead = max(lead, s.a - (a - lag(a)))
                in_unit += s.root_name == unit
        device_ms[key] += (min(b, trace.end) - max(a, trace.start)) / 1e3
        counts[key] += 1
    idle: Dict[str, float] = defaultdict(float)
    queued = 0.0
    for a, b, _ in trace.idle_gaps():
        ha, hb = a - lag(a), b - lag(b)
        for name, us in _split(starts, inner, ha, hb):
            idle[name] += us / 1e3
        if launched_at.get(b, float("inf")) <= ha:
            queued += (b - a) / 1e3
    n = run.traced.units
    return Phases(
        unit=unit,
        unit_host_ms=sum(s.b - s.a for s in before) / 1e3 / len(before),
        host_unprofiled=host_unprofiled, host_traced=host_traced,
        device_ms={k: v / n for k, v in device_ms.items()},
        records={k: v / n for k, v in counts.items()},
        idle_ms={k: v / n for k, v in idle.items()},
        queued_idle_ms=queued / n,
        total_records=total, no_launch=counts.get(NO_LAUNCH, 0),
        outside=counts.get(OUTSIDE, 0), in_unit=in_unit,
        clock_us=(lag(trace.start), lag(trace.end)), anchors=anchors,
        early_raw_us=early_raw, early_us=early, lead_us=lead)


def _clock(device, waits, start: float):
    """How far the device's clock runs ahead of the host's in the trace,
    at a device time t (us): piecewise linear between anchors, constant
    beyond them; and the number of anchors.

    The profiler maps each clock onto the trace on its own, and on an H100
    the device's can stand milliseconds off the host's and drift against
    it by hundreds of microseconds over a window of a second, so that
    records start before their own launch. The anchors are moments
    whose times are known on both clocks: the window's start marker,
    launched onto an idle device after a synchronize, starts as it is
    launched; a synchronize that waited returns as the last device work
    launched before it ends, and a copy to pageable host memory as the
    copy ends."""
    found: Dict[float, float] = {}       # device time -> the device's lead
    by_corr = {c: (b, name) for a, b, name, launch, c in device}
    marker = next((d for d in device if MARKER in d[2] and d[0] == start), None)
    if marker is not None and marker[3] is not None:
        found[marker[0]] = marker[0] - marker[3]
    ends = sorted((launch, b) for a, b, _, launch, _ in device if launch is not None)
    times, last = [], []
    for at, b in ends:
        times.append(at)
        last.append(max(b, last[-1]) if last else b)
    first = min(found, default=start)
    for ts, dur, corr in waits:
        if dur < WAITED_US:
            continue
        if corr in by_corr:                              # a copy that waited
            end, name = by_corr[corr]
            if not SYNC_COPY.search(name):
                continue
        else:                                            # a synchronize
            i = bisect.bisect_right(times, ts)
            if i == 0:
                continue
            end = last[i - 1]
        if end >= first:
            found.setdefault(end, end - (ts + dur))
    points = sorted(found.items())

    def lag(t: float) -> float:
        if not points:
            return 0.0
        i = bisect.bisect_right(points, (t, float("inf")))
        if i == 0:
            return points[0][1]
        if i == len(points):
            return points[-1][1]
        (t0, e0), (t1, e1) = points[i - 1], points[i]
        return e0 + (e1 - e0) * (t - t0) / (t1 - t0)

    return lag, len(points)


def _on_clock(records, base: int) -> List[_Span]:
    """The program's spans in microseconds on the trace's clock, with
    their root's name and their depth (0 for a root)."""
    by_id = {r.id: r for r in records}

    def chain(r):
        depth = 0
        while r.parent in by_id:
            r, depth = by_id[r.parent], depth + 1
        return r, depth

    out = []
    for r in records:
        top, depth = chain(r)
        out.append(_Span(r.name, (r.start_ns - base) / 1e3,
                         (r.end_ns - base) / 1e3, top.name, depth))
    return sorted(out, key=lambda s: s.a)


def _host(spans: List[_Span], lo: float, hi: float, units: int) -> Dict[str, float]:
    """Host ms a unit of the spans that close in (lo, hi], by name; under
    `OUTSIDE` the time between the first of them and `hi` that no root
    span covers."""
    inside = [s for s in spans if lo < s.b <= hi]
    out: Dict[str, float] = defaultdict(float)
    for s in inside:
        out[s.name] += (s.b - s.a) / 1e3 / units
    first = min(s.a for s in inside)
    covered, t = 0.0, first
    for s in inside:
        if s.depth == 0 and s.b > t:
            covered += s.b - max(s.a, t)
            t = s.b
    out[OUTSIDE] = max(0.0, hi - first - covered) / 1e3 / units
    return dict(out)


def _segments(spans: List[_Span]):
    """The time line cut at every span's start and end: each piece's
    start, and the innermost span open over it (the deepest; of equals,
    the latest to open), or None."""
    cuts = sorted({t for s in spans for t in (s.a, s.b)})
    starts, inner = [], []
    opens = sorted(spans, key=lambda s: s.a)
    active: List[_Span] = []
    i = 0
    for lo, hi in zip(cuts, cuts[1:]):
        while i < len(opens) and opens[i].a <= lo:
            active.append(opens[i])
            i += 1
        active = [s for s in active if s.b >= hi]
        starts.append(lo)
        inner.append(max(active, key=lambda s: (s.depth, s.a)) if active else None)
    if cuts:
        starts.append(cuts[-1])
        inner.append(None)
    return starts, inner


def _innermost(starts, inner, t: float) -> Optional[_Span]:
    i = bisect.bisect_right(starts, t) - 1
    return inner[i] if i >= 0 else None


def _split(starts, inner, a: float, b: float) -> List[Tuple[str, float]]:
    """(name, us) parts of [a, b] by the innermost span over each."""
    out = []
    t, i = a, bisect.bisect_right(starts, a) - 1   # -1: before every span
    while t < b:
        end = min(b, starts[i + 1]) if i + 1 < len(starts) else b
        s = inner[i] if i >= 0 else None
        out.append((s.name if s else OUTSIDE, end - t))
        t, i = end, i + 1
    return out


def table(p: Phases) -> str:
    """The note: for each span name, "outside" and the records without a
    launch record, host ms a unit (unprofiled, traced), device ms and
    records a unit launched while it was the innermost span, and idle ms a
    unit while it was."""
    names = sorted(set(p.host_unprofiled) | set(p.host_traced) | set(p.device_ms)
                   | set(p.idle_ms),
                   key=lambda k: (k in (OUTSIDE, NO_LAUNCH), k == NO_LAUNCH, k))

    def cell(d, k, fmt="{:.3f}"):
        return fmt.format(d[k]) if k in d else "-"

    lines = [f"spans, a {p.unit} (ms a unit; device, records and idle by the "
             f"innermost span open at launch): name | host unprofiled | "
             f"host traced | device | records | idle"]
    for k in names:
        lines.append(f"  {k} | {cell(p.host_unprofiled, k)} | {cell(p.host_traced, k)}"
                     f" | {cell(p.device_ms, k)} | {cell(p.records, k, '{:.1f}')}"
                     f" | {cell(p.idle_ms, k)}")
    n = max(1, p.total_records)
    lines.append(
        f"  records {p.total_records}: without a launch record {p.no_launch}"
        f" ({100.0 * p.no_launch / n:.2f} %), launched outside every span"
        f" {p.outside} ({100.0 * p.outside / n:.2f} %), inside a {p.unit}"
        f" {p.in_unit} ({100.0 * p.in_unit / n:.2f} %);"
        f" the device clock leads the host's by {p.clock_us[0]:.1f} us at the window's"
        f" start and {p.clock_us[1]:.1f} us at its end ({p.anchors} anchors), on which a"
        f" record starts at most {p.early_raw_us:.1f} us before its own launch, and"
        f" once corrected at most {p.early_us:.1f} us before its launch and"
        f" {p.lead_us:.1f} us before its span's host start; idle in program spans"
        f" {p.idle_in_program_ms:.3f} ms a unit, in gaps before work already launched"
        f" {p.queued_idle_ms:.3f} ms a unit")
    return "\n".join(lines)
