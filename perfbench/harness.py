"""Runs one cell of `BENCHMARK.json`: set-up, a measured window, the
check against the plain reference, and the result line.

Everything a cell is made of is found by name:
  configs/<config>.json     the model configuration
  traffic/<traffic>.json    the traffic mix's parameters, naming its generator
  traffic/<generator>.py    the generator: setup, window, end_to_end, check
  workloads/<cell>.json     the limits that decide `correct`
  metrics/<metric>.py       one reader per per-layer metric
so a cell, a mix or a metric is added by adding files.

`run_cell` takes the device as an argument, so that the CPU tests drive a
whole run at a tiny size; `run.py` refuses to run without the card.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List, Optional

import torch

from perfbench.reference.compare import failures

ROOT = Path(__file__).resolve().parent          # perfbench/
CHECKOUT = ROOT.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "coma_unet_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path) -> ModuleType:
    """A generator or reader by its file path (names may hold dots)."""
    name = "perfbench_" + path.stem.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's, flax's, optax's or
    the JAX package's, compared whole."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


@dataclass
class Window:
    """What a measured window did: `units` steps or requests completed
    over `seconds` of host clock (ending in a synchronize);
    `latencies` per request in seconds, where the generator times them."""
    units: int
    seconds: float
    latencies: Optional[List[float]] = None


@dataclass
class Cell:
    name: str
    spec: dict                      # the cell's entry in BENCHMARK.json
    config: dict                    # configs/<config>.json
    traffic: dict                   # traffic/<traffic>.json
    limits: Dict[str, float]        # workloads/<cell>.json
    bench: dict

    @classmethod
    def load(cls, name: str, overrides: Optional[dict] = None) -> "Cell":
        """The cell `name`; `overrides` (tests only) replaces keys of the
        configuration's `model` and of the traffic."""
        bench = load_json(CHECKOUT / "BENCHMARK.json")
        spec = next(w for w in bench["workloads"] if w["name"] == name)
        entry = next(c for c in bench["configs"] if c["name"] == spec["config"])
        config = load_json(CHECKOUT / entry["file"])
        traffic = load_json(ROOT / "traffic" / f"{spec['traffic']}.json")
        limits = load_json(ROOT / "workloads" / f"{name}.json")["limits"]
        if overrides:
            config = dict(config, model=dict(config["model"],
                                             **overrides.get("model", {})))
            traffic = dict(traffic, **overrides.get("traffic", {}))
        return cls(name, spec, config, traffic, limits, bench)

    def end_to_end(self) -> List[dict]:
        return [m for m in self.bench["end_to_end"]
                if self.name in m.get("workloads", [self.name])]

    def per_layer(self) -> List[dict]:
        return [m for m in self.bench["per_layer"]
                if self.name in m.get("workloads", [self.name])]


@dataclass
class Context:
    """What a generator and a reader see of the run."""
    cell: Cell
    seed: int
    device: torch.device
    started: float                  # time.perf_counter() at process start
    peaks: dict = field(default_factory=lambda: load_json(ROOT / "peaks.json"))
    notes: List[str] = field(default_factory=list)
    tracing: bool = False           # a traced window is running

    @property
    def traffic(self) -> dict:
        return self.cell.traffic

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def model_config(self) -> dict:
        """The program's `ModelConfig` fields: the configuration's, with
        the compute dtype and the volume (the modulator's prompt shape)
        that the traffic sets."""
        cfg = dict(self.cell.config["model"])
        size = self.traffic["volume"]
        cfg["prompt_shape"] = [size, size, size]
        cfg["compute_dtype"] = self.traffic.get("compute_dtype",
                                                cfg["compute_dtype"])
        return cfg

    def loss_config(self) -> dict:
        return dict(self.cell.config["loss"], **self.traffic.get("loss", {}))

    def note(self, text: str) -> None:
        """A line for standard error, printed before the result."""
        self.notes.append(text)


@dataclass
class Run:
    """What the per-layer readers read: a window timed on the host clock
    alone (`window`), then one of as many units under the profiler
    (`traced`, `trace`), which stretches the host's part of each unit."""
    ctx: Context
    window: Window
    traced: Window
    work: Any                       # reference/work.py:Work of one unit
    trace: Any                      # trace.py:Trace of the traced window
    launches: Dict[str, int]


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device: torch.device, started: float,
             overrides: Optional[dict] = None) -> dict:
    """One run of the cell: the result object of the contract, plus
    `notes` (lines for standard error)."""
    cell = Cell.load(name, overrides=overrides)
    ctx = Context(cell, int(seed), torch.device(device), started)
    generator = load_module(ROOT / "traffic" / f"{cell.traffic['generator']}.py")
    state = generator.setup(ctx)
    ctx.sync()
    setup_s = time.perf_counter() - started
    setup_peak = _peak(ctx)
    _reset_peak(ctx)
    if trace:
        from perfbench import trace as tracing
        from coma_unet_tpu_torch.ops import LAUNCHES

        units = ctx.traffic["trace_units"]
        window = generator.window(ctx, state, units=units)
        before = dict(LAUNCHES)
        traced, trace_obj = tracing.traced(
            ctx, lambda: generator.window(ctx, state, units=units))
        launches = {k: v - before.get(k, 0) for k, v in LAUNCHES.items()
                    if v - before.get(k, 0)}
    else:
        window = generator.window(ctx, state, seconds=seconds)
    window_peak = _peak(ctx)
    metrics: Dict[str, dict] = {}
    if trace:
        from perfbench import readers
        from perfbench.reference.work import count_work

        run = Run(ctx, window, traced, count_work(ctx), trace_obj, launches)
        readers.report(run)
        for m in cell.per_layer():
            value = load_module(ROOT / "metrics" / f"{m['name']}.py").read(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = generator.end_to_end(ctx, state, window)
        values["setup_s"] = setup_s
        values["peak_mem_gib"] = window_peak / 2 ** 30
        for m in cell.end_to_end():
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    readings = generator.check(ctx, state)
    failed = failures(readings, cell.limits)
    device_info = _device(ctx, max(setup_peak, window_peak))
    if trace:
        device_info["busy_s"] = trace_obj.busy_s
        device_info["window_s"] = trace_obj.window_s
    result = {
        "correct": failed == 0,
        "attempted": window.units + (traced.units if trace else 0),
        "failed": failed,
        "metrics": metrics,
        "device": device_info,
    }
    if trace:
        result["breakdown"] = trace_obj.breakdown()
    result["checked"] = {k: {"value": _number(readings.get(k)), "limit": limit}
                         for k, limit in cell.limits.items()}
    result["notes"] = ctx.notes
    return result


def _number(value):
    """A reading for the result line: a finite number, else its name."""
    if value is None:
        return "missing"
    return value if math.isfinite(value) else str(value)


def _peak(ctx: Context) -> int:
    if ctx.device.type != "cuda":
        return 0
    return torch.cuda.max_memory_allocated(ctx.device)


def _reset_peak(ctx: Context) -> None:
    if ctx.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(ctx.device)


def _device(ctx: Context, peak: int) -> dict:
    if ctx.device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": peak}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(ctx.device),
            "count": ctx.cell.spec["chips"], "memory_peak_bytes": peak}


def scratch_dir() -> Path:
    """Where a run writes what it leaves (the traced window's chrome
    trace): a fixed directory under the run's TMPDIR, or inside the
    checkout where none is set."""
    tmp = os.environ.get("TMPDIR")
    path = Path(tmp) / "perfbench" if tmp else CHECKOUT / "build" / "perfbench"
    path.mkdir(parents=True, exist_ok=True)
    return path
