"""The span readers (`perfbench/spans.py`, `metrics/host_step_ms.train.py`,
`host_forward_ms.infer.py`, `idle_in_program_ms.*.py`, `loss_ms.train.py`,
`optimizer_ms.train.py`) against hand-written chrome traces and spans whose
every number is worked out by hand below; and each of them None, without
raising, on a tiny CPU `--trace 1` run and on a program without spans."""

import json
import time

import pytest
import torch

from coma_unet_tpu_torch.utils import profiling
from coma_unet_tpu_torch.utils.profiling import Span
from perfbench import harness, spans
from perfbench.harness import ROOT, Cell, Context, Run, Window, load_module
from perfbench.trace import Trace

BASE = 1_700_000_000_000_000_000          # the trace's baseTimeNanoseconds
NEW = ("host_step_ms.train", "host_forward_ms.infer", "idle_in_program_ms.train",
       "idle_in_program_ms.infer", "loss_ms.train", "optimizer_ms.train")


def _read(name, run):
    return load_module(ROOT / "metrics" / f"{name}.py").read(run)


class _Doc:
    """A chrome trace and the program's spans, times in ms on its clock."""

    def __init__(self, skew=lambda t: 0.0):
        self.events, self.spans, self.corr = [], [], 0
        self.skew = skew     # the device clock's lead on the host's at t, ms

    def record(self, name, at, a, b, cat="kernel", launched=True):
        """A device record on [a, b] launched at `at` (a `cuda_runtime`
        event sharing its correlation), or with no launch record."""
        self.corr += 1
        a, b = a + self.skew(a), b + self.skew(b)
        self.events.append({"ph": "X", "cat": cat, "name": name, "ts": a * 1e3,
                            "dur": (b - a) * 1e3, "args": {"correlation": self.corr}})
        if launched:
            self.launch("cudaLaunchKernel", at, 3e-3)

    def launch(self, name, at, dur):
        self.events.append({"ph": "X", "cat": "cuda_runtime", "name": name,
                            "ts": at * 1e3, "dur": dur * 1e3,
                            "args": {"correlation": self.corr}})

    def marker(self, at, delay=0.5):
        self.record("void spin_kernel(long)", at, at + delay, at + delay + 0.001)

    def span(self, name, a, b, parent=None):
        sid = len(self.spans) + 1
        root = parent.root if parent else sid
        s = Span(name, BASE + int(a * 1e6), BASE + int(b * 1e6),
                 parent.id if parent else 0, root, sid)
        self.spans.append(s)
        return s

    def run(self, cell, seconds, window_units, traced_units, monkeypatch, tmp_path):
        monkeypatch.setenv("TMPDIR", str(tmp_path))
        path = harness.scratch_dir() / f"{cell}.trace.json"
        path.write_text(json.dumps({"baseTimeNanoseconds": BASE,
                                    "traceEvents": self.events}))
        monkeypatch.setattr(profiling, "SPANS", list(self.spans))
        ctx = Context(Cell.load(cell), 1, torch.device("cpu"), 0.0)
        return Run(ctx, Window(window_units, 1.0), Window(traced_units, seconds),
                   None, Trace.read(path, seconds, skip=0), {})


def _train_doc(skew=lambda t: 0.0):
    d = _Doc(skew)
    d.span("train.step", 0, 50)                          # the set-up's last step
    for a, b, fwd in ((100, 180, (102, 130)), (200, 300, (203, 240))):
        step = d.span("train.step", a, b)                # the unprofiled window
        d.span("train.forward", *fwd, parent=step)
    d.marker(1000, delay=0.0)                            # the window's start
    for t0 in (1010, 1150):                              # the traced window
        step = d.span("train.step", t0, t0 + 100)
        for name, a, b in (("train.forward", 2, 30), ("train.loss", 30, 40),
                           ("train.backward", 40, 70), ("train.grad_norm", 70, 75),
                           ("train.optimizer", 75, 90)):
            d.span(name, t0 + a, t0 + b, parent=step)
    # step 1: forward 20, loss 2, backward 20, AdamW 4 between its markers,
    # a memcpy in the step's own code 1, and a kernel without a launch record
    d.record("k_fwd", 1013, 1015, 1035)
    d.record("k_loss", 1041, 1041.5, 1043.5)
    d.record("k_bwd", 1051, 1055, 1075)
    d.marker(1085.5)
    d.record("multi_tensor_apply_kernel", 1087, 1088, 1092)
    d.marker(1099)
    d.record("Memcpy DtoD (Device -> Device)", 1105, 1106, 1107, cat="gpu_memcpy")
    d.record("k_lost", None, 1112, 1113, launched=False)
    # step 2: forward 20, loss 4, backward 20, AdamW 2
    d.record("k_fwd", 1153, 1155, 1175)
    d.record("k_loss", 1181, 1182, 1186)
    d.record("k_bwd", 1191, 1195, 1215)
    d.marker(1225.5)
    d.record("multi_tensor_apply_kernel", 1227, 1228, 1230)
    d.marker(1239)
    # launched outside every span: 1, and 5 of 10 inside the window's end
    d.record("k_out", 1260, 1261, 1262)
    d.record("k_tail", 1290, 1295, 1305)
    d.corr += 1
    d.launch("cudaDeviceSynchronize", 1292, 13)          # returns as k_tail ends
    return d


def test_train_readers_against_the_hand_worked_trace(monkeypatch, tmp_path):
    run = _train_doc().run("contra.train_rnc.128", 0.3, 2, 2, monkeypatch, tmp_path)
    assert run.trace.start == 1000e3 and run.trace.end == 1300e3
    p = spans.phases(run)
    # the unprofiled steps last 80 and 100 ms; the traced ones 100
    assert _read("host_step_ms.train", run) == pytest.approx(90.0)
    assert p.host_unprofiled == pytest.approx(
        {"train.step": 90.0, "train.forward": 32.5, "outside": 10.0})
    assert p.host_traced == pytest.approx(
        {"train.step": 100.0, "train.forward": 28.0, "train.loss": 10.0,
         "train.backward": 30.0, "train.grad_norm": 5.0, "train.optimizer": 15.0,
         "outside": 20.0})
    # device ms a step by the innermost span at launch
    assert p.device_ms == pytest.approx(
        {"train.forward": 20.0, "train.loss": 3.0, "train.backward": 20.0,
         "train.optimizer": 3.0, "train.step": 0.5, "no launch record": 0.5,
         "outside": 3.0})
    assert _read("loss_ms.train", run) == pytest.approx(3.0)
    assert _read("optimizer_ms.train", run) == pytest.approx(3.0)
    assert _read("adamw_ms.train", run) == pytest.approx(3.0)   # the markers' reading
    # the 200 ms of idle time, split gap by gap (the docstring's sums):
    # outside 10+2+37+11+33, step 2+6+3+2+10, forward 3+5+3+5, loss
    # 1.5+6.5+2+4, backward 5+5+5+5, grad norm 5+5, optimizer 3+8+3+10
    assert p.idle_ms == pytest.approx(
        {"outside": 46.5, "train.step": 11.5, "train.forward": 8.0, "train.loss": 7.0,
         "train.backward": 10.0, "train.grad_norm": 5.0, "train.optimizer": 12.0})
    assert sum(p.idle_ms.values()) * 2 == pytest.approx(
        1e3 * (run.trace.window_s - run.trace.busy_s))
    assert _read("idle_in_program_ms.train", run) == pytest.approx(53.5)
    assert (p.total_records, p.no_launch, p.outside, p.in_unit) == (12, 1, 2, 9)
    assert p.lead_us == pytest.approx(-1500.0) and p.early_us == pytest.approx(-500.0)
    assert p.early_raw_us == pytest.approx(-500.0) and p.anchors == 2
    assert p.clock_us == pytest.approx((0.0, 0.0))
    assert p.queued_idle_ms == 0.0
    assert _read("host_forward_ms.infer", run) is None
    assert _read("idle_in_program_ms.infer", run) is None
    (note,) = [n for n in run.ctx.notes if n.startswith("spans,")]
    assert "train.backward | - | 30.000 | 20.000 | 1.0 | 10.000" in note
    assert "without a launch record 1 (8.33 %)" in note


def test_infer_readers_against_the_hand_worked_trace(monkeypatch, tmp_path):
    d = _Doc()
    d.span("infer.forward", 0, 10)                       # the set-up's last request
    d.span("data.to_device", 20, 22)                     # the unprofiled window
    d.span("infer.forward", 22, 52)
    d.marker(1000, delay=0.0)
    for t0, end in ((1005, 1030), (1050, 1080)):
        d.span("data.to_device", t0, t0 + 1)
        d.span("infer.forward", t0 + 1, end)
    d.record("Memcpy HtoD (Pinned -> Device)", 1005.5, 1006, 1007, cat="gpu_memcpy")
    d.record("k", 1007, 1010, 1040)
    d.record("Memcpy DtoH (Device -> Pageable)", 1041, 1041, 1045, cat="gpu_memcpy")
    d.record("Memcpy HtoD (Pinned -> Device)", 1050.5, 1051, 1052, cat="gpu_memcpy")
    d.record("k", 1052, 1055, 1085)
    d.record("Memcpy DtoH (Device -> Pageable)", 1086, 1086, 1090, cat="gpu_memcpy")
    run = d.run("contra.infer.216", 0.1, 1, 2, monkeypatch, tmp_path)
    p = spans.phases(run)
    assert _read("host_forward_ms.infer", run) == pytest.approx(30.0)
    assert p.host_unprofiled == pytest.approx(
        {"data.to_device": 2.0, "infer.forward": 30.0, "outside": 0.0})
    # idle: to_device 1 + 1, forward 3 + 3; outside 5 + 1 + 5 + 1 + 10
    assert p.idle_ms == pytest.approx(
        {"data.to_device": 1.0, "infer.forward": 3.0, "outside": 11.0})
    assert _read("idle_in_program_ms.infer", run) == pytest.approx(4.0)
    assert p.device_ms == pytest.approx(
        {"data.to_device": 1.0, "infer.forward": 30.0, "outside": 4.0})
    assert (p.total_records, p.no_launch, p.outside, p.in_unit) == (6, 0, 2, 2)
    for name in ("host_step_ms.train", "idle_in_program_ms.train", "loss_ms.train",
                 "optimizer_ms.train"):
        assert _read(name, run) is None, name


def test_a_drifting_device_clock_is_mapped_back_onto_the_host_clock(
        monkeypatch, tmp_path):
    """The device clock leads the host's by -0.8 ms at the window's start
    and drifts by 1 us a ms (so `k_loss` of step 1 starts 258.5 us before its
    own launch): the start marker and the final synchronize anchor the
    drift, and the split of the idle time is the one of the true clock."""
    run = _train_doc(lambda t: -0.8 + 1e-3 * (t - 1000)).run(
        "contra.train_rnc.128", 0.3, 2, 2, monkeypatch, tmp_path)
    p = spans.phases(run)
    assert p.early_raw_us == pytest.approx(258.5)
    assert p.early_us == pytest.approx(-500.0) and p.lead_us == pytest.approx(-1500.0)
    assert p.clock_us[0] == pytest.approx(-800.0)
    assert p.idle_ms == pytest.approx(
        {"outside": 46.5, "train.step": 11.5, "train.forward": 8.0, "train.loss": 7.0,
         "train.backward": 10.0, "train.grad_norm": 5.0, "train.optimizer": 12.0})
    # durations stay the device clock's, 1e-3 longer here
    assert _read("loss_ms.train", run) == pytest.approx(3.003)


def test_gaps_before_work_already_launched_are_counted_apart(monkeypatch, tmp_path):
    """A kernel launched during the first (busy) one, so queued when the
    device idles before it: its 2 ms gap is put down to the span open
    across it and counted as queued."""
    d = _Doc()
    d.span("train.step", 100, 200)
    d.span("train.step", 300, 400)
    d.marker(1000, delay=0.0)
    step = d.span("train.step", 1000, 1100)
    d.span("train.backward", 1001, 1050, parent=step)
    d.record("k1", 1002, 1003, 1020)
    d.record("k2", 1004, 1022, 1040)        # launched at 1004, starts at 1022
    d.record("k3", 1060, 1061, 1100)
    run = d.run("contra.train_rnc.128", 0.1, 2, 1, monkeypatch, tmp_path)
    p = spans.phases(run)
    assert p.queued_idle_ms == pytest.approx(2.0)
    # idle: 1000-1001 step, 1001-1003 backward, 1020-1022 backward (queued),
    # 1040-1050 backward, 1050-1061 step
    assert p.idle_ms == pytest.approx({"train.step": 12.0, "train.backward": 14.0})


def test_a_program_without_spans_reads_nothing(monkeypatch, tmp_path):
    run = _train_doc().run("contra.train_rnc.128", 0.3, 2, 2, monkeypatch, tmp_path)
    monkeypatch.delattr(profiling, "SPANS")
    assert all(_read(name, run) is None for name in NEW)
    assert not run.ctx.notes


def test_the_gap_split_covers_each_gap_once():
    d = _Doc()
    outer = d.span("a", 10, 50)
    d.span("b", 20, 30, parent=outer)
    sp = spans._on_clock(d.spans, BASE)
    starts, inner = spans._segments(sp)
    parts = spans._split(starts, inner, 0.0, 100e3)
    assert parts == [("outside", 10e3), ("a", 10e3), ("b", 10e3), ("a", 20e3),
                     ("outside", 50e3)]
    assert spans._split(starts, inner, 22e3, 25e3) == [("b", 3e3)]
    assert spans._split([], [], 1.0, 2.0) == [("outside", 1.0)]


@pytest.mark.parametrize("cell", ["contra.train_rnc.128", "contra.infer.216"])
def test_a_tiny_cpu_run_reads_nothing(cell, tiny, tmp_path, monkeypatch):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    result = harness.run_cell(cell, 2 ** 31 + 5, 0.2, True, torch.device("cpu"),
                              time.perf_counter(), overrides=tiny)
    assert result["correct"]
    assert not set(NEW) & set(result["metrics"])
    assert len(profiling.SPANS) > 0     # the program recorded its spans
