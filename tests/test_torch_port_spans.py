"""The port's spans (`coma_unet_tpu_torch.utils.profiling.span`): where the
train step, the synthesis forward and the copy to the device record them,
how they nest, the bounded ring that holds them, and the exporter that
writes them into a chrome trace on its clock. On the CPU at the end-to-end
test's shapes (B = 2, 16^3, channels (4, 8, 16), 4 experts, f32); nothing
here asserts a duration."""

import json
import os
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import record_function

from coma_unet_tpu_torch import ContraAttnUNet, utils
from coma_unet_tpu_torch.config import LossConfig, ModelConfig
from coma_unet_tpu_torch.data.pipeline import batch_to_device
from coma_unet_tpu_torch.infer.sliding_window import make_infer_fn
from coma_unet_tpu_torch.train import make_optimizer, make_train_step
from coma_unet_tpu_torch.utils import profiling
from coma_unet_tpu_torch.utils.profiling import SPANS, Span, span, trace

B, S, R = 2, 16, 5
CFG = ModelConfig(channels=(4, 8, 16), strides=(2, 2, 2), latent_spaces=(32,) * 3,
                  prompt_shape=(S, S, S), num_experts=4, compute_dtype="float32")
ARGS = ("mri", "covars", "roi_loc", "roi_std", "roi_compact")
STEP_PHASES = ("train.forward", "train.loss", "train.backward",
               "train.grad_norm", "train.optimizer")


def _batch(seed, triplet=False):
    rng = np.random.default_rng(seed)

    def covars():
        c = rng.normal(size=(B, CFG.num_covars)).astype(np.float32)
        c[:, 0] = [1.0, 0.0]
        return torch.from_numpy(c)

    batch = {
        "mri": torch.from_numpy(rng.uniform(size=(B, 1, S, S, S)).astype(np.float32)),
        "covars": covars(),
        "roi_loc": torch.from_numpy(rng.uniform(0.5, 2.0, (B, R)).astype(np.float32)),
        "roi_std": torch.from_numpy(rng.uniform(0.0, 0.5, (B, R)).astype(np.float32)),
        "roi_compact": torch.from_numpy(rng.integers(0, R + 1, (B, S, S, S)).astype(np.int32)),
        "tau": torch.from_numpy(rng.uniform(0.0, 2.0, (B, 1, S, S, S)).astype(np.float32)),
    }
    if triplet:
        for p in ("pos_", "neg_"):
            batch[p + "mri"] = batch["mri"].flip(0).contiguous()
            batch[p + "covars"] = covars()
            for k in ("roi_loc", "roi_std", "roi_compact"):
                batch[p + k] = batch[k]
    return batch


@pytest.fixture(scope="module")
def model():
    torch.manual_seed(0)
    return ContraAttnUNet(CFG, device="cpu")


def _recorded(run):
    """The spans `run()` records, oldest first."""
    SPANS.clear()
    run()
    return list(SPANS)


def _one_step(model, loss_config, batch):
    step = make_train_step(model, loss_config,
                           make_optimizer(model.parameters(), 1e-3))
    return _recorded(lambda: step(batch, torch.full((R,), 225.0)))


def test_rnc_step_records_its_phases_under_one_root(model):
    spans = _one_step(model, LossConfig(), _batch(0))
    (step,) = [s for s in spans if s.name == "train.step"]
    assert step.parent == 0 and step.root == step.id
    inner = [s for s in spans if s is not step]
    assert sorted({s.name for s in inner}) == sorted(STEP_PHASES)
    for s in inner:
        assert s.parent == step.id and s.root == step.id, s
        assert step.start_ns <= s.start_ns <= s.end_ns <= step.end_ns, s
    # in program order, each closing before the next opens
    inner.sort(key=lambda s: s.start_ns)
    assert [s.name for s in inner] == ["train.forward", "train.loss", "train.loss",
                                       "train.backward", "train.grad_norm",
                                       "train.optimizer"]
    assert all(a.end_ns <= b.start_ns for a, b in zip(inner, inner[1:]))
    assert len({s.id for s in spans}) == len(spans)


def test_tcds_step_records_three_forwards(model):
    cfg = LossConfig(rnc=False, reg_weight=0.1, cds_weights=(0.0, 1.0, 4.0))
    spans = _one_step(model, cfg, _batch(1, triplet=True))
    (step,) = [s for s in spans if s.name == "train.step"]
    forwards = [s for s in spans if s.name == "train.forward"]
    assert len(forwards) == 3
    assert all(s.parent == step.id and s.root == step.id for s in forwards)
    assert [s.name for s in spans].count("train.loss") == 2


def test_infer_and_copy_in_record_their_spans(model):
    infer = make_infer_fn(model)
    batch = _batch(2)

    def request():
        moved = batch_to_device(dict(batch, sample_ids=["a", "b"]), torch.device("cpu"))
        assert "sample_ids" not in moved
        return infer(*(moved[k] for k in ARGS))

    spans = _recorded(request)
    assert [s.name for s in spans] == ["data.to_device", "infer.forward"]
    copy, forward = spans
    assert copy.parent == forward.parent == 0
    assert copy.root == copy.id and forward.root == forward.id
    assert copy.end_ns <= forward.start_ns


def test_ring_drops_its_oldest_records():
    SPANS.clear()
    n = profiling.SPAN_RING + 10
    for i in range(n):
        with span(f"s{i}"):
            pass
    assert SPANS.maxlen == profiling.SPAN_RING and len(SPANS) == profiling.SPAN_RING
    assert SPANS[0].name == "s10" and SPANS[-1].name == f"s{n - 1}"
    SPANS.clear()


def test_a_raising_block_is_recorded_and_leaves_the_stack_empty():
    SPANS.clear()
    with pytest.raises(ValueError, match="boom"):
        with span("outer"):
            with span("inner"):
                raise ValueError("boom")
    assert [s.name for s in SPANS] == ["inner", "outer"]
    inner, outer = SPANS
    assert inner.parent == outer.id and inner.root == outer.id
    assert profiling._open.stack == []
    with span("after"):
        pass
    assert SPANS[-1].parent == 0 and SPANS[-1].root == SPANS[-1].id


def test_nesting_is_per_thread():
    SPANS.clear()
    seen = {}

    def worker():
        with span("thread"):
            pass
        seen["span"] = SPANS[-1]

    with span("main"):
        t = threading.Thread(target=worker)
        t.start()
        t.join(timeout=10)
    assert not t.is_alive()
    assert seen["span"].parent == 0 and seen["span"].root == seen["span"].id


def test_time_ns_is_the_clock(monkeypatch):
    ticks = iter([1_000, 5_000])
    monkeypatch.setattr(profiling.time, "time_ns", lambda: next(ticks))
    SPANS.clear()
    with span("clocked"):
        pass
    assert SPANS[-1][:3] == ("clocked", 1_000, 5_000)
    assert isinstance(SPANS[-1], Span)


def test_exports():
    assert utils.span is span and utils.SPANS is SPANS


def test_trace_writes_the_spans_on_its_clock(tmp_path):
    """An exported span agrees within 1 ms with a `record_function` entered
    at the same moment in the same profile."""
    SPANS.clear()
    with span("before"):
        pass
    with trace(str(tmp_path)):
        with span("phase"), record_function("probe"):
            torch.nn.functional.conv3d(torch.ones(1, 1, 6, 6, 6), torch.ones(2, 1, 3, 3, 3))
        with span("later"):
            time.sleep(0.002)
    (name,) = os.listdir(tmp_path)
    doc = json.loads((tmp_path / name).read_text())
    events = doc["traceEvents"]
    ours = [e for e in events if e.get("cat") == "span"]
    assert [e["name"] for e in ours] == ["phase", "later"]
    assert {(e["pid"], e["tid"]) for e in ours} == {(profiling.SPAN_PID, 0)}
    assert any(e.get("ph") == "M" and e.get("pid") == profiling.SPAN_PID
               and e["args"]["name"] == "program spans" for e in events)
    (probe,) = [e for e in events if e.get("name") == "probe" and e.get("ph") == "X"]
    phase = ours[0]
    assert abs(phase["ts"] - probe["ts"]) < 1e3          # microseconds
    assert abs(phase["dur"] - probe["dur"]) < 1e3
    later = ours[1]
    assert later["dur"] >= 2e3 and later["ts"] >= phase["ts"] + phase["dur"]
    rec = SPANS[-1]
    assert later["ts"] == (rec.start_ns - doc["baseTimeNanoseconds"]) / 1e3
