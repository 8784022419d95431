"""A whole run on the CPU at a tiny size, with the timed path broken
underneath: `correct` has to come out false for each fault the cell can
have (a step that leaves its state unchanged; half the batch left out,
the mean taken over the rest; an answer altered where it is produced).
One chip, so no exchange between chips can be left out. The sound run,
in float32 where the program and the reference agree to rounding, comes
out true under the same limits."""

import time

import pytest
import torch

import coma_unet_tpu_torch.infer.sliding_window as sliding_window
from coma_unet_tpu_torch.losses.composite import GenerativeContrastiveLoss
from perfbench import harness
from perfbench.calibrate import half_batch_loss

TRAIN = ("contra.train_rnc.128", "attnunet.train.128")
INFER = "contra.infer.216"
SEED = 2 ** 31 + 3


def _run(cell, tiny):
    return harness.run_cell(cell, SEED, 0.2, False, torch.device("cpu"),
                            time.perf_counter(), overrides=tiny)


@pytest.mark.parametrize("cell", TRAIN + (INFER,))
def test_sound_run_is_correct(cell, tiny):
    result = _run(cell, tiny)
    assert result["correct"], result["checked"]


@pytest.mark.parametrize("cell", TRAIN)
def test_state_left_unchanged_fails(cell, tiny, monkeypatch):
    monkeypatch.setattr(torch.optim.AdamW, "step",
                        lambda self, closure=None: None)
    result = _run(cell, tiny)
    assert not result["correct"], result["checked"]


@pytest.mark.parametrize("cell", TRAIN)
def test_half_the_batch_fails(cell, tiny, monkeypatch):
    # the forward keeps the whole batch; the loss's mean drops half of it
    monkeypatch.setattr(GenerativeContrastiveLoss, "generative",
                        half_batch_loss(GenerativeContrastiveLoss.generative))
    result = _run(cell, tiny)
    assert not result["correct"], result["checked"]
    assert result["checked"]["out_gap"]["value"] < result["checked"]["out_gap"]["limit"]


def _patch_infer(monkeypatch, change):
    apply_model = sliding_window.apply_model

    def broken(model, *args, **kwargs):
        outs = apply_model(model, *args, **kwargs)
        outs.out = change(model, args, kwargs, outs.out)
        return outs

    monkeypatch.setattr(sliding_window, "apply_model", broken)


def test_altered_answer_fails(tiny, monkeypatch):
    # one voxel row off along W, as an indexing slip would give
    _patch_infer(monkeypatch, lambda m, a, k, out: torch.roll(out, 1, dims=-1))
    result = _run(INFER, tiny)
    assert not result["correct"], result["checked"]


def test_half_the_requests_rows_fail(tiny, monkeypatch):
    # the cell's requests hold one volume, as the CLI's loader sends them;
    # the check is held here on requests of two
    tiny = dict(tiny, traffic=dict(tiny["traffic"], batch=2))
    apply_model = sliding_window.apply_model

    def half(model, args, kwargs, out):
        rows = out.shape[0] // 2
        first = apply_model(model, *(x[:rows] for x in args), **kwargs).out
        rest = first.mean(dim=0, keepdim=True).expand((out.shape[0] - rows,) + first.shape[1:])
        return torch.cat([first, rest])

    _patch_infer(monkeypatch, half)
    result = _run(INFER, tiny)
    assert not result["correct"], result["checked"]
