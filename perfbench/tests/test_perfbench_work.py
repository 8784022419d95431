"""The work counts: one conv's operations against a count by hand, and the
conv record of a whole step against `FlopCounterMode`'s conv operations."""

import dataclasses

import pytest
import torch
import torch.nn.functional as F
from torch.utils.flop_counter import FlopCounterMode

from coma_unet_tpu_torch import LossConfig, ModelConfig
from perfbench.reference import work
from perfbench.reference.work import _ConvRecorder

aten = torch.ops.aten


def _record(fn):
    rec = _ConvRecorder(element=2)
    with rec:
        fn()
    return rec.convs


def test_one_conv_by_hand():
    x = torch.empty(2, 4, 8, 8, 8, device="meta")
    w = torch.empty(6, 4, 3, 3, 3, device="meta")
    (conv,) = _record(lambda: F.conv3d(x, w, padding=1))
    # every output voxel of every sample: Cout x Cin x 27 multiply-adds
    assert conv.flops == 2 * 2 * 8 ** 3 * 6 * 4 * 27
    assert conv.bytes == 2 * (x.numel() + w.numel() + 2 * 6 * 8 ** 3)


def test_strided_and_transposed_convs_by_hand():
    x = torch.empty(1, 4, 8, 8, 8, device="meta")
    w = torch.empty(6, 4, 3, 3, 3, device="meta")
    (down,) = _record(lambda: F.conv3d(x, w, stride=2, padding=1))
    assert down.flops == 2 * 4 ** 3 * 6 * 4 * 27
    wt = torch.empty(4, 6, 3, 3, 3, device="meta")   # [Cin, Cout, k, k, k]
    (up,) = _record(lambda: F.conv_transpose3d(x, wt, stride=2, padding=1,
                                               output_padding=1))
    # each input voxel meets every tap of every (Cin, Cout) pair
    assert up.flops == 2 * 8 ** 3 * 4 * 6 * 27


def test_backward_counts_both_gradients():
    x = torch.empty(2, 4, 8, 8, 8, device="meta", requires_grad=True)
    w = torch.empty(6, 4, 3, 3, 3, device="meta", requires_grad=True)

    def step():
        F.conv3d(x, w, padding=1).sum().backward()

    fwd, bwd = _record(step)
    assert bwd.flops == 2 * fwd.flops


def test_grouped_weight_gradient_counts_each_group_once():
    # the per-sample expert convs are one conv grouped over the batch
    x = torch.empty(1, 8, 8, 8, 8, device="meta", requires_grad=True)
    w = torch.empty(12, 4, 3, 3, 3, device="meta", requires_grad=True)

    def step():
        F.conv3d(x, w, padding=1, groups=2).sum().backward()

    fwd, bwd = _record(step)
    assert fwd.flops == 2 * 8 ** 3 * 12 * 4 * 27
    assert bwd.flops == 2 * fwd.flops


@pytest.mark.parametrize("model_type", ["ContraAttnUNET", "AttnUNET"])
@pytest.mark.parametrize("train", [True, False])
def test_conv_record_matches_flop_counter(model_type, train):
    cfg = dataclasses.asdict(ModelConfig(
        channels=(4, 8, 16), strides=(2, 2, 2), latent_spaces=(32,) * 3,
        prompt_shape=(16, 16, 16), num_experts=4))
    lcfg = dataclasses.asdict(LossConfig())
    got = work.count(model_type, cfg, lcfg, 2, 16, 5, train, 2)
    # the same step again under FlopCounterMode alone, conv ops only
    counter = FlopCounterMode(display=False)
    with counter:
        work.count(model_type, cfg, lcfg, 2, 16, 5, train, 2)
    counts = counter.get_flop_counts()["Global"]
    fwd = counts.get(aten.convolution, 0)
    bwd = counts.get(aten.convolution_backward, 0)
    recorded = got.conv_flops
    if train:
        # FlopCounterMode counts the grouped (per-sample) weight gradients
        # `groups` = 2 times, so its backward reads more than the record's
        assert fwd + bwd > recorded > fwd
    else:
        assert recorded == pytest.approx(fwd, rel=1e-12)
    assert got.flops == pytest.approx(
        counter.get_total_flops() - fwd - bwd + recorded, rel=1e-12)
    assert got.flops >= recorded > 0
