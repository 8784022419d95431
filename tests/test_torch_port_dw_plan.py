"""KB1's cut (`coma_unet_tpu_torch/ops/conv3d.py:dw_plan`) and the
decomposition that its tensor-core kernel (`csrc/conv3d_dw_tc.cu`)
computes, checked on the CPU, where no kernel runs.

(a) For every KB1 shape of `chip_smoke.py` phase 3 (128^3 and 64^3 at b=2,
    216^3 and 108^3 at b=1, two small ones of odd W) and for ragged shapes, the plan's splits cover
    every position of every sample exactly once and never straddle two
    samples, the grid stays within CUDA's limits and the workspace holds
    one partial dW per split.
(b) A torch emulation of the kernel's decomposition -- per brick, a
    channels-last halo copy with zero fill, the k^3 shifted views, bf16
    operands with f32 sums, then the split partials summed in split order
    -- equals the plain version within 1e-5 of max|plain|, for k = 1 and 3,
    shared and per-sample weights, Cin in {1, 3, 16}, at ragged shapes.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from coma_unet_tpu_torch import ops
from coma_unet_tpu_torch.ops.conv3d import (
    DW_MAX_BRICKS,
    DW_MIN_BRICKS,
    GRID_MAX,
    dw_plan,
)

TOL = 1e-5
RAGGED = [(2, 13, 9, 20), (2, 18, 18, 18), (1, 5, 3, 7)]  # (b, d, h, w)


def _cdiv(a, b):
    return -(-a // b)


def _phase3_shapes():
    """(b, cin, cout, d, h, w, k) of every KB1 case of phase 3."""
    shapes = set()
    for family, _, xshape, wshape, _, _ in chip_smoke._kernel_cases():
        if family == "s1_dw":
            (cout, k), (b, cin, d, h, w) = wshape, xshape
            shapes.add((b, cin, cout, d, h, w, k))
    return sorted(shapes)


PLAN_SHAPES = _phase3_shapes() + [
    (b, cin, cout, d, h, w, k) for b, d, h, w in RAGGED
    for cin, cout in ((1, 32), (3, 16), (16, 5), (40, 33)) for k in (1, 3)]


def test_phase3_shapes_cover_every_kb1_site():
    shapes = _phase3_shapes()
    assert len(shapes) == 25  # the path's 23 sites and two of odd W
    assert {s[3] for s in shapes} >= {128, 64, 216, 108}
    widths = {8 if w % 8 == 0 else 4 if w % 4 == 0 else 1 for *_, w, _ in shapes}
    assert widths == {8, 4, 1}  # every vector width of the loads along W
    assert {s[1] for s in shapes} >= {1, 2, 3, 8, 16, 32, 64, 128}
    assert {s[-1] for s in shapes} == {1, 3}


@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_dw_plan_covers_every_position_once(shape):
    b, cin, cout, d, h, w, k = shape
    plan = dw_plan(b, cin, cout, d, h, w, k)
    assert plan.splits == b * plan.splits_per_sample <= GRID_MAX
    assert plan.workspace == plan.splits * cout * cin * k ** 3
    bd, bh, bw = plan.brick
    assert plan.ct in (16, 32) and plan.at in (8, 16, 32)
    assert plan.grid == (_cdiv(cin, plan.ct), _cdiv(cout, plan.at), plan.splits)
    assert max(plan.grid[1:]) <= GRID_MAX
    nbd, nbh, nbw = _cdiv(d, bd), _cdiv(h, bh), _cdiv(w, bw)
    assert plan.bricks == nbd * nbh * nbw
    assert plan.positions == plan.bps * bd * bh * bw
    assert DW_MIN_BRICKS <= plan.bps <= max(DW_MAX_BRICKS, _cdiv(plan.bricks * b, GRID_MAX))
    # split s takes bricks [s % sps * bps, + bps) of sample s // sps, as the
    # kernel walks them: the runs of one sample tile its bricks, none empty
    sps, bps = plan.splits_per_sample, plan.bps
    starts = np.arange(sps) * bps
    stops = np.minimum(starts + bps, plan.bricks)
    assert (stops > starts).all() and stops[-1] == plan.bricks
    assert (starts[1:] == stops[:-1]).all() and starts[0] == 0
    # brick bi's origin, as the kernel computes it, visits each brick of the
    # grid once, and the bricks' boxes (clipped to the volume) tile each axis
    bi = np.arange(plan.bricks)
    org = np.stack([bi // (nbh * nbw), bi // nbw % nbh, bi % nbw], axis=1)
    assert len({tuple(o) for o in org}) == plan.bricks
    assert (org.max(axis=0) == [nbd - 1, nbh - 1, nbw - 1]).all()
    for n, extent in ((bd, d), (bh, h), (bw, w)):
        starts_ax = np.arange(_cdiv(extent, n)) * n
        cover = np.zeros(extent, np.int64)
        for s0 in starts_ax:
            cover[s0:min(s0 + n, extent)] += 1
        assert (cover == 1).all()
    if d * h * w <= 20000:  # every position of every sample, enumerated
        seen = np.zeros((b, d, h, w), np.int64)
        for s in range(plan.splits):
            n = s // sps
            for i in range(starts[s % sps], stops[s % sps]):
                d0, h0, w0 = org[i] * (bd, bh, bw)
                seen[n, d0:d0 + bd, h0:h0 + bh, w0:w0 + bw] += 1
        assert (seen == 1).all()


def test_dw_plan_keeps_the_grid_within_limits_at_large_batch():
    plan = dw_plan(64, 32, 32, 216, 216, 216, 3)
    assert plan.splits <= GRID_MAX
    assert plan.splits_per_sample * plan.bps >= plan.bricks


def _emulate_tc(x, g, k, per_sample, plan):
    """The tensor-core kernel's decomposition of dW, in torch on the CPU."""
    b, cin, d, h, w = x.shape
    cout = g.shape[1]
    r, taps = k // 2, k ** 3
    bd, bh, bw = plan.brick
    nbh, nbw = _cdiv(h, bh), _cdiv(w, bw)
    channels = plan.grid[0] * plan.ct  # channel tiles, zero past Cin
    xb, gb = x.bfloat16().float(), g.bfloat16().float()
    partial = torch.zeros(plan.splits, cout, cin, taps)
    for s in range(plan.splits):
        n = s // plan.splits_per_sample
        first = s % plan.splits_per_sample * plan.bps
        for i in range(first, min(first + plan.bps, plan.bricks)):
            d0, h0, w0 = i // (nbh * nbw) * bd, i // nbw % nbh * bh, i % nbw * bw
            # channels-last halo brick, zero outside the volume
            halo = torch.zeros(bd + 2 * r, bh + 2 * r, bw + 2 * r, channels)
            lo = (max(d0 - r, 0), max(h0 - r, 0), max(w0 - r, 0))
            hi = (min(d0 + bd + r, d), min(h0 + bh + r, h), min(w0 + bw + r, w))
            at = [lo[j] - (o - r) for j, o in enumerate((d0, h0, w0))]
            halo[at[0]:at[0] + hi[0] - lo[0], at[1]:at[1] + hi[1] - lo[1],
                 at[2]:at[2] + hi[2] - lo[2], :cin] = xb[
                     n, :, lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]].permute(1, 2, 3, 0)
            tile = torch.zeros(cout, bd, bh, bw)  # G, zero past the volume
            part = gb[n, :, d0:d0 + bd, h0:h0 + bh, w0:w0 + bw]
            tile[:, :part.shape[1], :part.shape[2], :part.shape[3]] = part
            tile = tile.reshape(cout, -1)
            for t in range(taps):
                td, th, tw = t // (k * k), t // k % k, t % k
                view = halo[td:td + bd, th:th + bh, tw:tw + bw].reshape(-1, channels)
                partial[s, :, :, t] += tile @ view[:, :cin]
    # the second launch: partials summed in split order
    groups = partial.reshape(b if per_sample else 1, -1, cout, cin, taps)
    out = groups[:, 0].clone()
    for j in range(1, groups.shape[1]):
        out += groups[:, j]
    out = out.reshape(out.shape[:3] + (k, k, k))
    return out if per_sample else out[0]


@pytest.mark.parametrize("shape", RAGGED[:2], ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("cin", [1, 3, 16])
@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("per_sample", [False, True])
def test_tc_decomposition_matches_plain(shape, cin, k, per_sample):
    b, d, h, w = shape
    cout = 5
    rng = np.random.default_rng(cin * 10 + k)
    x = torch.from_numpy(rng.uniform(-1, 1, (b, cin, d, h, w)).astype(np.float32))
    g = torch.from_numpy(rng.uniform(-1, 1, (b, cout, d, h, w)).astype(np.float32))
    x, g = x.bfloat16().float(), g.bfloat16().float()
    plan = dw_plan(b, cin, cout, d, h, w, k)
    assert plan.splits_per_sample > 1  # the split-order sum is exercised
    got = _emulate_tc(x, g, k, per_sample, plan)
    want = ops.conv3d_s1_dw_plain(x, g, k, per_sample)
    assert got.shape == want.shape
    assert float((got - want).abs().max() / want.abs().max()) < TOL
