"""KB2's cut (`coma_unet_tpu_torch/ops/conv3d_strided.py:sdw_plan`) and the
decomposition that its tensor-core kernel (`csrc/conv3d_dw_s2_tc.cu`)
computes, checked on the CPU, where no kernel runs.

(a) For every KB2 shape of `chip_smoke.py` phase 3 (both roles at 128^3 b=2
    and 216^3 b=1, and the odd sizes off the path) and for ragged and odd
    shapes, the plan's splits cover every half-resolution position of every
    sample exactly once and never straddle two samples, the grid stays
    within CUDA's limits and the workspace holds one partial M per split.
(b) A torch emulation of the kernel's decomposition -- per brick of half
    positions, the stride-2 halo box of `full` with zero fill, stored split
    by parity per axis, the per-tap unit-stride views of it at the kernel's
    closed-form offsets, the `half` tile zero past the volume, bf16
    operands with f32 sums, then the split partials summed in split order
    -- equals the plain version on the f32 upcast within 1e-5 of
    max|plain|, shared and per sample, and in both roles gives autograd's
    weight gradient: of the stride-2 conv (full = x, half = g) and, with
    the channel swap and tap flip, of the transposed conv (full = g,
    half = x). It also equals the Pallas kernel it replaces (interpret
    mode).
(c) The parity-split index's closed forms for the dW tap mapping
    2p + t - 1 are checked against the split they stand for.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
import coma_unet_tpu.ops.pallas.conv3d_strided as strided  # noqa: E402
from coma_unet_tpu_torch import ops  # noqa: E402
from coma_unet_tpu_torch.ops.conv3d import GRID_MAX  # noqa: E402
from coma_unet_tpu_torch.ops.conv3d_strided import (  # noqa: E402
    SDW_AT,
    SDW_BRICK,
    SDW_CT,
    SDW_MAX_BRICKS,
    SDW_MIN_BRICKS,
    conv_transpose3d_ref,
    sdw_plan,
)

TOL = 1e-5
RAGGED = [(2, 9, 13, 40), (2, 6, 10, 34), (1, 7, 7, 7), (3, 17, 4, 65)]  # (b, d, h, w) of full


def _cdiv(a, b):
    return -(-a // b)


def _half(n):
    return (n - 1) // 2 + 1


def _phase3_shapes():
    """(b, cf, cp, d, h, w, per_sample) of every KB2 case of phase 3."""
    return [(x[0], x[1], half[1]) + tuple(x[2:]) + (bool(ps),)
            for family, _, x, half, ps, _ in chip_smoke._kernel_cases()
            if family == "strided_dw"]


PLAN_SHAPES = [s[:-1] for s in _phase3_shapes()] + [
    (b, cf, cp, d, h, w) for b, d, h, w in RAGGED
    for cf, cp in ((1, 8), (3, 5), (20, 40), (32, 64), (40, 130))]


def test_phase3_shapes_cover_every_kb2_site():
    shapes = _phase3_shapes()
    # both roles at 128^3 b=2 and 216^3 b=1, per sample, and the odd sizes
    assert len(shapes) == 5
    assert [s[3] for s in shapes] == [128, 128, 216, 216, 27]
    assert all(s[1:3] == (32, 64) and s[-1] for s in shapes[:4])
    assert shapes[4] == (2, 24, 40, 27, 18, 45, False)
    plans = [sdw_plan(*s[:-1]) for s in shapes]
    # one tile of half's channels, two of full's; about one block an SM
    assert {p.grid[:2] for p in plans} == {(2, 1)}
    assert [p.grid[2] for p in plans[:4]] == [66] * 4
    assert [p.bps for p in plans[:4]] == [63, 63, 155, 155]
    assert [p.bricks for p in plans[:4]] == [32 * 16 * 4] * 2 + [54 * 27 * 7] * 2
    assert plans[4].splits_per_sample > 1  # the odd case sums split partials


@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_sdw_plan_covers_every_half_position_once(shape):
    b, cf, cp, d, h, w = shape
    plan = sdw_plan(b, cf, cp, d, h, w)
    assert plan.brick == SDW_BRICK and (plan.ct, plan.at) == (SDW_CT, SDW_AT)
    assert plan.splits == b * plan.splits_per_sample <= GRID_MAX
    assert plan.grid == (_cdiv(cf, SDW_CT), _cdiv(cp, SDW_AT), plan.splits)
    assert max(plan.grid) <= GRID_MAX
    assert plan.workspace == plan.splits * cp * cf * 27
    dh, hh, wh = _half(d), _half(h), _half(w)
    bd, bh, bw = plan.brick
    nbd, nbh, nbw = _cdiv(dh, bd), _cdiv(hh, bh), _cdiv(wh, bw)
    assert plan.bricks == nbd * nbh * nbw
    assert plan.positions == plan.bps * bd * bh * bw
    assert SDW_MIN_BRICKS <= plan.bps <= SDW_MAX_BRICKS
    # split s takes bricks [s % sps * bps, + bps) of sample s // sps, as the
    # kernel walks them (w fastest): every half position of every sample once
    sps, bps = plan.splits_per_sample, plan.bps
    seen = np.zeros((b, nbd * bd, nbh * bh, nbw * bw), np.int64)
    for s in range(plan.splits):
        n, first = s // sps, s % sps * bps
        run = range(first, min(first + bps, plan.bricks))
        assert len(run) > 0
        for i in run:
            d0, h0, w0 = i // (nbh * nbw) * bd, i // nbw % nbh * bh, i % nbw * bw
            seen[n, d0:d0 + bd, h0:h0 + bh, w0:w0 + bw] += 1
    assert (seen == 1).all()
    assert seen[:, :dh, :hh, :wh].sum() == b * dh * hh * wh


def test_sdw_plan_keeps_the_grid_within_limits_at_large_batch():
    plan = sdw_plan(64, 32, 64, 216, 216, 216)
    assert plan.splits <= GRID_MAX and plan.bps <= SDW_MAX_BRICKS
    big = sdw_plan(16, 16, 8, 1000, 1000, 1000)
    assert big.splits <= GRID_MAX and big.splits_per_sample * big.bps >= big.bricks


def _split(j, n):
    """Where box position j (0 <= j <= 2n) along an axis of n half positions
    is stored: its n + 1 even positions first, then its n odd ones."""
    return j // 2 if j % 2 == 0 else n + 1 + j // 2


def _shift(s, n):
    """The kernel's closed form (tc_common.cuh:shift): tap offset s of half
    position q reads box position 2q + s, stored at q + _shift(s, n)."""
    return (0, n + 1, 1)[s]


def test_parity_split_closed_forms():
    bd, bh, bw = SDW_BRICK
    for n in SDW_BRICK:
        order = list(range(0, 2 * n + 1, 2)) + list(range(1, 2 * n + 1, 2))
        assert [_split(j, n) for j in order] == list(range(2 * n + 1))
        for q in range(n):
            for s in range(3):
                assert _split(2 * q + s, n) == q + _shift(s, n)
    # the dW tap mapping: half position q0 + q of a brick whose box starts at
    # full position 2 q0 - 1 reads full 2 (q0 + q) + s - 1 = box position 2q + s
    for q0 in (0, 16, 48):
        for q in range(bw):
            for s in range(3):
                assert (2 * q0 - 1) + (2 * q + s) == 2 * (q0 + q) + s - 1
    # the kernel's row of brick row (dd, hh) at tap (td, th, tw): warp (td, th)
    # passes shift(td, BD) and shift(th, BH), kw tap tw adds kwoff = shift(tw, BW)
    hh_, hw_ = 2 * bh + 1, 2 * bw + 1
    for dd in range(bd):
        for hh in range(bh):
            for td in range(3):
                for th in range(3):
                    for tw in range(3):
                        row = (((dd + _shift(td, bd)) * hh_ + hh + _shift(th, bh)) * hw_
                               + _shift(tw, bw))
                        want = ((_split(2 * dd + td, bd) * hh_ + _split(2 * hh + th, bh))
                                * hw_ + _split(tw, bw))
                        assert row == want
    assert [_shift(tw, bw) for tw in range(3)] == [0, 17, 1]


def _emulate_tc(full, half, per_sample, plan):
    """The tensor-core kernel's decomposition of M, in torch on the CPU."""
    b, cf, d, h, w = full.shape
    cp = half.shape[1]
    dh, hh, wh = half.shape[2:]
    bd, bh, bw = plan.brick
    nbh, nbw = _cdiv(hh, bh), _cdiv(wh, bw)
    cpad, apad = plan.grid[0] * plan.ct, plan.grid[1] * plan.at  # zero past Cf, Cp
    fb, gb = full.bfloat16().float(), half.bfloat16().float()
    orders = [torch.tensor(list(range(0, 2 * n + 1, 2)) + list(range(1, 2 * n + 1, 2)))
              for n in plan.brick]
    partial = torch.zeros(plan.splits, apad, cpad, 27)
    for s in range(plan.splits):
        n = s // plan.splits_per_sample
        first = s % plan.splits_per_sample * plan.bps
        for i in range(first, min(first + plan.bps, plan.bricks)):
            q0 = (i // (nbh * nbw) * bd, i // nbw % nbh * bh, i % nbw * bw)
            # the stride-2 halo box of full, channels-last, zero outside the volume
            box = torch.zeros(2 * bd + 1, 2 * bh + 1, 2 * bw + 1, cpad)
            org = [2 * q - 1 for q in q0]
            lo = [max(o, 0) for o in org]
            hi = [min(o + 2 * e + 1, m) for o, e, m in zip(org, plan.brick, (d, h, w))]
            if all(a < z for a, z in zip(lo, hi)):
                box[lo[0] - org[0]:hi[0] - org[0], lo[1] - org[1]:hi[1] - org[1],
                    lo[2] - org[2]:hi[2] - org[2], :cf] = fb[
                        n, :, lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]].permute(1, 2, 3, 0)
            # stored split by parity along each axis
            for axis, order in enumerate(orders):
                box = box.index_select(axis, order)
            # the half tile [Cp][positions], zero past the volume
            tile = torch.zeros(apad, bd, bh, bw)
            part = gb[n, :, q0[0]:q0[0] + bd, q0[1]:q0[1] + bh, q0[2]:q0[2] + bw]
            tile[:cp, :part.shape[1], :part.shape[2], :part.shape[3]] = part
            tile = tile.reshape(apad, -1)
            for t in range(27):
                td, th, tw = t // 9, t // 3 % 3, t % 3
                sd, sh, sw = _shift(td, bd), _shift(th, bh), _shift(tw, bw)
                view = box[sd:sd + bd, sh:sh + bh, sw:sw + bw].reshape(-1, cpad)
                partial[s, :, :, t] += tile @ view
    # the second launch: partials summed in split order
    groups = partial.reshape(b if per_sample else 1, -1, apad, cpad, 27)
    out = groups[:, 0].clone()
    for j in range(1, groups.shape[1]):
        out += groups[:, j]
    out = out[:, :cp, :cf].reshape(-1, cp, cf, 3, 3, 3)
    return out if per_sample else out[0]


def _data(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.uniform(-1, 1, s).astype(np.float32)).bfloat16().float()
            for s in shapes]


def _rel(got, want):
    assert got.shape == want.shape, (got.shape, want.shape)
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("shape", [RAGGED[0], RAGGED[3]], ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("cf,cp", [(3, 5), (20, 40)])
@pytest.mark.parametrize("per_sample", [False, True])
def test_tc_decomposition_matches_plain(shape, cf, cp, per_sample):
    b, d, h, w = shape
    full, half = _data(cf * 10 + d, (b, cf, d, h, w), (b, cp, _half(d), _half(h), _half(w)))
    plan = sdw_plan(b, cf, cp, d, h, w)
    assert plan.splits_per_sample > 1  # the split-order sum is exercised
    got = _emulate_tc(full, half, per_sample, plan)
    want = ops.conv3d_strided_dw_plain(full, half, per_sample)
    assert _rel(got, want) < TOL


@pytest.mark.parametrize("role", ["s2", "t2"])
@pytest.mark.parametrize("per_sample", [False, True])
def test_tc_decomposition_is_each_roles_weight_gradient(role, per_sample):
    # even sizes, so the transposed conv maps half [4, 5, 17] back to full
    b, c_lo, c_hi, size = 2, 6, 17, (8, 10, 34)
    hsize = tuple(n // 2 for n in size)
    cin, cout = (c_lo, c_hi) if role == "s2" else (c_hi, c_lo)
    wshape = ((b,) if per_sample else ()) + (cout, cin, 3, 3, 3)
    if role == "s2":  # y = conv_s2(x, w): full = x [b, cin, size], half = g [b, cout, hsize]
        x, wt, g = _data(3, (b, cin) + size, wshape, (b, cout) + hsize)
        fwd, full, half = ops.conv3d_s2_plain, x, g
    else:  # y = conv_t2(x, w): full = g [b, cout, size], half = x [b, cin, hsize]
        x, wt, g = _data(4, (b, cin) + hsize, wshape, (b, cout) + size)
        fwd, full, half = conv_transpose3d_ref, g, x
    wr = wt.clone().requires_grad_(True)
    (want,) = torch.autograd.grad(fwd(x, wr), wr, g)
    plan = sdw_plan(b, full.shape[1], half.shape[1], *size)
    assert plan.splits_per_sample > 1
    m = _emulate_tc(full, half, per_sample, plan)
    got = m if role == "s2" else torch.flip(m.transpose(-5, -4), dims=(-3, -2, -1))
    assert _rel(got, want) < TOL


def test_tc_decomposition_matches_pallas():
    full, half = _data(5, (2, 4, 8, 8, 8), (2, 3, 4, 4, 4))
    want = strided._dw_v2(jnp.asarray(full.numpy()), strided.pack_w(jnp.asarray(half.numpy())),
                          interpret=True)  # [27, Cp, Cf]
    want = torch.from_numpy(np.moveaxis(np.array(want), 0, -1).reshape(3, 4, 3, 3, 3))
    got = _emulate_tc(full, half, False, sdw_plan(2, 4, 3, 8, 8, 8))
    assert _rel(got, want) < TOL
