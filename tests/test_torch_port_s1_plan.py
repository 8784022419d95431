"""K1's plan (`coma_unet_tpu_torch/ops/conv3d.py:s1_plan`) and the
decomposition that its tensor-core kernel (`csrc/conv3d_s1_tc.cu`)
computes, checked on the CPU, where no kernel runs.

(a) For every K1 shape of `chip_smoke.py` phase 3 (the forward sites at
    128^3 and 64^3 at b=2, 216^3 and 108^3 at b=1, `conv3d_w64`, and the
    input-gradient shapes) and for ragged shapes, the plan's blocks cover
    every output position of every sample and every output channel exactly
    once, the grid stays within CUDA's limits, and the plan takes the tiles
    that PERF.md lists: AT = 8, 16, 32 or 64 output channels, bricks of
    8 x 4 x 16 at k = 3 with AT = 32 and of 4 x 4 x 16 otherwise.
(b) A torch emulation of the tensor-core kernel's decomposition -- per
    brick, a channels-last halo copy with zero fill, the k^3 shifted views,
    the packed weights zero past Cout and Cin, bf16 operands with f32 sums
    over 16-channel chunks, then the bias -- equals the plain version on the
    f32 upcast within 1e-5 of max|plain|, for k = 1 and 3, shared and
    per-sample weights, Cin in {1, 3, 16, 40}; and in the input-gradient
    role (the cotangent through `flip_t(w)`) it equals autograd's input
    gradient of `conv3d_ref`. The weight packing's index arithmetic, which
    reads `flip_t(w)` from w in place for the input gradient, gives the
    packed copy of `flip_t(w)`.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from coma_unet_tpu_torch import ops
from coma_unet_tpu_torch.ops.conv3d import (
    GRID_MAX,
    S1_BH,
    S1_BW,
    S1_CT,
    conv3d_ref,
    flip_t,
    s1_plan,
)

TOL = 1e-5
RAGGED = [(2, 13, 9, 20), (2, 18, 18, 18), (1, 5, 3, 7)]  # (b, d, h, w)


def _cdiv(a, b):
    return -(-a // b)


def _phase3_shapes():
    """(b, cin, cout, d, h, w, k, per_sample) of every K1 case of phase 3,
    as the kernel sees it (for an input gradient: Cout -> Cin)."""
    shapes = set()
    for family, _, xshape, wshape, extra, entry in chip_smoke._kernel_cases():
        if family == "s1":
            b, cin, d, h, w = xshape
            cout = wshape[1] if entry == "dx" else wshape[0]
            shapes.add((b, cin, cout, d, h, w, wshape[-1], bool(extra)))
    return sorted(shapes)


PLAN_SHAPES = _phase3_shapes() + [
    (b, cin, cout, d, h, w, k, ps) for b, d, h, w in RAGGED
    for cin, cout in ((1, 32), (3, 16), (16, 5), (40, 33), (64, 128)) for k in (1, 3)
    for ps in (False, True)]


def test_phase3_shapes_cover_every_k1_site():
    shapes = _phase3_shapes()
    # 23 forward sites, conv3d_w64 and 9 input gradients, of which those of
    # head.conv1 and down0.conv1 (32->32, 64->64 per sample) at both sizes
    # share their forward shapes; and the depth-sharded 216^3 forward's
    # slabs and 3-plane windows of head.conv1 and down0.conv1
    assert len(shapes) == 33 - 4 + 5
    assert {s[3] for s in shapes} >= {128, 64, 216, 108, 112, 104, 52, 3}
    assert {s[-2] for s in shapes} == {1, 3}
    # every output-channel tile and both brick depths
    plans = [s1_plan(*s) for s in shapes]
    assert {p.at for p in plans} == {8, 16, 32, 64}
    assert {p.brick[0] for p in plans} == {4, 8}
    # the input gradients of the four wide sites at both sizes, and a narrow one
    assert {(s[1], s[2]) for s in shapes} >= {(32, 64), (64, 128), (32, 32), (64, 64), (1, 16)}


def _axis_cover(n, extent):
    cover = np.zeros(extent, np.int64)
    for s0 in range(0, extent, n):
        cover[s0:min(s0 + n, extent)] += 1
    return cover


@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_s1_plan_covers_every_output_once(shape):
    b, cin, cout, d, h, w, k, ps = shape
    plan = s1_plan(b, cin, cout, d, h, w, k, ps)
    assert all(0 < g <= GRID_MAX for g in plan.grid)
    seen = np.zeros((b, d, h, w), np.int64) if b * d * h * w <= 40000 else None
    bd, bh, bw = plan.brick
    assert plan.ct == S1_CT and plan.at in (8, 16, 32, 64)
    assert plan.brick == (8 if k == 3 and plan.at == 32 else 4, S1_BH, S1_BW)
    nbd, nbh, nbw = _cdiv(d, bd), _cdiv(h, bh), _cdiv(w, bw)
    assert plan.bricks == nbd * nbh * nbw
    gx, tiles, gz = plan.grid
    assert gz == b and gx == min(plan.bricks, GRID_MAX)
    # output channels: tiles of at, the last one ragged, none empty
    assert tiles * plan.at >= cout > (tiles - 1) * plan.at
    assert plan.wpack == ((b if ps else 1) * tiles * _cdiv(cin, S1_CT) * k ** 3
                          * plan.at * S1_CT)
    # block x walks bricks x, x + gx, ...: every brick once
    walked = np.concatenate([np.arange(x, plan.bricks, gx) for x in range(gx)])
    assert np.array_equal(np.sort(walked), np.arange(plan.bricks))
    # brick bi's origin, as the kernel computes it: each brick of the grid
    # once, and the bricks' boxes (clipped) tile each axis
    org = np.stack([walked // (nbh * nbw), walked // nbw % nbh, walked % nbw], axis=1)
    assert len({tuple(o) for o in org}) == plan.bricks
    assert (org.max(axis=0) == [nbd - 1, nbh - 1, nbw - 1]).all()
    for n, extent in ((bd, d), (bh, h), (bw, w)):
        assert (_axis_cover(n, extent) == 1).all()
    if seen is not None:
        for n in range(gz):
            for d0, h0, w0 in org * (bd, bh, bw):
                seen[n, d0:d0 + bd, h0:h0 + bh, w0:w0 + bw] += 1
    if seen is not None:
        assert (seen == 1).all()


def test_s1_plan_keeps_the_grid_within_limits_for_large_volumes():
    plan = s1_plan(64, 64, 64, 256, 256, 256, 3)
    assert plan.bricks > GRID_MAX and plan.grid == (GRID_MAX, 1, 64)
    assert s1_plan(1, 128, 64, 216, 216, 216, 3).grid == (40824, 1, 1)
    assert s1_plan(1, 64, 32, 216, 216, 216, 3).grid == (27 * 54 * 14, 1, 1)
    assert s1_plan(1, 16, 16, 216, 216, 216, 3).grid == (40824, 1, 1)
    assert s1_plan(2, 1, 1, 128, 128, 128, 3).grid == (8192, 1, 2)


def test_s1_plan_pads_the_narrow_layers():
    # fusion_layer.conv0 2->8 and the modulator conv2's input gradient 1->16
    # at 128^3: one 16-channel chunk, mostly zeros, and one output tile
    fusion = s1_plan(2, 2, 8, 128, 128, 128, 3)
    assert (fusion.at, fusion.brick, fusion.grid) == (8, (4, 4, 16), (8192, 1, 2))
    assert fusion.wpack == 27 * 8 * 16
    dx = s1_plan(2, 1, 16, 128, 128, 128, 3)
    assert (dx.at, dx.wpack) == (16, 27 * 16 * 16)
    # k = 1: one tap; per-sample weights pack each sample's own
    reduce = s1_plan(2, 32, 1, 128, 128, 128, 1, True)
    assert (reduce.at, reduce.wpack) == (8, 2 * 2 * 8 * 16)


def _emulate_tc(x, w, bias, plan):
    """The tensor-core kernel's decomposition of K1, in torch on the CPU."""
    b, cin, d, h, wd = x.shape
    per_sample = w.dim() == 6
    cout, k = w.shape[-5], w.shape[-1]
    r, taps = k // 2, k ** 3
    bd, bh, bw = plan.brick
    ct, at = plan.ct, plan.at
    gx, tiles, _ = plan.grid
    nch = _cdiv(cin, ct)
    xb = x.bfloat16().float()
    # the packed weights: [B?][Cout tiles x at][Cin chunks x ct][taps], zero
    # past Cout and Cin
    wb = w.bfloat16().float().reshape((-1, cout, cin, taps))
    packed = torch.zeros(wb.shape[0], tiles * at, nch * ct, taps)
    packed[:, :cout, :cin] = wb
    nbh, nbw = _cdiv(h, bh), _cdiv(wd, bw)
    y = torch.zeros(b, cout, d, h, wd)
    for n in range(b):
        for bi in (i for x0 in range(gx) for i in range(x0, plan.bricks, gx)):
            d0, h0, w0 = bi // (nbh * nbw) * bd, bi // nbw % nbh * bh, bi % nbw * bw
            # channels-last halo brick, zero outside the volume
            halo = torch.zeros(bd + 2 * r, bh + 2 * r, bw + 2 * r, nch * ct)
            lo = (max(d0 - r, 0), max(h0 - r, 0), max(w0 - r, 0))
            hi = (min(d0 + bd + r, d), min(h0 + bh + r, h), min(w0 + bw + r, wd))
            o = [lo[j] - (c - r) for j, c in enumerate((d0, h0, w0))]
            halo[o[0]:o[0] + hi[0] - lo[0], o[1]:o[1] + hi[1] - lo[1],
                 o[2]:o[2] + hi[2] - lo[2], :cin] = xb[
                     n, :, lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]].permute(1, 2, 3, 0)
            for tile in range(tiles):
                acc = torch.zeros(bd * bh * bw, at)  # f32 sums: positions x out channels
                for ch in range(nch):
                    for t in range(taps):
                        td, th, tw = t // (k * k), t // k % k, t % k
                        view = halo[td:td + bd, th:th + bh, tw:tw + bw,
                                    ch * ct:(ch + 1) * ct].reshape(-1, ct)
                        wt = packed[n if per_sample else 0, tile * at:(tile + 1) * at,
                                    ch * ct:(ch + 1) * ct, t]
                        acc += view @ wt.T
                if bias is not None:
                    acc += torch.nn.functional.pad(bias.float(), (0, tiles * at - cout))[
                        tile * at:(tile + 1) * at]
                acc = acc.T.reshape(at, bd, bh, bw)
                part = y[n, tile * at:(tile + 1) * at, d0:d0 + bd, h0:h0 + bh, w0:w0 + bw]
                part[...] = acc[:part.shape[0], :part.shape[1], :part.shape[2], :part.shape[3]]
    return y


def _operands(b, cin, cout, k, per_sample, spatial, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.uniform(-1, 1, (b, cin) + spatial).astype(np.float32))
    wshape = ((b,) if per_sample else ()) + (cout, cin, k, k, k)
    w = torch.from_numpy(rng.uniform(-1, 1, wshape).astype(np.float32))
    bias = torch.from_numpy(rng.uniform(-1, 1, (cout,)).astype(np.float32))
    return x.bfloat16().float(), w.bfloat16().float(), bias


@pytest.mark.parametrize("shape", RAGGED[:2], ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("cin", [1, 3, 16, 40])
@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("per_sample", [False, True])
def test_tc_decomposition_matches_plain(shape, cin, k, per_sample):
    b, d, h, w = shape
    cout = 20  # two output-channel tiles of 16, the second ragged
    x, wt, bias = _operands(b, cin, cout, k, per_sample, (d, h, w), cin * 10 + k)
    plan = s1_plan(b, cin, cout, d, h, w, k, per_sample)
    assert plan.grid[1] == 1 and plan.at == 32
    plan = plan._replace(at=16, grid=(plan.grid[0], 2, b))
    got = _emulate_tc(x, wt, bias, plan)
    want = ops.conv3d_s1_plain(x, wt, bias)
    assert got.shape == want.shape
    assert float((got - want).abs().max() / want.abs().max()) < TOL


@pytest.mark.parametrize("cin", [3, 40])
@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("per_sample", [False, True])
def test_tc_decomposition_input_gradient(cin, k, per_sample):
    b, d, h, w = 2, 6, 5, 18  # 2 x 2 x 2 bricks, each ragged
    cout = 24
    x, wt, _ = _operands(b, cin, cout, k, per_sample, (d, h, w), cin + 7 * k)
    g = torch.from_numpy(np.random.default_rng(k).uniform(-1, 1, (b, cout, d, h, w))
                         .astype(np.float32)).bfloat16().float()
    # the backward's K1 call: the cotangent through flip_t(w), Cout -> Cin
    plan = s1_plan(b, cout, cin, d, h, w, k, per_sample)
    got = _emulate_tc(g, flip_t(wt), None, plan)
    xr = x.clone().requires_grad_(True)
    (want,) = torch.autograd.grad(conv3d_ref(xr, wt), xr, g)
    assert got.shape == want.shape
    assert float((got - want).abs().max() / want.abs().max()) < TOL


def _pack(w, a_n, c_n, k, at, flip):
    """`s1_pack_weights` of `csrc/conv3d_s1_tc.cu`, element by element:
    wp[bw][at][ch][t][o][cc] from w [B?, A, C, k^3], or with flip from the
    forward layer's w [B?, C, A, k^3] read as flip_t(w)."""
    taps = k ** 3
    flat = w.reshape(-1)
    nbw = flat.numel() // (a_n * c_n * taps)
    nat, nch = _cdiv(a_n, at), _cdiv(c_n, S1_CT)
    total = nbw * nat * nch * taps * at * S1_CT
    e = torch.arange(total)
    cc, o, t = e % S1_CT, e // S1_CT % at, e // (S1_CT * at) % taps
    r = e // (S1_CT * at * taps)
    ch, ti, bw = r % nch, r // nch % nat, r // (nch * nat)
    a, c = ti * at + o, ch * S1_CT + cc
    inside = (a < a_n) & (c < c_n)
    a, c = a.clamp(max=a_n - 1), c.clamp(max=c_n - 1)
    src = (((bw * c_n + c) * a_n + a) * taps + (taps - 1 - t) if flip
           else ((bw * a_n + a) * c_n + c) * taps + t)
    return torch.where(inside, flat[src], torch.zeros(()))


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("per_sample", [False, True])
def test_weight_packing_reads_flip_t_in_place(k, per_sample):
    b, cin, cout = 2, 20, 11  # the input gradient's conv: 11 -> 20 channels
    _, w, _ = _operands(b, cin, cout, k, per_sample, (1, 1, 1), 5 * k)
    plan = s1_plan(b, cout, cin, 4, 4, 16, k, per_sample)
    got = _pack(w, cin, cout, k, plan.at, flip=True)
    want = _pack(flip_t(w).contiguous(), cin, cout, k, plan.at, flip=False)
    assert got.numel() == plan.wpack
    assert torch.equal(got, want)
