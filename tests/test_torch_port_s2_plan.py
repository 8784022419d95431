"""K2's plan (`coma_unet_tpu_torch/ops/conv3d_strided.py:s2_plan`) and the
decomposition that its tensor-core kernel (`csrc/conv3d_s2_tc.cu`)
computes, checked on the CPU, where no kernel runs.

(a) For every K2 shape of `chip_smoke.py` phase 3 (down0.conv0 and up0's
    input gradient at 128^3 b=2 and 216^3 b=1, down0.conv0 at the 216^3
    eval's b=2, and the odd sizes off the path) and for ragged shapes, the plan's blocks cover every output
    position of every sample and every output channel exactly once, and the
    grid stays within CUDA's limits.
(b) A torch emulation of the tensor-core kernel's decomposition -- per
    brick, the stride-2 halo box with zero fill, stored as its 8 parity
    sub-bricks, the per-tap unit-stride views of one sub-brick, the packed
    weights zero past Cout and Cin, bf16 operands with f32 sums over
    16-channel chunks, then the bias -- equals the plain version on the f32
    upcast within 1e-5 of max|plain|, for shared and per-sample weights,
    Cin in {3, 16, 40}, odd and even sizes; in the input-gradient role (the
    cotangent through `flip_t(w)`) it equals autograd's input gradient of
    the transposed conv. The kernel's closed forms of the parity-split
    index are checked against the split they stand for.
(c) `conv3d_s2_dx` on the CPU equals the transposed conv's input gradient:
    the Pallas stride-2 conv on the flipped weights, as the JAX package's
    VJP computes it (interpret mode), and autograd of the plain version;
    `Conv3dT2.backward` reaches it.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
import coma_unet_tpu.ops.pallas.conv3d_strided as strided  # noqa: E402
from coma_unet_tpu_torch import ops  # noqa: E402
from coma_unet_tpu_torch.ops import _build  # noqa: E402
from coma_unet_tpu_torch.ops.conv3d import GRID_MAX, flip_t  # noqa: E402
from coma_unet_tpu_torch.ops.conv3d_strided import (  # noqa: E402
    S2_BLOCKS,
    S2_BRICK,
    S2_CT,
    conv3d_s2_dx,
    conv_transpose3d_ref,
    s2_plan,
)

TOL = 1e-5
RAGGED = [(2, 13, 9, 20), (1, 7, 7, 7), (2, 8, 6, 34)]  # (b, d, h, w) of the input


def _cdiv(a, b):
    return -(-a // b)


def _half(n):
    return (n - 1) // 2 + 1


def _phase3_shapes():
    """(b, cin, cout, d, h, w, per_sample) of every K2 case of phase 3, as
    the kernel sees it (for an input gradient: the cotangent's channels to
    the transposed conv's input channels)."""
    shapes = []
    for family, _, xshape, wshape, extra, entry in chip_smoke._kernel_cases():
        if family == "s2":
            b, cin, d, h, w = xshape
            cout = wshape[1] if entry == "dx" else wshape[0]
            shapes.append((b, cin, cout, d, h, w, bool(extra)))
    return shapes


PLAN_SHAPES = _phase3_shapes() + [
    (b, cin, cout, d, h, w, ps) for b, d, h, w in RAGGED[:2]
    for cin, cout in ((1, 8), (3, 16), (40, 33), (64, 128)) for ps in (False, True)]


def test_phase3_shapes_cover_every_k2_site():
    shapes = _phase3_shapes()
    # down0.conv0 at both sizes and the eval's b=2, up0's input gradient at
    # both sizes, the odd sizes, and down0.conv0 on the depth-sharded 216^3
    # forward's slabs (112 and 104 of 216 planes) and its 4-plane window
    assert len(shapes) == 9
    assert sorted({s[3] for s in shapes}) == [4, 27, 104, 112, 128, 216]
    assert all(s[1:3] == (32, 64) for s in shapes[:5] + shapes[6:])
    plans = [s2_plan(*s) for s in shapes]
    assert {p.at for p in plans} == {64} and {p.grid[1] for p in plans} == {1}
    # about one block an SM at the path's shapes, each walking many bricks
    assert [p.grid for p in plans[:5]] == [(66, 1, 2), (132, 1, 1), (66, 1, 2),
                                           (66, 1, 2), (132, 1, 1)]
    assert [p.bricks for p in plans[:3]] == [32 * 16 * 4] + [54 * 27 * 7] * 2
    # one block an SM on the slabs and the window's 189 bricks
    assert [p.grid for p in plans[6:]] == [(132, 1, 1)] * 3
    assert [p.bricks for p in plans[6:]] == [28 * 27 * 7, 26 * 27 * 7, 27 * 7]


@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_s2_plan_covers_every_output_once(shape):
    b, cin, cout, d, h, w, ps = shape
    plan = s2_plan(b, cin, cout, d, h, w, ps)
    assert all(0 < g <= GRID_MAX for g in plan.grid)
    assert plan.brick == S2_BRICK and plan.ct == S2_CT and plan.at in (8, 16, 32, 64)
    do, ho, wo = _half(d), _half(h), _half(w)
    bd, bh, bw = plan.brick
    nbd, nbh, nbw = _cdiv(do, bd), _cdiv(ho, bh), _cdiv(wo, bw)
    assert plan.bricks == nbd * nbh * nbw
    gx, tiles, gz = plan.grid
    assert gz == b and gx <= plan.bricks
    assert gx == min(plan.bricks, _cdiv(S2_BLOCKS, tiles * b))
    # output channels: tiles of at, the last one ragged, none empty
    assert tiles * plan.at >= cout > (tiles - 1) * plan.at
    assert plan.wpack == ((b if ps else 1) * tiles * _cdiv(cin, S2_CT) * 27
                          * plan.at * S2_CT)
    # block x walks bricks x, x + gx, ...: every brick once
    walked = np.concatenate([np.arange(x, plan.bricks, gx) for x in range(gx)])
    assert np.array_equal(np.sort(walked), np.arange(plan.bricks))
    # the kernel's count of a block's bricks
    for x in range(gx):
        assert (plan.bricks - 1 - x) // gx + 1 == len(range(x, plan.bricks, gx))
    # brick bi's origin, as the kernel computes it, covers each output
    # position of the sample once
    org = np.stack([walked // (nbh * nbw), walked // nbw % nbh, walked % nbw], axis=1)
    seen = np.zeros((nbd * bd, nbh * bh, nbw * bw), np.int64)
    for d0, h0, w0 in org * (bd, bh, bw):
        seen[d0:d0 + bd, h0:h0 + bh, w0:w0 + bw] += 1
    assert (seen == 1).all() and seen[:do, :ho, :wo].sum() == do * ho * wo


def test_s2_plan_keeps_the_grid_within_limits():
    plan = s2_plan(70, 32, 64, 64, 64, 64, True)
    assert plan.grid == (2, 1, 70)
    big = s2_plan(1, 16, 8, 1024, 1024, 1024)
    assert big.bricks > GRID_MAX and big.grid == (S2_BLOCKS, 1, 1)
    wide = s2_plan(2, 32, 200, 64, 64, 64, True)
    assert (wide.at, wide.grid) == (64, (_cdiv(S2_BLOCKS, 8), 4, 2))


def _split(j, n):
    """Where box position j (0 <= j <= 2n) along an axis of n outputs is
    stored: its n + 1 even positions first, then its n odd ones."""
    return j // 2 if j % 2 == 0 else n + 1 + j // 2


def _shift(s, n):
    """Tap offset s of output q reads box position 2q + s, stored at
    q + _shift(s, n)."""
    return (0, n + 1, 1)[s]


def test_parity_split_closed_forms():
    for n in S2_BRICK:
        order = [j for j in range(2 * n + 1) if j % 2 == 0] + [j for j in range(1, 2 * n + 1, 2)]
        assert [_split(j, n) for j in order] == list(range(2 * n + 1))
        for q in range(n):
            for s in range(3):
                assert _split(2 * q + s, n) == q + _shift(s, n)
    # the staging's stores: element e of row piece v is box position
    # 1 + 8 v + e along W (n = 16)
    bw = S2_BRICK[2]
    for v in range(2 * bw // 8):
        for e in range(8):
            s = bw + 1 + 4 * v + e // 2 if e % 2 == 0 else 4 * v + (e + 1) // 2
            assert s == _split(1 + 8 * v + e, bw)


def _emulate_tc(x, w, bias, plan):
    """The tensor-core kernel's decomposition of K2, in torch on the CPU."""
    b, cin, d, h, wd = x.shape
    per_sample = w.dim() == 6
    cout = w.shape[-5]
    bd, bh, bw = plan.brick
    ct, at = plan.ct, plan.at
    gx, tiles, _ = plan.grid
    nch = _cdiv(cin, ct)
    do, ho, wo = _half(d), _half(h), _half(wd)
    xb = x.bfloat16().float()
    wb = w.bfloat16().float().reshape((-1, cout, cin, 27))
    packed = torch.zeros(wb.shape[0], tiles * at, nch * ct, 27)
    packed[:, :cout, :cin] = wb
    nbh, nbw = _cdiv(ho, bh), _cdiv(wo, bw)
    y = torch.zeros(b, cout, do, ho, wo)
    for n in range(b):
        for bi in (i for x0 in range(gx) for i in range(x0, plan.bricks, gx)):
            q0 = (bi // (nbh * nbw) * bd, bi // nbw % nbh * bh, bi % nbw * bw)
            # the stride-2 halo box, channels-last, zero outside the volume
            box = torch.zeros(2 * bd + 1, 2 * bh + 1, 2 * bw + 1, nch * ct)
            org = [2 * q - 1 for q in q0]
            lo = [max(o, 0) for o in org]
            hi = [min(o + 2 * e + 1, n_) for o, e, n_ in zip(org, plan.brick, (d, h, wd))]
            if all(a < z for a, z in zip(lo, hi)):
                box[lo[0] - org[0]:hi[0] - org[0], lo[1] - org[1]:hi[1] - org[1],
                    lo[2] - org[2]:hi[2] - org[2], :cin] = xb[
                        n, :, lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]].permute(1, 2, 3, 0)
            # its 8 parity sub-bricks: sub[(pd, ph, pw)] = box[pd::2, ph::2, pw::2]
            sub = {(pd, ph, pw): box[pd::2, ph::2, pw::2]
                   for pd in (0, 1) for ph in (0, 1) for pw in (0, 1)}
            for tile in range(tiles):
                acc = torch.zeros(bd * bh * bw, at)  # f32 sums: positions x out channels
                for ch in range(nch):
                    for t in range(27):
                        td, th, tw = t // 9, t // 3 % 3, t % 3
                        # tap offset s reads parity s % 2 from position s // 2 on
                        part = sub[(td % 2, th % 2, tw % 2)]
                        view = part[td // 2:td // 2 + bd, th // 2:th // 2 + bh,
                                    tw // 2:tw // 2 + bw, ch * ct:(ch + 1) * ct]
                        wt = packed[n if per_sample else 0, tile * at:(tile + 1) * at,
                                    ch * ct:(ch + 1) * ct, t]
                        acc += view.reshape(-1, ct) @ wt.T
                if bias is not None:
                    acc += torch.nn.functional.pad(bias.float(), (0, tiles * at - cout))[
                        tile * at:(tile + 1) * at]
                acc = acc.T.reshape(at, bd, bh, bw)
                part = y[n, tile * at:(tile + 1) * at, q0[0]:q0[0] + bd,
                         q0[1]:q0[1] + bh, q0[2]:q0[2] + bw]
                part[...] = acc[:part.shape[0], :part.shape[1], :part.shape[2], :part.shape[3]]
    return y


def _operands(b, cin, cout, per_sample, spatial, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.uniform(-1, 1, (b, cin) + spatial).astype(np.float32))
    wshape = ((b,) if per_sample else ()) + (cout, cin, 3, 3, 3)
    w = torch.from_numpy(rng.uniform(-1, 1, wshape).astype(np.float32))
    bias = torch.from_numpy(rng.uniform(-1, 1, (cout,)).astype(np.float32))
    return x.bfloat16().float(), w.bfloat16().float(), bias


@pytest.mark.parametrize("shape", [RAGGED[0], RAGGED[2]], ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("cin", [3, 16, 40])
@pytest.mark.parametrize("per_sample", [False, True])
def test_tc_decomposition_matches_plain(shape, cin, per_sample):
    b, d, h, w = shape
    cout = 20  # two output-channel tiles of 16, the second ragged
    x, wt, bias = _operands(b, cin, cout, per_sample, (d, h, w), cin * 10 + d)
    plan = s2_plan(b, cin, cout, d, h, w, per_sample)
    assert plan.grid[1] == 1 and plan.at == 32
    plan = plan._replace(at=16, grid=(min(plan.grid[0], 3), 2, b))
    got = _emulate_tc(x, wt, bias, plan)
    want = ops.conv3d_s2_plain(x, wt, bias)
    assert got.shape == want.shape
    assert float((got - want).abs().max() / want.abs().max()) < TOL


@pytest.mark.parametrize("cin", [3, 40])
@pytest.mark.parametrize("per_sample", [False, True])
def test_tc_decomposition_input_gradient(cin, per_sample):
    # the transposed conv x [b, cin, 3, 4, 9] -> [b, cout, 6, 8, 18]; its
    # input gradient is K2 on the cotangent through flip_t(w), cout -> cin
    b, cout, spatial = 2, 24, (3, 4, 9)
    x, wt, _ = _operands(b, cin, cout, per_sample, spatial, cin + 7)
    g = torch.from_numpy(np.random.default_rng(cin).uniform(
        -1, 1, (b, cout) + tuple(2 * n for n in spatial)).astype(np.float32)).bfloat16().float()
    plan = s2_plan(b, cout, cin, *g.shape[2:], per_sample)
    got = _emulate_tc(g, flip_t(wt), None, plan)
    xr = x.clone().requires_grad_(True)
    (want,) = torch.autograd.grad(conv_transpose3d_ref(xr, wt), xr, g)
    assert got.shape == want.shape
    assert float((got - want).abs().max() / want.abs().max()) < TOL


@pytest.mark.parametrize("per_sample", [False, True])
def test_conv3d_s2_dx_is_the_transposed_convs_input_gradient(per_sample):
    rng = np.random.default_rng(11)
    b, cin, cout = 2, 5, 3
    wshape = ((b,) if per_sample else ()) + (cout, cin, 3, 3, 3)
    w = rng.uniform(-1, 1, wshape).astype(np.float32)
    x = rng.uniform(-1, 1, (b, cin, 4, 4, 4)).astype(np.float32)
    g = rng.uniform(-1, 1, (b, cout, 8, 8, 8)).astype(np.float32)
    _build.reset_counts()
    got = conv3d_s2_dx(torch.from_numpy(g), torch.from_numpy(w))
    assert dict(_build.PLAIN_ON_CPU) == {"s2": 1}
    # the JAX package's VJP: the Pallas stride-2 conv of g on flip_t(w)
    w_t = (strided._flip_t_b if per_sample else strided._flip_t)(jnp.asarray(w))
    want = strided.unpack_w(strided._s2_fwd(jnp.asarray(g), w_t, interpret=True))
    want = np.asarray(want)
    assert got.shape == want.shape
    assert float(np.abs(got.numpy() - want).max() / np.abs(want).max()) < TOL
    xr = torch.from_numpy(x).requires_grad_(True)
    (auto,) = torch.autograd.grad(conv_transpose3d_ref(xr, torch.from_numpy(w)), xr,
                                  torch.from_numpy(g))
    assert float((got - auto).abs().max() / auto.abs().max()) < TOL


def test_conv3d_t2_backward_runs_k2_for_dx():
    rng = np.random.default_rng(12)
    x = torch.from_numpy(rng.uniform(-1, 1, (2, 4, 3, 3, 3)).astype(np.float32))
    w = torch.from_numpy(rng.uniform(-1, 1, (2, 6, 4, 3, 3, 3)).astype(np.float32))
    x.requires_grad_(True)
    w.requires_grad_(True)
    _build.reset_counts()
    ops.conv3d_t2(x, w).square().sum().backward()
    assert dict(_build.PLAIN_ON_CPU) == {"t2": 1, "s2": 1, "strided_dw": 1}
    assert x.grad.shape == x.shape and w.grad.shape == w.shape
