"""K3's plan (`coma_unet_tpu_torch/ops/conv3d_strided.py:t2_plan`) and the
decomposition that its tensor-core kernel (`csrc/conv3d_t2_tc.cu`)
computes, checked on the CPU, where no kernel runs.

(a) For every K3 shape of `chip_smoke.py` phase 3 (up0 at 128^3 b=2, 216^3
    b=1 and the 216^3 eval's b=2, down0.conv0's input gradient at 128^3 b=2
    and 216^3 b=1, and the odd sizes off the path) and for ragged odd sizes,
    the plan's blocks cover every input position -- so every 2 x 2 x 2
    output cube -- of every sample and every output channel exactly once,
    and the grid stays within CUDA's limits.
(b) A torch emulation of the tensor-core kernel's decomposition -- per
    brick, the high-side halo box with zero fill as the kernel stages it,
    the 8 offset fragments in the kernel's offset-major order, each fed to
    its taps' parity classes, the packed weights zero past Cout and Cin,
    bf16 operands with f32 sums over 16-channel chunks, then the bias and
    the interleave of the 8 classes into the output cube -- equals the
    plain version on the f32 upcast within 1e-5 of max|plain|, for shared
    and per-sample weights, Cin in {3, 16, 40}, odd and even sizes; in the
    input-gradient role (the packing reading `flip_t(w)` from the stride-2
    conv's weights in place) it equals autograd's input gradient of the
    stride-2 conv.
(c) The kernel's closed forms of the offset -> (tap, class) table
    (`tap_off`, `tap_cls`, `entry_tap`) are checked against the
    lhs-dilated correlation they stand for.
(d) `conv3d_t2` on the CPU equals the Pallas `_t2_fwd` in interpret mode on
    `pack_w(x)`; `Conv3dS2.backward`'s input gradient equals the JAX
    package's `_s2_vjp_bwd` / `_s2_b_vjp_bwd` (Pallas in interpret mode),
    reaches `_k3` with the forward weights and builds no `flip_t` copy.
"""

import functools

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
import coma_unet_tpu.ops.pallas.conv3d_strided as strided  # noqa: E402
from coma_unet_tpu_torch import ops  # noqa: E402
from coma_unet_tpu_torch.ops import _build  # noqa: E402
from coma_unet_tpu_torch.ops import conv3d_strided as port  # noqa: E402
from coma_unet_tpu_torch.ops.conv3d import GRID_MAX, conv3d_ref  # noqa: E402
from coma_unet_tpu_torch.ops.conv3d_strided import (  # noqa: E402
    T2_AT,
    T2_BLOCKS,
    T2_BRICK,
    T2_CT,
    t2_plan,
)

TOL = 1e-5
RAGGED = [(2, 5, 7, 19), (1, 3, 3, 3), (2, 4, 6, 34)]  # (b, d, h, w) of the input


def _cdiv(a, b):
    return -(-a // b)


def _phase3_shapes():
    """(b, cin, cout, d, h, w, per_sample) of every K3 case of phase 3, as
    the kernel sees it (for an input gradient: the cotangent's channels to
    the stride-2 conv's input channels)."""
    shapes = []
    for family, _, xshape, wshape, extra, entry in chip_smoke._kernel_cases():
        if family == "t2":
            b, cin, d, h, w = xshape
            cout = wshape[1] if entry == "dx" else wshape[0]
            shapes.append((b, cin, cout, d, h, w, bool(extra)))
    return shapes


PLAN_SHAPES = _phase3_shapes() + [
    (b, cin, cout, d, h, w, ps) for b, d, h, w in RAGGED[:2]
    for cin, cout in ((1, 8), (3, 16), (40, 33), (64, 128)) for ps in (False, True)]


def test_phase3_shapes_cover_every_k3_site():
    shapes = _phase3_shapes()
    # up0 at both sizes and the eval's b=2, down0.conv0's input gradient at
    # both sizes, the odd sizes, and up0 on the depth-sharded 216^3
    # forward's slabs (56 and 52 of 108 planes) and its 2-plane window
    assert len(shapes) == 9
    assert sorted({s[3] for s in shapes}) == [2, 13, 52, 56, 64, 108]
    assert all(s[1:3] == (64, 32) for s in shapes[:5] + shapes[6:])
    plans = [t2_plan(*s) for s in shapes]
    assert {p.at for p in plans} == {32}
    # about one block an SM at the path's shapes, each walking many bricks
    assert [p.grid for p in plans[:5]] == [(66, 1, 2), (132, 1, 1), (66, 1, 2),
                                           (66, 1, 2), (132, 1, 1)]
    assert [p.bricks for p in plans[:3]] == [32 * 16 * 4] + [54 * 27 * 7] * 2
    # the odd case pads its second output-channel tile (40 = 32 + 8)
    assert plans[5].grid[1] == 2
    # one block an SM on the slabs and the window's 189 bricks
    assert [p.grid for p in plans[6:]] == [(132, 1, 1)] * 3
    assert [p.bricks for p in plans[6:]] == [28 * 27 * 7, 26 * 27 * 7, 27 * 7]


@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_t2_plan_covers_every_input_once(shape):
    b, cin, cout, d, h, w, ps = shape
    plan = t2_plan(b, cin, cout, d, h, w, ps)
    assert all(0 < g <= GRID_MAX for g in plan.grid)
    assert plan.brick == T2_BRICK and plan.ct == T2_CT and plan.at == T2_AT
    bd, bh, bw = plan.brick
    nbd, nbh, nbw = _cdiv(d, bd), _cdiv(h, bh), _cdiv(w, bw)
    assert plan.bricks == nbd * nbh * nbw
    gx, tiles, gz = plan.grid
    assert gz == b and gx <= plan.bricks
    assert gx == min(plan.bricks, _cdiv(T2_BLOCKS, tiles * b))
    # output channels: tiles of at, the last one ragged, none empty
    assert tiles * plan.at >= cout > (tiles - 1) * plan.at
    assert plan.wpack == ((b if ps else 1) * tiles * _cdiv(cin, T2_CT) * 27
                          * plan.at * T2_CT)
    # block x walks bricks x, x + gx, ...: every brick once
    walked = np.concatenate([np.arange(x, plan.bricks, gx) for x in range(gx)])
    assert np.array_equal(np.sort(walked), np.arange(plan.bricks))
    # the kernel's count of a block's bricks
    for x in range(gx):
        assert (plan.bricks - 1 - x) // gx + 1 == len(range(x, plan.bricks, gx))
    # brick bi's origin, as the kernel computes it, covers each input
    # position of the sample once, and so each output cube
    org = np.stack([walked // (nbh * nbw), walked // nbw % nbh, walked % nbw], axis=1)
    seen = np.zeros((nbd * bd, nbh * bh, nbw * bw), np.int64)
    for d0, h0, w0 in org * (bd, bh, bw):
        seen[d0:d0 + bd, h0:h0 + bh, w0:w0 + bw] += 1
    assert (seen == 1).all() and seen[:d, :h, :w].sum() == d * h * w
    out = np.zeros((2 * nbd * bd, 2 * nbh * bh, 2 * nbw * bw), np.int64)
    for d0, h0, w0 in org * (bd, bh, bw):
        out[2 * d0:2 * d0 + 2 * bd, 2 * h0:2 * h0 + 2 * bh, 2 * w0:2 * w0 + 2 * bw] += 1
    assert (out == 1).all()


def test_t2_plan_keeps_the_grid_within_limits():
    plan = t2_plan(70, 64, 32, 32, 32, 32, True)
    assert plan.grid == (2, 1, 70)
    big = t2_plan(1, 16, 8, 1024, 1024, 1024)
    assert big.bricks > GRID_MAX and big.grid == (T2_BLOCKS, 1, 1)
    wide = t2_plan(2, 64, 200, 32, 32, 32, True)
    assert (wide.at, wide.grid) == (T2_AT, (_cdiv(T2_BLOCKS, 14), 7, 2))


# The kernel's closed forms (csrc/conv3d_t2_tc.cu): per axis, tap k feeds
# output parity k != 1 from input offset k == 2; bit 2 is D, bit 1 H, bit 0 W.
def _tap_cls(t):
    return (t // 9 != 1) * 4 + (t // 3 % 3 != 1) * 2 + (t % 3 != 1)


def _tap_off(t):
    return (t // 9 == 2) * 4 + (t // 3 % 3 == 2) * 2 + (t % 3 == 2)


def _entry_tap(i):
    """Entry i of the 27 taps in offset-major order, ascending within an
    offset."""
    return [t for d in range(8) for t in range(27) if _tap_off(t) == d][i]


def _xoff(d, hh, hw):
    """The box row offset of input offset d (box rows of hh along H, hw
    positions along W)."""
    return ((d >> 2) * hh + ((d >> 1) & 1)) * hw + (d & 1)


@pytest.mark.parametrize("n", [1, 2, 5])
def test_tap_table_is_the_dilated_correlation(n):
    """Per axis, the lhs-dilated correlation y[o] = sum_k xd[o + k - 1] w[k]
    (xd: x dilated by 2, padded (1, 2)) reads x[i] through tap k exactly
    when o = 2 q + cls(k) and i = q + off(k) for some q, with x[n] zero."""
    xd = {2 * i + 1: i for i in range(n)}  # padded, dilated index -> x index
    definition = {(o, k, xd[o + k]) for o in range(2 * n) for k in range(3)
                  if o + k in xd}
    cls = {k: int(k != 1) for k in range(3)}
    off = {k: int(k == 2) for k in range(3)}
    closed = {(2 * q + cls[k], k, q + off[k]) for q in range(n) for k in range(3)
              if q + off[k] < n}
    assert definition == closed
    # in 3-D each tap's class and offset are the per-axis ones, D major
    for t in range(27):
        ks = (t // 9, t // 3 % 3, t % 3)
        assert _tap_cls(t) == sum(cls[k] << (2 - a) for a, k in enumerate(ks))
        assert _tap_off(t) == sum(off[k] << (2 - a) for a, k in enumerate(ks))


def test_offset_major_order():
    order = [_entry_tap(i) for i in range(27)]
    assert sorted(order) == list(range(27))
    offs = [_tap_off(t) for t in order]
    assert offs == sorted(offs)
    # offset d serves 2^(zero bits of d) taps, one per class
    for d in range(8):
        taps = [t for t in order if _tap_off(t) == d]
        assert len(taps) == 2 ** (3 - bin(d).count("1"))
        assert len({_tap_cls(t) for t in taps}) == len(taps)
        # an offset's taps feed the classes whose odd axes include its +1 axes
        assert all(_tap_cls(t) & d == d for t in taps)
    # classes take 1, 2, 2, 2, 4, 4, 4 and 8 taps
    assert sorted(sum(1 for t in range(27) if _tap_cls(t) == c) for c in range(8)) == [
        1, 2, 2, 2, 4, 4, 4, 8]
    # consecutive offsets alternate the A buffer (offset parity)
    assert all((a & 1) != (b & 1) for a, b in zip(range(7), range(1, 8)))


def _pack(w, a_n, c_n, at, flip):
    """`s1_pack_weights` of `csrc/conv3d_s1_tc.cu` (k = 3), element by
    element: wp[bw][at][ch][t][o][cc] from w [B?, A, C, 27], or with flip
    from the stride-2 conv's w [B?, C, A, 27] read as flip_t(w)."""
    taps = 27
    flat = w.reshape(-1)
    nbw = flat.numel() // (a_n * c_n * taps)
    nat, nch = _cdiv(a_n, at), _cdiv(c_n, T2_CT)
    total = nbw * nat * nch * taps * at * T2_CT
    e = torch.arange(total)
    cc, o, t = e % T2_CT, e // T2_CT % at, e // (T2_CT * at) % taps
    r = e // (T2_CT * at * taps)
    ch, ti, bw = r % nch, r // nch % nat, r // (nch * nat)
    a, c = ti * at + o, ch * T2_CT + cc
    inside = (a < a_n) & (c < c_n)
    a, c = a.clamp(max=a_n - 1), c.clamp(max=c_n - 1)
    src = (((bw * c_n + c) * a_n + a) * taps + (taps - 1 - t) if flip
           else ((bw * a_n + a) * c_n + c) * taps + t)
    packed = torch.where(inside, flat[src], torch.zeros(()))
    return packed.reshape(nbw, nat, nch, taps, at, T2_CT)


def _emulate_tc(x, w, bias, plan, cout, flip=False):
    """The tensor-core kernel's decomposition of K3, in torch on the CPU:
    x [b, cin, d, h, w] -> [b, cout, 2d, 2h, 2w]; w as the kernel takes it
    (with flip, the stride-2 conv's weights)."""
    b, cin, d, h, wd = x.shape
    bd, bh, bw = plan.brick
    ct, at = plan.ct, plan.at
    gx, tiles, _ = plan.grid
    nch = _cdiv(cin, ct)
    xb = x.bfloat16().float()
    packed = _pack(w.bfloat16().float(), cout, cin, at, flip)
    nbh, nbw = _cdiv(h, bh), _cdiv(wd, bw)
    y = torch.zeros(b, cout, 2 * d, 2 * h, 2 * wd)
    biasp = torch.zeros(tiles * at)
    if bias is not None:
        biasp[:cout] = bias.float()
    for n in range(b):
        for bi in (i for x0 in range(gx) for i in range(x0, plan.bricks, gx)):
            d0, h0, w0 = bi // (nbh * nbw) * bd, bi // nbw % nbh * bh, bi % nbw * bw
            # the X box as the kernel stages it: rows d0 .. d0 + bd, h0 .. h0
            # + bh, positions w0 - 1 .. w0 + bw along W, channels-last, zero
            # outside the volume (position 0 is loaded and never read)
            box = torch.zeros(bd + 1, bh + 1, bw + 2, nch * ct)
            org = (d0, h0, w0 - 1)
            lo = [max(o, 0) for o in org]
            hi = [min(o + e, n_) for o, e, n_ in zip(org, box.shape[:3], (d, h, wd))]
            if all(a < z for a, z in zip(lo, hi)):
                box[lo[0] - org[0]:hi[0] - org[0], lo[1] - org[1]:hi[1] - org[1],
                    lo[2] - org[2]:hi[2] - org[2], :cin] = xb[
                        n, :, lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]].permute(1, 2, 3, 0)
            rows = box.reshape(-1, nch * ct)
            # the lane's row at offset 0: brick position (dd, hh, ww) is box
            # row (dd (bh + 1) + hh) (bw + 2) + 1 + ww
            dd, hh, ww = torch.meshgrid(torch.arange(bd), torch.arange(bh), torch.arange(bw),
                                        indexing="ij")
            row0 = ((dd * (bh + 1) + hh) * (bw + 2) + 1 + ww).reshape(-1)
            for tile in range(tiles):
                acc = torch.zeros(8, bd * bh * bw, at)  # f32 sums: class x positions x channels
                for ch in range(nch):
                    for i in range(27):
                        t = _entry_tap(i)
                        # one A fragment per offset serves each of its taps
                        frag = rows[row0 + _xoff(_tap_off(t), bh + 1, bw + 2),
                                    ch * ct:(ch + 1) * ct]
                        wt = packed[n if packed.shape[0] > 1 else 0, tile, ch, t]
                        acc[_tap_cls(t)] += frag @ wt.T
                acc += biasp[tile * at:(tile + 1) * at]
                # interleave: class (pd, ph, pw) of position (dd, hh, ww) is
                # output (2 dd + pd, 2 hh + ph, 2 ww + pw) of the cube
                cube = torch.zeros(at, 2 * bd, 2 * bh, 2 * bw)
                for c in range(8):
                    pd, ph, pw = c >> 2, (c >> 1) & 1, c & 1
                    cube[:, pd::2, ph::2, pw::2] = acc[c].T.reshape(at, bd, bh, bw)
                part = y[n, tile * at:(tile + 1) * at, 2 * d0:2 * d0 + 2 * bd,
                         2 * h0:2 * h0 + 2 * bh, 2 * w0:2 * w0 + 2 * bw]
                part[...] = cube[:part.shape[0], :part.shape[1], :part.shape[2],
                                 :part.shape[3]]
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
    cout = 40  # two output-channel tiles of 32, the second ragged
    x, wt, bias = _operands(b, cin, cout, per_sample, (d, h, w), cin * 10 + d)
    plan = t2_plan(b, cin, cout, d, h, w, per_sample)
    assert plan.grid[1] == 2 and plan.at == 32
    plan = plan._replace(grid=(min(plan.grid[0], 3),) + plan.grid[1:])
    got = _emulate_tc(x, wt, bias, plan, cout)
    want = ops.conv3d_t2_plain(x, wt, bias)
    assert got.shape == want.shape
    assert float((got - want).abs().max() / want.abs().max()) < TOL


@pytest.mark.parametrize("cin", [3, 40])
@pytest.mark.parametrize("per_sample", [False, True])
def test_tc_decomposition_input_gradient(cin, per_sample):
    # the stride-2 conv x [b, cin, 6, 8, 18] -> [b, cout, 3, 4, 9]; its input
    # gradient is K3 on the cotangent through flip_t(w), cout -> cin, which
    # the packing reads from w in place
    b, cout, spatial = 2, 24, (6, 8, 18)  # 24 -> cin: one padded tile of 32
    x, wt, _ = _operands(b, cin, cout, per_sample, spatial, cin + 7)
    g = torch.from_numpy(np.random.default_rng(cin).uniform(
        -1, 1, (b, cout) + tuple(n // 2 for n in spatial)).astype(np.float32))
    g = g.bfloat16().float()
    plan = t2_plan(b, cout, cin, *g.shape[2:], per_sample)
    got = _emulate_tc(g, wt, None, plan, cin, flip=True)
    xr = x.clone().requires_grad_(True)
    (want,) = torch.autograd.grad(conv3d_ref(xr, wt, stride=2), xr, g)
    assert got.shape == want.shape
    assert float((got - want).abs().max() / want.abs().max()) < TOL


@pytest.mark.parametrize("wshape", [(8, 16, 3, 3, 3), (2, 8, 16, 3, 3, 3)])
def test_conv3d_t2_matches_pallas_t2_fwd(wshape):
    rng = np.random.default_rng(13)
    x = rng.uniform(-1, 1, (2, 16, 4, 4, 8)).astype(np.float32)
    w = rng.uniform(-1, 1, wshape).astype(np.float32)
    _build.reset_counts()
    got = ops.conv3d_t2(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    assert dict(_build.PLAIN_ON_CPU) == {"t2": 1}
    want = np.asarray(strided._t2_fwd(strided.pack_w(jnp.asarray(x)), jnp.asarray(w),
                                      interpret=True))
    assert got.shape == want.shape
    assert float(np.abs(got - want).max() / np.abs(want).max()) < TOL


@pytest.mark.parametrize("per_sample", [False, True])
def test_conv3d_s2_backward_matches_s2_vjp_bwd(per_sample, monkeypatch):
    # the JAX package's VJP with its Pallas kernels in interpret mode
    monkeypatch.setattr(strided, "_t2_fwd", functools.partial(strided._t2_fwd_v1,
                                                              interpret=True))
    monkeypatch.setattr(strided, "_dw_dil", functools.partial(strided._dw_v2, interpret=True))
    rng = np.random.default_rng(17)
    b, cin, cout = 2, 3, 5
    wshape = ((b,) if per_sample else ()) + (cout, cin, 3, 3, 3)
    w = rng.uniform(-1, 1, wshape).astype(np.float32)
    x = rng.uniform(-1, 1, (b, cin, 8, 8, 16)).astype(np.float32)
    g = rng.uniform(-1, 1, (b, cout, 4, 4, 8)).astype(np.float32)
    bwd = strided._s2_b_vjp_bwd if per_sample else strided._s2_vjp_bwd
    want, _ = bwd((jnp.asarray(x), jnp.asarray(w)), strided.pack_w(jnp.asarray(g)))
    want = np.asarray(want)
    xt = torch.from_numpy(x).requires_grad_(True)
    ops.conv3d_s2(xt, torch.from_numpy(w)).backward(torch.from_numpy(g))
    got = xt.grad.numpy()
    assert got.shape == want.shape
    assert float(np.abs(got - want).max() / np.abs(want).max()) < TOL


def test_conv3d_s2_backward_reaches_k3_with_the_forward_weights(monkeypatch):
    calls, flips = [], []
    real_k3, real_flip = port._k3, port.flip_t

    def k3(x, w, bias, flip=False):
        calls.append((w, bias, flip))
        return real_k3(x, w, bias, flip)

    def flip_t(w):
        flips.append(len(calls))  # the K3 calls made before this copy
        return real_flip(w)

    monkeypatch.setattr(port, "_k3", k3)
    monkeypatch.setattr(port, "flip_t", flip_t)
    rng = np.random.default_rng(19)
    x = torch.from_numpy(rng.uniform(-1, 1, (2, 4, 6, 6, 6)).astype(np.float32))
    w = torch.from_numpy(rng.uniform(-1, 1, (2, 6, 4, 3, 3, 3)).astype(np.float32))
    x.requires_grad_(True)
    w.requires_grad_(True)
    _build.reset_counts()
    ops.conv3d_s2(x, w).square().sum().backward()
    assert dict(_build.PLAIN_ON_CPU) == {"s2": 1, "t2": 1, "strided_dw": 1}
    # one K3 call, with the forward layer's weights themselves, read flipped
    ((wk, bias, flip),) = calls
    assert wk.data_ptr() == w.data_ptr() and bias is None and flip
    # no flip_t copy before it: the only ones are the CPU plain version's,
    # inside that call
    assert flips and set(flips) == {1}
    assert x.grad.shape == x.shape and w.grad.shape == w.shape
