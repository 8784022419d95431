"""F2, the float32 stride-2 and transposed convs on the tensor cores in
3xTF32 (`csrc/conv3d_s2_f32_tc.cu`, `csrc/conv3d_t2_f32_tc.cu`, shared
pieces in `csrc/tf32_common.cuh`), checked on the CPU, where no kernel runs.

(a) The cut, `ops/conv3d_strided.py:f2_plan`: at every K2 and K3 shape of
    `chip_smoke.py` phase 3 (the float32 paths share them; phase 3 runs F2
    at those of F32_SITES) and at ragged ones, the blocks walk every brick
    of a sample once, the bricks cover every output position once (the
    transposed map: each input position's 2 x 2 x 2 output cube), the
    channel tiles every output channel once; a shape it cannot cut raises.
(b) The staging maps: each kernel's thread -> (box row, position, channel)
    map covers its box once, and the stride-2 map's stores put box
    position j of an axis of n outputs at its parity-split place.
(c) A torch emulation of the kernels' arithmetic -- the weight packing's
    hi and lo TF32 planes read through the C entry's strides (flip_t(w) in
    place for the input gradients), x split into hi and lo, TF32 rounding by
    int32 bit operations (round half away from zero), per chunk of 8 input
    channels the taps in the kernel's order (the stride-2 map: t ascending;
    the transposed map: offset-major, each tap into its parity class), per
    tap lo_x hi_w, hi_x lo_w, then hi_x hi_w, f32 sums -- is within 1e-5 of
    max|plain| of the f64 plain version, for both maps, shared and
    per-sample weights, with and without flip; the same emulation with hi
    parts only (1xTF32) reads at least 10x more. One case per map matches
    the JAX package's `_s2_fwd` / `_t2_fwd` at f32 (Pallas interpret
    mode, as the JAX tests run them).
"""

import itertools

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
import coma_unet_tpu.ops.pallas.conv3d_strided as strided  # noqa: E402
from coma_unet_tpu_torch.ops.conv3d import GRID_MAX, conv3d_ref, flip_t  # noqa: E402
from coma_unet_tpu_torch.ops.conv3d_strided import (  # noqa: E402
    F2_BLOCKS,
    F2_BRICK,
    F2_CT,
    conv_transpose3d_ref,
    f2_plan,
)

TOL = 1e-5      # 3xTF32 against f64, of max|plain|
HI_RATIO = 10   # 1xTF32 reads at least this many times more
CT = F2_CT


def _cdiv(a, b):
    return -(-a // b)


def _half(n):
    return (n - 1) // 2 + 1


def _phase3_shapes():
    """(mode, b, cin, cout, d, h, w, per_sample) of every K2 and K3 case of
    phase 3, as the kernel sees it (an input gradient: the cotangent in)."""
    shapes = set()
    for family, _, xshape, wshape, extra, entry in chip_smoke._kernel_cases():
        if family in ("s2", "t2"):
            b, cin, d, h, w = xshape
            cout = wshape[1] if entry == "dx" else wshape[0]
            shapes.add((family, b, cin, cout, d, h, w, bool(extra)))
    return sorted(shapes)


RAGGED = [("s2", 2, 3, 70, 9, 17, 35, False), ("s2", 1, 12, 5, 7, 3, 67, True),
          ("t2", 2, 5, 33, 5, 9, 33, True), ("t2", 1, 17, 3, 3, 2, 1, False)]


def test_phase3_shapes_cover_every_f2_site():
    shapes = _phase3_shapes()
    # down0.conv0 (= up0's input gradient), its 216^3 and eval forms, the
    # odd sizes, and the depth-sharded 216^3 forward's two slabs and window,
    # for each map
    assert [s[0] for s in shapes].count("s2") == 7 and [s[0] for s in shapes].count("t2") == 7
    plans = [f2_plan(*s) for s in shapes]
    assert {(p.mode, p.at) for p in plans} == {("s2", 64), ("t2", 32)}
    path = [p for s, p in zip(shapes, plans) if s[2:4] in ((32, 64), (64, 32))]
    # x staged once per brick on the path: one channel tile, about one block an SM
    assert {p.grid[1] for p in path} == {1}
    assert {p.grid[0] * p.grid[2] for p in path} == {F2_BLOCKS}


@pytest.mark.parametrize("shape", _phase3_shapes() + RAGGED, ids=lambda s: "x".join(map(str, s)))
def test_f2_plan_covers_every_output_once(shape):
    mode, b, cin, cout, d, h, w, ps = shape
    plan = f2_plan(*shape)
    assert plan.mode == mode and plan.brick == F2_BRICK and plan.ct == CT
    assert plan.at == (32 if mode == "t2" or cout <= 32 else 64)
    assert all(0 < g <= GRID_MAX for g in plan.grid)
    walk = (_half(d), _half(h), _half(w)) if mode == "s2" else (d, h, w)
    nb = [_cdiv(n, e) for n, e in zip(walk, F2_BRICK)]
    assert plan.bricks == nb[0] * nb[1] * nb[2]
    gx, tiles, gz = plan.grid
    assert gz == b and gx == min(plan.bricks, _cdiv(F2_BLOCKS, tiles * b))
    assert plan.wpack == (b if ps else 1) * tiles * _cdiv(cin, CT) * 27 * 2 * plan.at * CT
    # output channels: tiles of at, none empty
    chans = np.bincount((np.arange(tiles)[:, None] * plan.at
                         + np.arange(plan.at)[None, :]).reshape(-1))[:cout]
    assert (chans == 1).all() and (tiles - 1) * plan.at < cout
    # block x walks bricks x, x + gx, ...: every brick once, the kernel's count
    walked = np.concatenate([np.arange(x, plan.bricks, gx) for x in range(gx)])
    assert np.array_equal(np.sort(walked), np.arange(plan.bricks))
    for x in range(min(gx, 4)):
        assert (plan.bricks - 1 - x) // gx + 1 == len(range(x, plan.bricks, gx))
    # brick bi's origin as the kernel computes it; its positions, masked at
    # the grid's edge, cover the output once (t2: each input's cube)
    bd, bh, bw = F2_BRICK
    org = np.stack([walked // (nb[1] * nb[2]) * bd, walked // nb[2] % nb[1] * bh,
                    walked % nb[2] * bw], axis=1)
    scale = 2 if mode == "t2" else 1
    seen = np.zeros(tuple(scale * n * e for n, e in zip(nb, F2_BRICK)), np.int32)
    for d0, h0, w0 in org * scale:
        seen[d0:d0 + scale * bd, h0:h0 + scale * bh, w0:w0 + scale * bw] += 1
    out = tuple(scale * n for n in walk)
    assert (seen == 1).all() and seen[:out[0], :out[1], :out[2]].sum() == np.prod(out)


def test_f2_plan_raises_on_shapes_it_cannot_cut():
    with pytest.raises(ValueError):
        f2_plan("s1", 1, 4, 4, 8, 8, 8)                      # mode
    with pytest.raises(ValueError):
        f2_plan("s2", 0, 4, 4, 8, 8, 8)                      # no sample
    with pytest.raises(ValueError):
        f2_plan("s2", 1, 4, 4, 2048, 1024, 1024)             # 2^31 input voxels
    with pytest.raises(ValueError):
        f2_plan("t2", 1, 4, 4, 1024, 512, 512)               # 2^31 output voxels
    with pytest.raises(ValueError):
        f2_plan("t2", GRID_MAX + 1, 4, 4, 8, 8, 8)           # samples
    with pytest.raises(ValueError):
        f2_plan("s2", 1, 4, 64 * (GRID_MAX + 1), 8, 8, 8)    # channel tiles
    assert f2_plan("t2", 1, 4, 4, 512, 512, 1023).grid == (F2_BLOCKS, 1, 1)


# ---------------------------------------------------------------- staging
def _split(j, n):
    """Where box position j (0 <= j <= 2n) of an axis of n outputs is
    stored: its n + 1 even positions first, then its n odd ones."""
    return j // 2 if j % 2 == 0 else n + 1 + j // 2


def test_stride2_box_staging_covers_the_box_once():
    # Box32Stager: 256 threads, channel t % 8, row piece t / 8 % 4 of box
    # rows t / 32 + 8 i; element e of piece v is box position 1 + 8 v + e
    # along W, stored at 17 + 4 v + e / 2 (e even) or 4 v + (e + 1) / 2;
    # the pieces' first also stores position 0
    bd, bh, bw = F2_BRICK
    hd, hh, hw = 2 * bd + 1, 2 * bh + 1, 2 * bw + 1
    hrows = hd * hh
    nx = _cdiv(hrows, 256 // (CT * 4))
    seen = np.zeros((hd, hh, hw, CT), np.int32)
    for t, i in itertools.product(range(256), range(nx)):
        c, v, hr = t % CT, t // CT % 4, t // (CT * 4) + 8 * i
        if hr >= hrows:
            continue
        sd, sh = _split(hr // hh, bd), _split(hr % hh, bh)
        for e in range(8):
            s = bw + 1 + 4 * v + e // 2 if e % 2 == 0 else 4 * v + (e + 1) // 2
            assert s == _split(1 + 8 * v + e, bw)
            seen[sd, sh, s, c] += 1
        if v == 0:
            seen[sd, sh, 0, c] += 1
    assert (seen == 1).all()


def test_transposed_box_staging_covers_the_box_once():
    # Halo32Stager: 256 threads, channel t % 8, row piece t / 8 % 2 of box
    # rows t / 16; piece v holds positions 1 + 8 v .. 8 + 8 v and the halo
    # position on its side (0, one below the brick, or bw + 1)
    bd, bh, bw = F2_BRICK
    hrows, hw = (bd + 1) * (bh + 1), bw + 2
    seen = np.zeros((hrows, hw, CT), np.int32)
    for t in range(256):
        c, v, hr = t % CT, t // CT % 2, t // (2 * CT)
        if hr >= hrows:
            continue
        seen[hr, [1 + 8 * v + e for e in range(8)], c] += 1
        seen[hr, hw - 1 if v else 0, c] += 1
    assert (seen == 1).all()


# ------------------------------------------------------------ arithmetic
def tf32(t):
    """f32 -> TF32, to nearest, ties away from zero, by int32 bit
    operations: half a TF32 unit added to the magnitude's bits, the low 13
    bits cleared (the kernels' round_tf32)."""
    return ((t.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def split(t):
    hi = tf32(t)
    return hi, tf32(t - hi)


def pack(w, a_n, c_n, at, flip):
    """tf32_pack_weights: wp[bw][at][ch][t][plane][o][cc] (plane 0 hi, 1
    lo) from w [B?, A, C, 27], or with flip from the forward layer's
    [B?, C, A, 27] read as flip_t(w), through the flat buffer as the kernel
    reads it; zero past A and C."""
    taps = 27
    flat = w.reshape(-1)
    nbw = flat.numel() // (a_n * c_n * taps)
    nat, nch = _cdiv(a_n, at), _cdiv(c_n, CT)
    e = torch.arange(nbw * nat * nch * taps * 2 * at * CT)
    cc, o, plane = e % CT, e // CT % at, e // (CT * at) % 2
    t, r = e // (2 * CT * at) % taps, e // (2 * CT * at * taps)
    ch, ti, bw = r % nch, r // nch % nat, r // (nch * nat)
    a, c = ti * at + o, ch * CT + cc
    inside = (a < a_n) & (c < c_n)
    a, c = a.clamp(max=a_n - 1), c.clamp(max=c_n - 1)
    src = (((bw * c_n + c) * a_n + a) * taps + (taps - 1 - t) if flip
           else ((bw * a_n + a) * c_n + c) * taps + t)
    v = torch.where(inside, flat[src], torch.zeros((), dtype=flat.dtype))
    hi, lo = split(v)
    packed = torch.where(plane == 0, hi, lo)
    return packed.reshape(nbw, nat, nch, taps, 2, at, CT)


# the transposed map's tables (csrc/conv3d_t2_f32_tc.cu, K3's): per axis
# tap k feeds output parity k != 1 from input offset k == 2
def _tap_cls(t):
    return (t // 9 != 1) * 4 + (t // 3 % 3 != 1) * 2 + (t % 3 != 1)


def _tap_off(t):
    return (t // 9 == 2) * 4 + (t // 3 % 3 == 2) * 2 + (t % 3 == 2)


ENTRIES = [t for d in range(8) for t in range(27) if _tap_off(t) == d]


def emulate(mode, x, w, bias, cout, flip, hi_only=False):
    """F2's arithmetic in torch, f32: x [b, cin, d, h, w] -> the stride-2
    conv (mode "s2") or the transposed conv ("t2") with w as the C entry
    takes it (flip: the other conv's weights, read as flip_t(w))."""
    b, cin, d, h, wd = x.shape
    plan = f2_plan(mode, b, cin, cout, d, h, wd, w.dim() == 6)
    at, tiles, nch = plan.at, plan.grid[1], _cdiv(cin, CT)
    wp = pack(w.float(), cout, cin, at, flip)
    xp = torch.zeros((b, nch * CT) + x.shape[2:], dtype=torch.float32)
    xp[:, :cin] = x.float()
    # zero outside the volume: s2 reads 2q + s - 1, t2 reads i + {0, 1}
    xp = torch.nn.functional.pad(xp, (1, 1) * 3 if mode == "s2" else (0, 1) * 3)
    xh, xl = split(xp)
    out = ((_half(d), _half(h), _half(wd)) if mode == "s2" else (d, h, wd))
    y = torch.zeros((b, tiles * at) + tuple(n * (2 if mode == "t2" else 1) for n in out))

    def products(acc, view_h, view_l, wt):
        wh, wl = wt[0], wt[1]  # [at, 8]
        if not hi_only:
            acc += torch.einsum("oc,cdhw->odhw", wh, view_l)
            acc += torch.einsum("oc,cdhw->odhw", wl, view_h)
        acc += torch.einsum("oc,cdhw->odhw", wh, view_h)

    for n, tile in itertools.product(range(b), range(tiles)):
        wn = wp[n if wp.shape[0] > 1 else 0, tile]
        if mode == "s2":
            acc = torch.zeros((at,) + out)
            for ch, t in itertools.product(range(nch), range(27)):
                kd, kh, kw = t // 9, t // 3 % 3, t % 3
                sl = (n, slice(ch * CT, (ch + 1) * CT), slice(kd, kd + 2 * out[0], 2),
                      slice(kh, kh + 2 * out[1], 2), slice(kw, kw + 2 * out[2], 2))
                products(acc, xh[sl], xl[sl], wn[ch, t])
            y[n, tile * at:(tile + 1) * at] = acc
        else:
            acc = torch.zeros((8, at) + out)
            for ch, t in itertools.product(range(nch), ENTRIES):
                od, oh, ow = _tap_off(t) >> 2, (_tap_off(t) >> 1) & 1, _tap_off(t) & 1
                sl = (n, slice(ch * CT, (ch + 1) * CT), slice(od, od + d), slice(oh, oh + h),
                      slice(ow, ow + wd))
                products(acc[_tap_cls(t)], xh[sl], xl[sl], wn[ch, t])
            for c in range(8):
                y[n, tile * at:(tile + 1) * at, c >> 2::2, (c >> 1) & 1::2, c & 1::2] = acc[c]
    y = y[:, :cout]
    if bias is not None:
        y = y + bias.float().reshape(1, -1, 1, 1, 1)
    return y


def _plain(mode, x, w, bias, flip):
    wt = flip_t(w) if flip else w
    return (conv3d_ref(x, wt, bias, stride=2) if mode == "s2"
            else conv_transpose3d_ref(x, wt, bias))


def _operands(b, cin, cout, spatial, per_sample, flip, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((b, cin) + spatial).astype(np.float32))
    # flip: w is the other conv's [B?, cout_f = cin, cin_f = cout] weights
    wshape = ((b,) if per_sample else ()) + ((cin, cout) if flip else (cout, cin)) + (3, 3, 3)
    w = torch.from_numpy((rng.standard_normal(wshape) / (cin * 27) ** 0.5).astype(np.float32))
    bias = None if flip else torch.from_numpy(rng.standard_normal(cout).astype(np.float32))
    return x, w, bias


@pytest.mark.parametrize("mode,spatial", [
    ("s2", (9, 17, 35)), ("s2", (8, 6, 32)), ("t2", (5, 9, 33)), ("t2", (4, 3, 16))],
    ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else str(v))
@pytest.mark.parametrize("per_sample", [False, True])
@pytest.mark.parametrize("flip", [False, True])
def test_f2_emulation_matches_plain(mode, spatial, per_sample, flip):
    b, cin, cout = 2, 12, 6  # two chunks of 8, the second zero-padded
    x, w, bias = _operands(b, cin, cout, spatial, per_sample, flip, seed=len(spatial) + cin)
    want = _plain(mode, x.double(), w.double(), None if bias is None else bias.double(), flip)
    got = emulate(mode, x, w, bias, cout, flip)
    assert got.shape == want.shape
    scale = float(want.abs().max())
    err = float((got.double() - want).abs().max())
    assert err <= TOL * scale
    err_hi = float((emulate(mode, x, w, bias, cout, flip, hi_only=True).double()
                    - want).abs().max())
    assert err_hi >= HI_RATIO * err


def test_tf32_rounds_half_away_from_zero():
    ulp = 2.0 ** -10  # a TF32 unit at 1
    x = torch.tensor([1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 2 - 2 ** -23, 1 + 1.5 * ulp,
                      3.0e-39, 0.0], dtype=torch.float32)
    want = torch.tensor([1 + ulp, -(1 + ulp), 1.0, 1 + 2 * ulp, 3.0e-39, 0.0],
                        dtype=torch.float32)
    got = tf32(x)
    assert torch.equal(got[:4], want[:4]) and got[5] == 0.0
    assert (got.view(torch.int32) & 0x1fff == 0).all()
    hi, lo = split(torch.tensor([1 / 3], dtype=torch.float32))
    assert abs(float(hi) + float(lo) - 1 / 3) < 2 ** -21 * (1 / 3)


@pytest.mark.parametrize("mode", ["s2", "t2"])
def test_f2_emulation_matches_jax(mode):
    rng = np.random.default_rng(21)
    b, cin, cout = 2, 12, 6
    x = rng.standard_normal((b, cin) + ((8, 8, 16) if mode == "s2" else (4, 4, 8)))
    x = x.astype(np.float32)
    w = (rng.standard_normal((b, cout, cin, 3, 3, 3)) / (cin * 27) ** 0.5).astype(np.float32)
    got = emulate(mode, torch.from_numpy(x), torch.from_numpy(w), None, cout, False).numpy()
    if mode == "s2":
        want = strided.unpack_w(strided._s2_fwd(jnp.asarray(x), jnp.asarray(w), interpret=True))
    else:
        want = strided._t2_fwd(strided.pack_w(jnp.asarray(x)), jnp.asarray(w), interpret=True)
    want = np.asarray(want)
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= TOL * float(np.abs(want).max())
