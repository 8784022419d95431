"""F1, the float32 stride-1 conv on the tensor cores in 3xTF32
(`csrc/conv3d_s1_f32_tc.cu`, shared pieces in `csrc/tf32_common.cuh`),
checked on the CPU, where no kernel runs.

(a) The cut, `ops/conv3d.py:f1_plan`: at every K1 shape of `chip_smoke.py`
    phase 3 (the float32 path shares them; phase 3 runs F1 at those of
    F32_SITES) and at ragged ones, the blocks walk every brick of a sample
    once, the bricks cover every output position once, the channel tiles
    every output channel once, every sample has its blocks; its tile fits
    the blocks an SM it counts on; a shape it cannot cut raises.
(b) The kernel's maps: the X staging (half-warps over the 16 brick
    positions of a (channel, row), other threads over the two W-halo
    positions) fills the halo brick once, zero outside the volume and past
    Cin; the warps' ldmatrix rows, tap offsets and epilogue stores give
    every output position and channel of a brick exactly once, each from
    the halo rows its taps read.
(c) A torch emulation of the kernel's arithmetic -- the weight packing's hi
    and lo TF32 planes read through the C entry's strides (flip_t(w) in
    place for the input gradient), x split into hi and lo, TF32 rounding by
    int32 bit operations (round half away from zero), per chunk of 8 input
    channels the taps in the kernel's order (kd-major, t ascending), per
    tap lo_x hi_w, hi_x lo_w, then hi_x hi_w, into the tap group's (one
    kd's) partial, the partials added to the running sums in step order,
    f32 -- is within 1e-5 of
    max|plain| of the f64 plain version, for k in {1, 3}, shared and
    per-sample weights, with and without flip; the same emulation with hi
    parts only (1xTF32) reads at least 10x more.
(d) One k = 3 and one k = 1 case of the emulation match the JAX package's
    `conv3d.py:_pallas_conv3d_fwd` at f32 (Pallas interpret mode, as the
    JAX tests run it).
"""

import itertools

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from coma_unet_tpu.ops.pallas.conv3d import _pallas_conv3d_fwd  # noqa: E402
from coma_unet_tpu_torch.ops.conv3d import (  # noqa: E402
    F1_BLOCKS,
    F1_CT,
    GRID_MAX,
    S1_BH,
    S1_BW,
    SMEM_MAX,
    channel_tile,
    conv3d_ref,
    f1_plan,
    flip_t,
)

TOL = 1e-5      # 3xTF32 against f64, of max|plain|
HI_RATIO = 10   # 1xTF32 reads at least this many times more
CT = F1_CT
XS = 12         # floats an X row (tf32_common.cuh)
THREADS = 256


def _cdiv(a, b):
    return -(-a // b)


def _phase3_shapes():
    """(b, cin, cout, d, h, w, k, per_sample) of every K1 case of phase 3,
    as the kernel sees it (an input gradient: the cotangent in)."""
    shapes = set()
    for family, _, xshape, wshape, extra, entry in chip_smoke._kernel_cases():
        if family == "s1":
            b, cin, d, h, w = xshape
            cout = wshape[1] if entry == "dx" else wshape[0]
            shapes.add((b, cin, cout, d, h, w, wshape[-1], bool(extra)))
    return sorted(shapes)


RAGGED = [(2, 5, 3, 9, 10, 37, 3, False), (1, 9, 17, 5, 3, 33, 1, True),
          (2, 3, 70, 9, 17, 35, 3, True), (3, 17, 40, 5, 9, 33, 1, False)]


class Cfg:
    """The kernel's compile-time sizes (csrc/conv3d_s1_f32_tc.cu:S1)."""

    def __init__(self, k, bd, at):
        self.k, self.bd, self.at = k, bd, at
        self.r = k // 2
        self.hd, self.hh, self.hw = bd + 2 * self.r, S1_BH + 2 * self.r, S1_BW + 2 * self.r
        self.hrows = self.hd * self.hh
        self.wn = 2 if at >= 64 else 1
        self.wm = 8 // self.wn
        self.mt, self.nt = bd * S1_BH // self.wm, at // 8 // self.wn
        self.nj = self.hrows * CT // 16
        self.ne = _cdiv(2 * self.hrows * CT, THREADS) if self.r else 0
        self.xelems = self.hrows * self.hw * XS
        self.wstage = k * k * 2 * at * CT
        # X and W, two buffers each, and the running sums, 16 bytes a tile a thread
        self.smem = (2 * self.xelems + 2 * self.wstage) * 4 + self.mt * self.nt * THREADS * 16
        self.min_blocks = 1 if self.mt * self.nt >= 8 else 2


def test_phase3_shapes_cover_every_f1_site():
    shapes = _phase3_shapes()
    # 28 shapes of x and w, one of them with shared and per-sample weights;
    # and 5 of the depth-sharded 216^3 forward (slabs and 3-plane windows)
    assert len(shapes) == 34 and len({s[:7] for s in shapes}) == 33
    plans = [f1_plan(*s) for s in shapes]
    assert {(p.k, p.brick[0], p.at) for p in plans} >= {(3, 4, 64), (3, 8, 32), (3, 4, 16),
                                                        (3, 4, 8), (1, 4, 16), (1, 4, 8)}
    wide = [p for s, p in zip(shapes, plans) if s[6] == 3 and min(s[1:3]) >= 32]
    # the wide sites: one block an SM, about one a streaming multiprocessor
    assert {p.per_sm for p in wide} == {1}
    assert all(F1_BLOCKS <= p.grid[0] * p.grid[1] * p.grid[2] < F1_BLOCKS + p.grid[1] * p.grid[2]
               for p in wide)


@pytest.mark.parametrize("shape", _phase3_shapes() + RAGGED, ids=lambda s: "x".join(map(str, s)))
def test_f1_plan_covers_every_output_once(shape):
    b, cin, cout, d, h, w, k, ps = shape
    plan = f1_plan(*shape)
    at = channel_tile(cout)
    bd = 8 if k == 3 and at == 32 else 4
    assert (plan.k, plan.brick, plan.ct, plan.at) == (k, (bd, S1_BH, S1_BW), CT, at)
    cfg = Cfg(k, bd, at)
    # the tile's blocks an SM fit its shared memory (1 KB reserved a block)
    assert plan.per_sm == cfg.min_blocks
    assert cfg.min_blocks * (cfg.smem + 1024) <= SMEM_MAX + 1024
    assert cfg.mt * cfg.wm == bd * S1_BH and cfg.nt * cfg.wn * 8 == at
    assert cfg.wm % S1_BH == 0 and (cfg.hrows * CT) % 16 == 0
    assert all(0 < g <= GRID_MAX for g in plan.grid)
    nb = [_cdiv(n, e) for n, e in zip((d, h, w), plan.brick)]
    assert plan.bricks == nb[0] * nb[1] * nb[2]
    gx, tiles, gz = plan.grid
    assert gz == b and tiles == _cdiv(cout, at)
    assert gx == min(plan.bricks, _cdiv(F1_BLOCKS * plan.per_sm, tiles * b))
    assert plan.wpack == (b if ps else 1) * tiles * _cdiv(cin, CT) * k ** 3 * 2 * at * CT
    # output channels: tiles of at, none empty
    chans = np.bincount((np.arange(tiles)[:, None] * at + np.arange(at)[None, :]).reshape(-1))
    assert (chans[:cout] == 1).all() and (tiles - 1) * at < cout
    # block x walks bricks x, x + gx, ...: every brick once, the kernel's
    # step count ((nb - 1 - x) / gx + 1 bricks of nch * k steps)
    walked = np.concatenate([np.arange(x, plan.bricks, gx) for x in range(gx)])
    assert np.array_equal(np.sort(walked), np.arange(plan.bricks))
    for x in range(min(gx, 4)):
        assert (plan.bricks - 1 - x) // gx + 1 == len(range(x, plan.bricks, gx))
    # brick bi's origin as the kernel computes it; its positions, masked at
    # the volume's edge, cover the output once
    org = np.stack([walked // (nb[1] * nb[2]) * bd, walked // nb[2] % nb[1] * S1_BH,
                    walked % nb[2] * S1_BW], axis=1)
    seen = np.zeros(tuple(n * e for n, e in zip(nb, plan.brick)), np.int32)
    for d0, h0, w0 in org:
        seen[d0:d0 + bd, h0:h0 + S1_BH, w0:w0 + S1_BW] += 1
    assert (seen == 1).all() and seen[:d, :h, :w].sum() == d * h * w


def test_f1_plan_raises_on_shapes_it_cannot_cut():
    with pytest.raises(ValueError):
        f1_plan(1, 4, 4, 8, 8, 8, 5)                          # k
    with pytest.raises(ValueError):
        f1_plan(0, 4, 4, 8, 8, 8, 3)                          # no sample
    with pytest.raises(ValueError):
        f1_plan(1, 4, 4, 2048, 1024, 1024, 3)                 # 2^31 voxels
    with pytest.raises(ValueError):
        f1_plan(GRID_MAX + 1, 4, 4, 8, 8, 8, 3)               # samples
    with pytest.raises(ValueError):
        f1_plan(1, 4, 64 * (GRID_MAX + 1), 8, 8, 8, 1)        # channel tiles
    assert f1_plan(1, 4, 4, 1024, 1024, 2047, 3).grid == (2 * F1_BLOCKS, 1, 1)


# ------------------------------------------------------------- the maps
def stage_x(x, cfg, c0, d0, h0, w0):
    """The kernel's stage_x for one sample x [C, D, H, W]: the halo brick
    [HROWS * HW][XS] (NaN where nothing is written, so a gap shows), each
    thread's copies as the kernel issues them, zero where the source is
    outside the volume or past C. Returns it and the write count."""
    c_n, d_n, h_n, w_n = x.shape
    sx = np.full((cfg.hrows * cfg.hw, XS), np.nan)
    count = np.zeros(sx.shape, np.int32)

    def copy(row, c, d, h, w):
        ok = c0 + c < c_n and 0 <= d < d_n and 0 <= h < h_n and 0 <= w < w_n
        sx[row, c] = x[c0 + c, d, h, w] if ok else 0.0
        count[row, c] += 1

    for tid in range(THREADS):
        c, i16 = (tid >> 4) & 7, tid & 15
        for i in range(cfg.nj):
            hr = (tid >> 7) + 2 * i
            copy(hr * cfg.hw + cfg.r + i16, c, d0 - cfg.r + hr // cfg.hh,
                 h0 - cfg.r + hr % cfg.hh, w0 + i16)
        if cfg.r:
            side, c = tid & 1, (tid >> 1) & 7
            for i in range(cfg.ne):
                hr = (tid >> 4) + 16 * i
                if hr < cfg.hrows:
                    copy(hr * cfg.hw + (cfg.hw - 1 if side else 0), c,
                         d0 - cfg.r + hr // cfg.hh, h0 - cfg.r + hr % cfg.hh,
                         w0 + S1_BW if side else w0 - 1)
    return sx, count


@pytest.mark.parametrize("k,bd", [(3, 4), (3, 8), (1, 4)])
@pytest.mark.parametrize("where", ["corner", "inside", "ragged edge"])
def test_x_staging_fills_the_halo_brick_once(k, bd, where):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((11, 9, 10, 37))  # C = 11: the second chunk pads 5 channels
    cfg = Cfg(k, bd, 16)
    c0, org = {"corner": (0, (0, 0, 0)), "inside": (0, (4, 4, 16)),
               "ragged edge": (8, (8, 8, 32))}[where]
    sx, count = stage_x(x, cfg, c0, *org)
    assert (count[:, :CT] == 1).all() and (count[:, CT:] == 0).all()
    # the reference: x zero-padded by R on each side (and past C), sliced
    r = cfg.r
    xp = np.zeros((max(x.shape[0], c0 + CT),) + tuple(n + 2 * r + 16 for n in x.shape[1:]))
    xp[:x.shape[0], r:r + x.shape[1], r:r + x.shape[2], r:r + x.shape[3]] = x
    d0, h0, w0 = org
    want = xp[c0:c0 + CT, d0:d0 + cfg.hd, h0:h0 + cfg.hh, w0:w0 + cfg.hw]
    want = want.transpose(1, 2, 3, 0).reshape(-1, CT)
    assert np.array_equal(sx[:, :CT], want)


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("at", [8, 16, 32, 64])
def test_warps_read_their_taps_and_store_every_output_once(k, at):
    # a_off, MSTEP, toff and the group offset as the kernel forms them (in
    # X rows: the byte offsets / (XS * 4)); ldmatrix's lane l reads row
    # l % 16 of its m16 tile (unit l / 16), and mma's c[r] of lane l is
    # position l / 4 + 8 (r / 2), channel 2 (l % 4) + r % 2 of the tile
    bd = 8 if k == 3 and at == 32 else 4
    cfg = Cfg(k, bd, at)
    stores = np.zeros((at, bd, S1_BH, S1_BW), np.int32)
    for warp in range(8):
        wm, n0 = warp % cfg.wm, warp // cfg.wm * cfg.nt
        a_row = ((wm // S1_BH) * cfg.hh + wm % S1_BH) * cfg.hw
        mstep = (cfg.wm // S1_BH) * cfg.hh * cfg.hw
        for m in range(cfg.mt):
            q = wm + m * cfg.wm
            dd, hh = q // S1_BH, q % S1_BH
            for kd, j, lane in itertools.product(range(k), range(k * k), range(32)):
                kh, kw = j // k, j % k
                row = a_row + m * mstep + kd * cfg.hh * cfg.hw + kh * cfg.hw + kw + (lane & 15)
                # the halo row of output (dd, hh, lane % 16) at tap (kd, kh, kw)
                assert row == ((dd + kd) * cfg.hh + hh + kh) * cfg.hw + (lane & 15) + kw
            for n, r, lane in itertools.product(range(cfg.nt), range(4), range(32)):
                o = (n0 + n) * 8 + (lane & 3) * 2 + (r & 1)
                stores[o, dd, hh, (lane >> 2) + (r >> 1) * 8] += 1
    assert (stores == 1).all()


# ------------------------------------------------------------ arithmetic
def tf32(t):
    """f32 -> TF32, to nearest, ties away from zero, by int32 bit
    operations (the kernel's round_tf32)."""
    return ((t.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def split(t):
    hi = tf32(t)
    return hi, tf32(t - hi)


def pack(w, a_n, c_n, at, taps, flip):
    """tf32_pack_weights<taps>: wp[bw][at][ch][t][plane][o][cc] (plane 0
    hi, 1 lo) from w [B?, A, C, taps], or with flip from the forward
    layer's [B?, C, A, taps] read as flip_t(w), through the flat buffer as
    the kernel reads it; zero past A and C."""
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
    return torch.where(plane == 0, hi, lo).reshape(nbw, nat, nch, taps, 2, at, CT)


def emulate(x, w, bias, cout, flip, hi_only=False):
    """F1's arithmetic in torch, f32: x [b, cin, d, h, w] -> the stride-1
    SAME conv with w as the C entry takes it (flip: the forward layer's
    weights, read as flip_t(w))."""
    b, cin, d, h, wd = x.shape
    k = w.shape[-1]
    plan = f1_plan(b, cin, cout, d, h, wd, k, w.dim() == 6)
    at, tiles, nch, taps, r = plan.at, plan.grid[1], _cdiv(cin, CT), k ** 3, k // 2
    wp = pack(w.float(), cout, cin, at, taps, flip)
    xp = torch.zeros((b, nch * CT, d, h, wd), dtype=torch.float32)
    xp[:, :cin] = x.float()
    xh, xl = split(torch.nn.functional.pad(xp, (r, r) * 3))  # zero outside the volume
    y = torch.zeros((b, tiles * at, d, h, wd))
    for n, tile in itertools.product(range(b), range(tiles)):
        wn = wp[n if wp.shape[0] > 1 else 0, tile]
        total = torch.zeros((at, d, h, wd))  # the running sums over the tap groups
        for ch, kd in itertools.product(range(nch), range(k)):
            acc = torch.zeros((at, d, h, wd))  # the group's partial
            for t in range(kd * k * k, (kd + 1) * k * k):
                kh, kw = t // k % k, t % k
                sl = (n, slice(ch * CT, (ch + 1) * CT), slice(kd, kd + d), slice(kh, kh + h),
                      slice(kw, kw + wd))
                wh, wl = wn[ch, t, 0], wn[ch, t, 1]  # [at, 8]
                if not hi_only:
                    acc += torch.einsum("oc,cdhw->odhw", wh, xl[sl])
                    acc += torch.einsum("oc,cdhw->odhw", wl, xh[sl])
                acc += torch.einsum("oc,cdhw->odhw", wh, xh[sl])
            total += acc
        y[n, tile * at:(tile + 1) * at] = total
    y = y[:, :cout]
    if bias is not None:
        y = y + bias.float().reshape(1, -1, 1, 1, 1)
    return y


def _operands(b, cin, cout, spatial, k, per_sample, flip, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((b, cin) + spatial).astype(np.float32))
    # flip: w is the forward layer's [B?, cout_f = cin, cin_f = cout] weights
    wshape = ((b,) if per_sample else ()) + ((cin, cout) if flip else (cout, cin)) + (k,) * 3
    w = torch.from_numpy((rng.standard_normal(wshape) / (cin * k ** 3) ** 0.5).astype(np.float32))
    bias = None if flip else torch.from_numpy(rng.standard_normal(cout).astype(np.float32))
    return x, w, bias


@pytest.mark.parametrize("k,spatial", [(3, (5, 9, 35)), (3, (8, 4, 16)), (1, (3, 5, 37)),
                                       (1, (4, 8, 16))],
                         ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else str(v))
@pytest.mark.parametrize("per_sample", [False, True])
@pytest.mark.parametrize("flip", [False, True])
def test_f1_emulation_matches_plain(k, spatial, per_sample, flip):
    b, cin, cout = 2, 12, 6  # two chunks of 8, the second zero-padded
    x, w, bias = _operands(b, cin, cout, spatial, k, per_sample, flip, seed=len(spatial) + k)
    wt = flip_t(w.double()) if flip else w.double()
    want = conv3d_ref(x.double(), wt, None if bias is None else bias.double())
    got = emulate(x, w, bias, cout, flip)
    assert got.shape == want.shape
    scale = float(want.abs().max())
    err = float((got.double() - want).abs().max())
    assert err <= TOL * scale
    err_hi = float((emulate(x, w, bias, cout, flip, hi_only=True).double() - want).abs().max())
    assert err_hi >= HI_RATIO * err


@pytest.mark.parametrize("k", [3, 1])
def test_f1_emulation_matches_jax(k):
    rng = np.random.default_rng(23 + k)
    b, cin, cout = 2, 12, 6
    x = rng.standard_normal((b, cin, 4, 8, 128)).astype(np.float32)
    w = (rng.standard_normal((cout, cin) + (k,) * 3) / (cin * k ** 3) ** 0.5).astype(np.float32)
    got = emulate(torch.from_numpy(x), torch.from_numpy(w), None, cout, False).numpy()
    want = np.asarray(_pallas_conv3d_fwd(jnp.asarray(x), jnp.asarray(w), k, interpret=True))
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= TOL * float(np.abs(want).max())
