"""FB1, the float32 weight gradients on the tensor cores in 3xTF32
(`csrc/conv3d_dw_f32_tc.cu`, shared pieces in `csrc/tf32_common.cuh`),
checked on the CPU, where no kernel runs. Both maps: S1, the stride-1 conv's
dW (k in {1, 3}; X = x, G = g), and S2, the strided map (k = 3; X = full,
G = half), which serves the stride-2 conv and its transpose.

(a) The cut, `ops/conv3d.py:fb1_plan`: at every weight-gradient shape of
    `chip_smoke.py` phase 3 (the float32 path shares them) and at ragged
    ones, the splits walk every brick of every sample once, the bricks cover
    every position of G's grid once, the tiles every channel pair once; the
    stages fit shared memory and the blocks an SM the plan counts on; the
    plan takes only the tiles the C entry dispatches; a shape it cannot cut
    raises.
(b) The kernel's maps: the box staging (8 channels x 4 positions a warp's
    copies, zero outside the volume and past the channels, S2 split by
    parity along every axis) fills X's box once and G's tile once (16-byte
    and 4-byte copies); every fragment register of every warp holds the
    operand its mma position needs (the tap-shifted box position of X, the
    brick position of G), an X fragment's 32 loads and the box's staging
    writes fall in distinct banks, and every output (channel pair, tap) of a
    tile is stored exactly once.
(c) A torch emulation of the kernel's arithmetic -- TF32 rounding by int32
    bit operations (round half away from zero), both operands split into hi
    and lo, per k8 step lo_A hi_B, hi_A lo_B, then hi_A hi_B (A = X, or G
    where G's channels are on M), each run of at most 8 of a warp's steps
    into a partial, the partials added to running sums in f32 in step order,
    k = 1's eight warps summed in warp order, the splits in split order --
    is within 1e-5 of max|plain| of the f64 plain version, for both maps,
    k in {1, 3}, shared and per-sample weights, Cin = 1 and Cout = 1; the
    same emulation with hi parts only (1xTF32) reads at least 10x more.
(d) One S1 and one strided case of the emulation match the JAX package's
    `conv3d.py:_pallas_conv3d_dw` and `conv3d_strided.py:_dw_dil` at f32
    (Pallas interpret mode, as the JAX tests run them).
"""

import itertools
import re
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
import coma_unet_tpu.ops.pallas.conv3d as c3  # noqa: E402
import coma_unet_tpu.ops.pallas.conv3d_strided as strided  # noqa: E402
from coma_unet_tpu_torch.ops.conv3d import (  # noqa: E402
    FB1_BLOCKS,
    FB1_SWAP,
    GRID_MAX,
    SMEM_MAX,
    conv3d_weight_ref,
    fb1_plan,
)

TOL = 1e-5      # 3xTF32 against f64, of max|plain|
HI_RATIO = 10   # 1xTF32 reads at least this many times more
BH, BW = 4, 16
RUN = 8         # k8 steps a partial at most (csrc/conv3d_dw_f32_tc.cu:RUN)
SOURCE = Path(__file__).resolve().parents[1] / "coma_unet_tpu_torch" / "csrc" / \
    "conv3d_dw_f32_tc.cu"


def _cdiv(a, b):
    return -(-a // b)


def _half(n):
    return (n - 1) // 2 + 1


def shift(s, n):
    """The stored offset of tap offset s along an axis of n brick positions
    of the parity-split box (tc_common.cuh:shift)."""
    return 0 if s == 0 else n + 1 if s == 1 else 1


def split(j, n):
    """Where box coordinate j (0 <= j <= 2n) is stored: evens first (j may
    be an array)."""
    return np.where(j % 2 == 0, j // 2, n + 1 + j // 2)


class Cfg:
    """The kernel's compile-time sizes (csrc/conv3d_dw_f32_tc.cu:Fb1)."""

    def __init__(self, mode, k, sw, mt, nt):
        self.mode, self.k, self.sw, self.mt, self.nt = mode, k, sw, mt, nt
        self.bd = 1 if mode == 1 else 4 if k == 3 else 2
        self.p = self.bd * BH * BW
        self.ksteps = self.p // 8
        self.t = k ** 3
        self.warps = 8
        self.threads = 32 * self.warps
        self.tw = 4 if k == 3 else 1      # taps a warp at most: w + 8 i < k^3
        self.j = 1 if k == 3 else 8
        self.nq = self.ksteps // self.j
        self.runq = min(self.nq, RUN)
        self.xc = 8 * nt if sw else 16 * mt
        self.gc = 16 * mt if sw else 8 * nt
        self.rs = self.xc + 8 if self.xc % 16 == 0 else self.xc
        self.r = 0 if mode == 1 else k // 2
        if mode == 1:
            self.box = (2 * self.bd + 1, 2 * BH + 1, 2 * BW + 1)
        else:
            self.box = (self.bd + 2 * self.r, BH + 2 * self.r, BW + 2 * self.r)
        self.hd, self.hh, self.hw = self.box
        self.npos = self.hd * self.hh * self.hw
        self.xelems = self.npos * self.rs
        self.gs = self.p + 4
        self.gelems = self.gc * self.gs
        self.stage = self.xelems + self.gelems
        self.acc = k * mt * nt * 4
        self.red = self.warps * self.acc * 32 if self.j > 1 else 0
        self.smem = max(2 * self.stage, self.red) * 4
        self.minb = 2 if k == 1 else 1
        self.xrows = self.hd * self.hh * (self.xc // 8)
        self.wsteps = _cdiv(self.hw, 4)

    def unsplit(self, s, n):
        if self.mode == 1:
            return 2 * s if s <= n else 2 * (s - n) - 1
        return s

    def toff(self, t):
        """The kernel's stored box offset of tap t (kd, kh, kw), positions."""
        k = self.k
        if self.mode == 1:
            return ((shift(t // 9, self.bd) * self.hh + shift(t // 3 % 3, BH)) * self.hw
                    + shift(t % 3, BW))
        return ((t // (k * k)) * self.hh + t // k % k) * self.hw + t % k

    def stored(self, coord):
        """The stored box position of box coordinate (jd, jh, jw) (arrays
        or ints)."""
        jd, jh, jw = coord
        if self.mode == 1:
            jd, jh, jw = split(jd, self.bd), split(jh, BH), split(jw, BW)
        return (jd * self.hh + jh) * self.hw + jw


def _dispatched():
    """(mode, k, sw, mt, nt) of every tile the C entry dispatches."""
    text = SOURCE.read_text()
    got = re.findall(r"COMA_FB1\((S[12]), (\d), (true|false), (\d), (\d)\);", text)
    return sorted((int(m[1]) - 1, int(k), sw == "true", int(mt), int(nt))
                  for m, k, sw, mt, nt in got)


def _cfg(plan):
    return Cfg(plan.mode, plan.k, plan.swap, plan.mt, plan.nt)


# ---------------------------------------------------------------- (a) the cut
def _phase3_shapes():
    """(mode, b, cin, cout, d, h, w, k) of every KB1 and KB2 case of phase
    3 (the float32 path runs FB1 at the same shapes): X (x; full)
    [b, cin, d, h, w], cout channels of G (g; half)."""
    shapes = set()
    for family, _, xshape, wshape, _, _ in chip_smoke._kernel_cases():
        if family == "s1_dw":
            b, ci, d, h, w = xshape
            shapes.add(("s1", b, ci, wshape[0], d, h, w, wshape[1]))
        elif family == "strided_dw":
            b, ci, d, h, w = xshape
            shapes.add(("s2", b, ci, wshape[1], d, h, w, 3))
    return sorted(shapes)


RAGGED = [("s1", 2, 5, 3, 9, 10, 37, 3), ("s1", 1, 9, 17, 5, 3, 33, 1),
          ("s1", 3, 1, 40, 7, 5, 19, 3), ("s1", 2, 3, 1, 6, 9, 17, 1),
          ("s2", 2, 3, 5, 9, 17, 35, 3), ("s2", 1, 40, 1, 7, 10, 21, 3)]


def test_phase3_shapes_take_every_tile_the_kernel_has():
    shapes = _phase3_shapes()
    assert len(shapes) == 28 and {s[0] for s in shapes} == {"s1", "s2"}
    taken = {(p.mode, p.k, p.swap, p.mt, p.nt) for p in (fb1_plan(*s[:7], k=s[7])
                                                          for s in shapes + RAGGED)}
    dispatched = set(_dispatched())
    assert len(dispatched) == 10
    assert taken <= dispatched
    # the path's sites: the wide ones X on M with 4 n-tiles; Cin = 1 (head.conv0)
    # G on M; Cout = 1 one n-tile; k = 1 and the strided map their own tiles
    assert {(0, 3, False, 1, 4), (0, 3, True, 2, 1), (0, 3, False, 1, 1), (0, 1, False, 1, 2),
            (0, 1, False, 1, 1), (1, 3, False, 1, 4)} <= taken
    head = fb1_plan("s1", 2, 32, 32, 128, 128, 128, 3)
    assert (head.ct, head.at, head.per_sm) == (16, 32, 1)
    assert head.grid[0] * head.grid[1] * head.grid[2] == FB1_BLOCKS


@pytest.mark.parametrize("shape", _phase3_shapes() + RAGGED, ids=lambda s: "x".join(map(str, s)))
def test_fb1_plan_covers_every_position_and_channel_once(shape):
    mode, b, cin, cout, d, h, w, k = shape
    plan = fb1_plan(mode, b, cin, cout, d, h, w, k)
    cfg = _cfg(plan)
    m = {"s1": 0, "s2": 1}[mode]
    assert (plan.mode, plan.k) == (m, k)
    assert plan.swap == (m == 0 and cin < FB1_SWAP)
    assert (plan.ct, plan.at, plan.threads) == (cfg.xc, cfg.gc, cfg.threads)
    assert plan.brick == (cfg.bd, BH, BW) and plan.box == cfg.box and plan.row == cfg.rs
    assert plan.smem == cfg.smem <= SMEM_MAX
    # the blocks an SM the plan counts on fit (1 KB reserved a block)
    assert plan.per_sm == cfg.minb and plan.per_sm * (plan.smem + 1024) <= 228 * 1024
    # the smallest n-tile count that holds the layer (X on M), or m-tiles (G on M)
    if plan.swap:
        assert plan.nt == 1 and plan.mt == (2 if k == 3 and cout > 16 else 1)
    else:
        assert plan.mt == 1 and plan.nt == (4 if m == 1 or cout > 16 else 1 if cout <= 8
                                            else 2)
    size = (_half(d), _half(h), _half(w)) if m == 1 else (d, h, w)
    nb = [_cdiv(n, e) for n, e in zip(size, plan.brick)]
    assert plan.bricks == nb[0] * nb[1] * nb[2]
    assert plan.grid == (_cdiv(cin, plan.ct), _cdiv(cout, plan.at), plan.splits)
    assert plan.splits == b * plan.splits_per_sample == b * _cdiv(plan.bricks, plan.bps)
    assert max(plan.grid[1:]) <= GRID_MAX and plan.positions == plan.bps * cfg.p
    assert plan.workspace == plan.splits * cout * cin * k ** 3
    # at most one wave of FB1_BLOCKS x per_sm blocks (one split a sample
    # where the tiles and samples alone hold more)
    tiles = plan.grid[0] * plan.grid[1]
    blocks = tiles * plan.splits
    want = max(1, FB1_BLOCKS * plan.per_sm // (tiles * b))
    assert plan.splits_per_sample == _cdiv(plan.bricks, _cdiv(plan.bricks, want))
    assert blocks <= max(FB1_BLOCKS * plan.per_sm, tiles * b)
    # each sample's bricks once over its splits, none empty
    seen = np.zeros((b, plan.bricks), np.int32)
    for s in range(plan.splits):
        j0 = s % plan.splits_per_sample * plan.bps
        j1 = min(j0 + plan.bps, plan.bricks)
        assert j0 < j1
        seen[s // plan.splits_per_sample, j0:j1] += 1
    assert (seen == 1).all()
    # each brick's positions (its origin as the kernel computes it, masked at
    # the grid's edge) tile G's grid once
    j = np.arange(plan.bricks)
    org = np.stack([j // (nb[1] * nb[2]) * cfg.bd, j % (nb[1] * nb[2]) // nb[2] * BH,
                    j % nb[2] * BW], 1)
    cover = np.zeros(tuple(n * e for n, e in zip(nb, plan.brick)), np.int32)
    for d0, h0, w0 in org:
        cover[d0:d0 + cfg.bd, h0:h0 + BH, w0:w0 + BW] += 1
    assert (cover == 1).all()
    # the tiles: every channel of X and of G once, the last tiles not empty
    for n_ch, t, tiles_n in ((cin, plan.ct, plan.grid[0]), (cout, plan.at, plan.grid[1])):
        ch = (np.arange(tiles_n)[:, None] * t + np.arange(t)[None, :]).reshape(-1)
        assert (np.bincount(ch)[:n_ch] == 1).all() and (tiles_n - 1) * t < n_ch


def test_fb1_plan_raises_on_shapes_it_cannot_cut():
    with pytest.raises(ValueError):
        fb1_plan("s1", 1, 4, 4, 2048, 1024, 1024, 3)            # 2^31 voxels
    with pytest.raises(ValueError):
        fb1_plan("s2", 1, 4, 4, 8, 8, 8, 1)                     # the strided map takes k = 3
    with pytest.raises(ValueError):
        fb1_plan("s1", 1, 4, 4, 8, 8, 8, 5)                     # k
    with pytest.raises(ValueError):
        fb1_plan("s1", 0, 4, 4, 8, 8, 8, 3)                     # no sample
    with pytest.raises(ValueError):
        fb1_plan("s1", 1, 16, 32 * (GRID_MAX + 1), 8, 8, 8, 3)  # G tiles
    with pytest.raises(ValueError):
        fb1_plan("s1", GRID_MAX + 1, 16, 16, 4, 4, 16, 3)       # splits
    assert fb1_plan("s1", 1, 16, 32 * GRID_MAX, 8, 8, 8, 3).grid[1] == GRID_MAX


# ---------------------------------------------------------------- (b) the maps
def _stage_x(cfg, x, c0, org):
    """The kernel's stage() of X's box for one sample x [C, D, H, W] at the
    brick whose origin in G's grid is org: [npos * rs] words (NaN where
    nothing is written), the write count, and the word index of each warp
    step's 32 copies (a warp takes item = (stored row, 8-channel group),
    lane l channel l % 8 at stored position 4 i + (l / 8) % 4 of step i)."""
    c_n, d_n, h_n, w_n = x.shape
    o = [2 * v - 1 if cfg.mode == 1 else v - cfg.r for v in org]
    lanes = np.arange(32)
    cl, pl = lanes & 7, (lanes >> 3) & 3
    sx = np.full(cfg.npos * cfg.rs, np.nan)
    count = np.zeros(sx.size, np.int64)
    steps = []
    for item in range(cfg.xrows):
        c = item % (cfg.xc // 8) * 8 + cl
        sr = item // (cfg.xc // 8)
        d = o[0] + cfg.unsplit(sr // cfg.hh, cfg.bd)
        h = o[1] + cfg.unsplit(sr % cfg.hh, BH)
        rok = (c0 + c < c_n) & (0 <= d < d_n) & (0 <= h < h_n)
        for i in range(cfg.wsteps):
            sw = 4 * i + pl
            w = o[2] + np.array([cfg.unsplit(v, BW) for v in sw])
            ok = rok & (w >= 0) & (w < w_n)
            word = (sr * cfg.hw + sw) * cfg.rs + c
            live = sw < cfg.hw
            val = np.zeros(32)
            if (ok & live).any():
                val[ok & live] = x[(c0 + c)[ok & live], d, h, w[ok & live]]
            sx[word[live]] = val[live]
            np.add.at(count, word[live], 1)
            steps.append(word[live])
    return sx, count, steps


def _stage_g(cfg, g, a0, org, vec):
    """The kernel's stage() of G's tile [gc * gs] for one sample g [A, PD,
    PH, PW] (16-byte pieces of 4 positions with `vec`, each copied whole or
    zero-filled whole by its first position; else 4-byte copies) and the
    write count."""
    a_n, pd, ph, pw = g.shape
    piece = 4 if vec else 1
    e = np.arange(cfg.gc * cfg.p // piece)
    a, pp = e // (cfg.p // piece), e % (cfg.p // piece) * piece
    d = org[0] + pp // (BH * BW)
    h, w = org[1] + pp // BW % BH, org[2] + pp % BW
    ok = (a0 + a < a_n) & (d < pd) & (h < ph) & (w < pw)
    sg = np.full(cfg.gc * cfg.gs, np.nan)
    count = np.zeros(sg.size, np.int64)
    for i in range(piece):
        val = np.zeros(len(e))
        val[ok] = g[(a0 + a)[ok], d[ok], h[ok], (w + i)[ok]]
        sg[a * cfg.gs + pp + i] = val
        np.add.at(count, a * cfg.gs + pp + i, 1)
    return sg, count


def _box_ref(cfg, x, c0, org):
    """X's box as the taps need it, from first principles: stored position
    (cfg.stored of each box coordinate) x channel, zero outside the volume
    and past C."""
    c_n, d_n, h_n, w_n = x.shape
    ref = np.zeros((cfg.npos, cfg.xc))
    for jd, jh, jw in itertools.product(*(range(n) for n in cfg.box)):
        if cfg.mode == 1:
            d, h, w = (2 * o - 1 + j for o, j in zip(org, (jd, jh, jw)))
        else:
            d, h, w = (o - cfg.r + j for o, j in zip(org, (jd, jh, jw)))
        if 0 <= d < d_n and 0 <= h < h_n and 0 <= w < w_n:
            n = min(cfg.xc, c_n - c0)
            ref[cfg.stored((jd, jh, jw)), :max(n, 0)] = x[c0:c0 + n, d, h, w]
    return ref


STAGE_CFGS = [(0, 3, False, 1, 4), (0, 3, True, 2, 1), (0, 1, False, 1, 4), (1, 3, False, 1, 4)]


@pytest.mark.parametrize("tile", STAGE_CFGS, ids=lambda t: "-".join(map(str, t)))
@pytest.mark.parametrize("where", ["corner", "inside", "ragged edge"])
def test_box_staging_fills_x_box_and_g_tile_once(tile, where):
    cfg = Cfg(*tile)
    rng = np.random.default_rng(7)
    # C = 11, A = 37: the second channel tiles are ragged
    x = rng.standard_normal((11, 13, 18, 37))
    size = (_half(13), _half(18), _half(37)) if cfg.mode == 1 else (13, 18, 37)
    g = rng.standard_normal((37,) + size)
    if where == "corner":
        c0, a0, org = 0, 0, (0, 0, 0)
    elif where == "inside":
        c0, a0, org = 0, 0, (cfg.bd, BH, BW)
    else:
        c0, a0 = cfg.xc * ((11 - 1) // cfg.xc), cfg.gc * ((37 - 1) // cfg.gc)
        org = tuple((n - 1) // e * e for n, e in zip(size, (cfg.bd, BH, BW)))
    sx, count, steps = _stage_x(cfg, x, c0, org)
    box = sx.reshape(cfg.npos, cfg.rs)
    cnt = count.reshape(cfg.npos, cfg.rs)
    assert (cnt[:, :cfg.xc] == 1).all() and (cnt[:, cfg.xc:] == 0).all()
    assert np.array_equal(box[:, :cfg.xc], _box_ref(cfg, x, c0, org))
    # a warp step's copies write distinct banks
    for word in steps:
        assert len(set(word % 32)) == len(word)
    for vec in (True, False) if size[2] % 4 == 0 else (False,):
        sg, gcount = _stage_g(cfg, g, a0, org, vec)
        tile_ = sg.reshape(cfg.gc, cfg.gs)
        assert (gcount.reshape(cfg.gc, cfg.gs)[:, :cfg.p] == 1).all()
        assert np.isnan(tile_[:, cfg.p:]).all()
        ref = np.zeros((cfg.gc, cfg.bd, BH, BW))
        gp = np.zeros((max(37, a0 + cfg.gc),) + tuple(n + e for n, e in
                                                     zip(size, (cfg.bd, BH, BW))))
        gp[:37, :size[0], :size[1], :size[2]] = g
        ref[:] = gp[a0:a0 + cfg.gc, org[0]:org[0] + cfg.bd, org[1]:org[1] + BH,
                    org[2]:org[2] + BW]
        assert np.array_equal(tile_[:, :cfg.p], ref.reshape(cfg.gc, -1))


def _ldsm_words(lane_word, nmat):
    """ldmatrix of nmat 8 x 4 f32 matrices: lane l addresses row l % 8 of
    matrix l / 8 (lane_word: each lane's word address); register i of lane l
    receives word l % 4 of row l / 4 of matrix i."""
    lanes = np.arange(32)
    return np.stack([lane_word[i * 8 + lanes // 4] + lanes % 4 for i in range(nmat)], 1)


@pytest.mark.parametrize("tile", _dispatched(), ids=lambda t: "-".join(map(str, t)))
def test_fragments_read_their_taps_and_store_every_output_once(tile):
    cfg = Cfg(*tile)
    k, mt, nt = cfg.k, cfg.mt, cfg.nt
    lanes = np.arange(32)
    gid, tig = lanes >> 2, lanes & 3
    stores = np.zeros((cfg.gc, cfg.xc, cfg.t), np.int32)
    steps = np.zeros((cfg.t, cfg.ksteps), np.int32)  # (tap, step) products taken
    loads = [0, 0, 0, 0]                              # taps each sub-partition computes
    for warp in range(cfg.warps):
        jw = warp % cfg.j
        # the warp's taps: w + 8 i < k^3 (k = 3), or tap 0 (k = 1)
        taps = [warp + 8 * i for i in range(cfg.tw) if warp + 8 * i < cfg.t] if k == 3 else [0]
        assert len(taps) == (cfg.tw if k == 1 or warp + 8 * (cfg.tw - 1) < cfg.t
                             else cfg.tw - 1)
        loads[warp % 4] += len(taps) * cfg.nq
        x_lane = tig * cfg.rs + gid
        if cfg.sw:
            g_lane = (((lanes >> 3) & 1) * 8 + (lanes & 7)) * cfg.gs + (lanes >> 4) * 4
        else:
            g_lane = ((lanes >> 4) * 8 + (lanes & 7)) * cfg.gs + ((lanes >> 3) & 1) * 4
        for qi in range(cfg.nq):
            q = jw + cfg.j * qi
            r = q >> 1
            xq = x_lane + ((r // BH * cfg.hh + r % BH) * cfg.hw + (q & 1) * 8) * cfg.rs
            gq = g_lane + q * 8

            # from first principles: the word of G channel a at mma k index
            # kk of this step (brick position q 8 + kk), and of X channel c
            # at that position shifted by tap t = (kd, kh, kw)
            def g_word(a, kk):
                return a * cfg.gs + q * 8 + kk

            def x_word(c, kk, t):
                kd, kh, kw = t // (k * k), t // k % k, t % k
                p = q * 8 + kk
                p = (p // (BH * BW), p // BW % BH, p % BW)
                if cfg.mode == 1:
                    coord = (2 * p[0] + kd, 2 * p[1] + kh, 2 * p[2] + kw)
                else:
                    coord = (p[0] + kd, p[1] + kh, p[2] + kw)
                return cfg.stored(coord) * cfg.rs + c

            # G's fragments by ldmatrix
            if cfg.sw:  # A: rows m 16 + gid (+ 8), k tig (+ 4)
                for m in range(mt):
                    got = _ldsm_words(gq + m * 16 * cfg.gs, 4)
                    for reg, (dr, dk) in enumerate(((0, 0), (8, 0), (0, 4), (8, 4))):
                        assert np.array_equal(got[:, reg], g_word(m * 16 + gid + dr, tig + dk))
            else:       # B: n-tile rows n 8 + gid, k tig (+ 4)
                for n in range(0, nt, 2):
                    nmat = 4 if n + 1 < nt else 2
                    got = _ldsm_words(gq + n * 8 * cfg.gs, nmat)
                    for reg in range(nmat):
                        nn, dk = n + reg // 2, 4 * (reg % 2)
                        assert np.array_equal(got[:, reg], g_word(nn * 8 + gid, tig + dk))
            # each ldmatrix phase: 8 rows of 16 bytes in distinct bank groups
            assert len(set((g_lane[:8] // 4) % 8)) == 8
            # X's fragments by 32-bit loads, at the box offset of each tap
            for t in taps:
                steps[t, q] += 1
                xa = xq + cfg.toff(t) * cfg.rs
                if cfg.sw:  # B: k tig (+ 4), column n 8 + gid
                    for n in range(nt):
                        for reg, off in enumerate((0, 4 * cfg.rs)):
                            word = xa + n * 8 + off
                            assert np.array_equal(word, x_word(n * 8 + gid, tig + 4 * reg, t))
                            assert len(set(word % 32)) == 32
                else:       # A: rows m 16 + gid (+ 8), k tig (+ 4)
                    for m in range(mt):
                        for reg, (dr, dk) in enumerate(((0, 0), (8, 0), (0, 4), (8, 4))):
                            word = xa + m * 16 + dr + dk * cfg.rs
                            assert np.array_equal(word, x_word(m * 16 + gid + dr, tig + dk, t))
                            assert len(set(word % 32)) == 32
        # the stores: c[e] is row gid + 8 (e / 2), column 2 tig + e % 2; k = 1
        # stores once, from the warps' sums
        if cfg.j == 1 or warp == 0:
            for t, m, n, e in itertools.product(taps, range(mt), range(nt), range(4)):
                row = m * 16 + gid + (e >> 1) * 8
                col = n * 8 + 2 * tig + (e & 1)
                xc, gc = (col, row) if cfg.sw else (row, col)
                np.add.at(stores, (gc, xc, t), 1)
    assert (stores == 1).all()
    # every (tap, k8 step) of a brick is taken once
    assert (steps == 1).all()
    # the sub-partitions (warp % 4) share the products within one tap's steps
    assert max(loads) - min(loads) <= (cfg.nq if k == 3 else 0)


# ------------------------------------------------------------ (c) arithmetic
def tf32(t):
    """f32 -> TF32, to nearest, ties away from zero, by int32 bit
    operations (the kernel's round_tf32)."""
    return ((t.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def split_hl(t):
    hi = tf32(t)
    return hi, tf32(t - hi)


def _taps(xf, plan, grid):
    """X at each tap over the positions of G's padded grid: [T, B, C, *grid],
    zero outside the volume."""
    k = plan.k
    r = k // 2
    out = []
    if plan.mode == 1:
        pad = [(1, 2 * g + 2 - n - 1) for g, n in zip(grid, xf.shape[2:])]
    else:
        pad = [(r, g + r - n) for g, n in zip(grid, xf.shape[2:])]
    xp = torch.nn.functional.pad(xf, tuple(v for pr in reversed(pad) for v in pr))
    for kd, kh, kw in itertools.product(range(k), repeat=3):
        if plan.mode == 1:
            out.append(xp[:, :, kd:kd + 2 * grid[0]:2, kh:kh + 2 * grid[1]:2,
                          kw:kw + 2 * grid[2]:2])
        else:
            out.append(xp[:, :, kd:kd + grid[0], kh:kh + grid[1], kw:kw + grid[2]])
    return torch.stack(out)


def _bricks(t, nb, brick):
    """[..., D, H, W] on the padded grid -> [..., bricks (w fastest),
    positions of a brick (d, h, w order)]."""
    lead = t.shape[:-3]
    t = t.reshape(lead + (nb[0], brick[0], nb[1], brick[1], nb[2], brick[2]))
    n = len(lead)
    t = t.permute(tuple(range(n)) + (n, n + 2, n + 4, n + 1, n + 3, n + 5))
    return t.reshape(lead + (nb[0] * nb[1] * nb[2], brick[0] * brick[1] * brick[2]))


def emulate(x, g, plan, per_sample, hi_only=False):
    """FB1's arithmetic in torch, f32, for X = x [b, C, D, H, W] and G = g
    on G's grid, cut as `plan` says."""
    cfg = _cfg(plan)
    b, c_n = x.shape[:2]
    a_n = g.shape[1]
    grid_real = g.shape[2:]
    nb = [_cdiv(n, e) for n, e in zip(grid_real, plan.brick)]
    grid = tuple(n * e for n, e in zip(nb, plan.brick))
    gp = torch.zeros((b, a_n) + grid)
    gp[:, :, :grid_real[0], :grid_real[1], :grid_real[2]] = g.float()
    xt = _bricks(_taps(x.float(), plan, grid), nb, plan.brick)  # [T, b, C, NB, P]
    gb = _bricks(gp, nb, plan.brick)                             # [b, A, NB, P]
    xh, xl = split_hl(xt)
    gh, gl = split_hl(gb)
    # A = X and B = G (X's channels on M), or A = G and B = X
    ah, al, bh_, bl_ = (gh, gl, xh, xl) if plan.swap else (xh, xl, gh, gl)
    # a warp's runs: [.., NB, runs, steps of a run, 8] by the warp
    if cfg.j == 1:
        shape = (cfg.nq // cfg.runq, cfg.runq * 8)
    else:  # k = 1: step q to warp q % 8; a warp's steps make one run
        shape = (cfg.nq, cfg.j, 8)

    def runs(t):
        t = t.reshape(t.shape[:-1] + shape)
        if cfg.j > 1:  # [.., NB, qi, warp, 8] -> [.., NB, warp, qi * 8]
            t = t.transpose(-3, -2).reshape(t.shape[:-3] + (cfg.j, cfg.nq * 8))
        return t

    ah, al, bh_, bl_ = map(runs, (ah, al, bh_, bl_))
    if plan.swap:
        eq = "bajrp,tbcjrp->tbjrac"
        prods = ([] if hi_only else [(al, bh_), (ah, bl_)]) + [(ah, bh_)]
    else:
        eq = "tbcjrp,bajrp->tbjrac"
        prods = ([] if hi_only else [(al, bh_), (ah, bl_)]) + [(ah, bh_)]
    part = None
    for a_, b_ in prods:  # lo_A hi_B, hi_A lo_B, hi_A hi_B
        term = torch.einsum(eq, a_, b_)
        part = term if part is None else part + term
    # part: [T, b, NB, R, A, C] (R: runs of a brick, or k = 1's warps)
    sps, bps = plan.splits_per_sample, plan.bps
    pad = sps * bps - part.shape[2]
    part = torch.nn.functional.pad(part, (0, 0, 0, 0, 0, 0, 0, pad))
    part = part.reshape(part.shape[:2] + (sps, bps) + part.shape[3:])
    if cfg.j == 1:  # running sums over a split's bricks and runs, in order
        seq = part.reshape(part.shape[:3] + (bps * part.shape[4],) + part.shape[5:])
        run = torch.zeros(seq[:, :, :, 0].shape)
        for i in range(seq.shape[3]):
            run = run + seq[:, :, :, i]
    else:           # per warp over the bricks, then the warps in order
        wr = torch.zeros(part[:, :, :, 0].shape)
        for i in range(bps):
            wr = wr + part[:, :, :, i]
        run = torch.zeros(wr[:, :, :, 0].shape)
        for w in range(cfg.j):
            run = run + wr[:, :, :, w]
    # run: [T, b, sps, A, C]; the splits in split order
    run = run.permute(1, 2, 3, 4, 0)
    if per_sample:
        out = torch.zeros(run[:, 0].shape)
        for s in range(sps):
            out = out + run[:, s]
    else:
        out = torch.zeros(run[0, 0].shape)
        for s in range(b * sps):
            out = out + run[s // sps, s % sps]
    k = plan.k
    return out.reshape(out.shape[:-1] + (k, k, k))


def _operands(mode, b, cin, cout, spatial, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((b, cin) + spatial).astype(np.float32))
    gsize = tuple(_half(n) for n in spatial) if mode == "s2" else spatial
    g = torch.from_numpy(rng.standard_normal((b, cout) + gsize).astype(np.float32))
    return x, g


EMU_CASES = [  # (mode, b, cin, cout, spatial, k)
    ("s1", 2, 12, 6, (5, 9, 37), 3),     # X on M, 1 n-tile; ragged bricks
    ("s1", 2, 9, 20, (4, 6, 20), 3),     # 4 n-tiles, a ragged second X tile
    ("s1", 2, 1, 18, (4, 5, 18), 3),     # Cin = 1: G on M, 2 m-tiles
    ("s1", 2, 16, 1, (5, 4, 33), 3),     # Cout = 1
    ("s1", 2, 12, 10, (3, 5, 37), 1),    # k = 1, 2 n-tiles
    ("s1", 2, 2, 1, (3, 4, 24), 1),      # k = 1, Cin = 2 and Cout = 1: G on M
    ("s2", 2, 10, 12, (7, 9, 35), 3),    # the strided map, 4 n-tiles, odd sizes
    ("s2", 2, 3, 1, (6, 8, 34), 3),      # the strided map, Cin = 3, Cout = 1
]


@pytest.mark.parametrize("case", EMU_CASES, ids=lambda c: f"{c[0]}-{c[2]}-{c[3]}-k{c[5]}")
@pytest.mark.parametrize("per_sample", [False, True])
def test_fb1_emulation_matches_plain(case, per_sample, monkeypatch):
    import coma_unet_tpu_torch.ops.conv3d as conv

    mode, b, cin, cout, spatial, k = case
    monkeypatch.setattr(conv, "FB1_BLOCKS", 2)  # a few splits of a few bricks each
    x, g = _operands(mode, b, cin, cout, spatial, seed=len(spatial) + cin + k)
    plan = fb1_plan(mode, b, cin, cout, *spatial, k)
    want = conv3d_weight_ref(x.double(), g.double(), k, per_sample,
                             stride=2 if mode == "s2" else 1)
    got = emulate(x, g, plan, per_sample)
    assert got.shape == want.shape
    scale = float(want.abs().max())
    err = float((got.double() - want).abs().max())
    assert err <= TOL * scale
    err_hi = float((emulate(x, g, plan, per_sample, hi_only=True).double() - want).abs().max())
    assert err_hi >= HI_RATIO * err


def test_emulation_sums_runs_and_splits_of_a_wide_site(monkeypatch):
    """A wide k = 3 tile with several runs a brick and several splits a
    sample, per sample: the cut the emulation follows is the wide sites'."""
    import coma_unet_tpu_torch.ops.conv3d as conv

    monkeypatch.setattr(conv, "FB1_BLOCKS", 8)
    x, g = _operands("s1", 2, 16, 32, (8, 8, 32), seed=3)
    plan = fb1_plan("s1", 2, 16, 32, 8, 8, 32, 3)
    assert (plan.swap, plan.mt, plan.nt, plan.bps, plan.splits_per_sample) == (False, 1, 4, 2, 4)
    assert _cfg(plan).nq // _cfg(plan).runq == 4
    want = conv3d_weight_ref(x.double(), g.double(), 3, True)
    err = float((emulate(x, g, plan, True).double() - want).abs().max())
    assert err <= TOL * float(want.abs().max())


# ------------------------------------------------------------------ (d) JAX
@pytest.mark.parametrize("per_sample", [False, True])
def test_fb1_emulation_matches_jax_s1(per_sample):
    rng = np.random.default_rng(31)
    b, cin, cout = 2, 12, 6
    x = rng.standard_normal((b, cin, 4, 8, 128)).astype(np.float32)
    g = rng.standard_normal((b, cout, 4, 8, 128)).astype(np.float32)
    plan = fb1_plan("s1", b, cin, cout, 4, 8, 128, 3)
    got = emulate(torch.from_numpy(x), torch.from_numpy(g), plan, per_sample).numpy()
    want = np.asarray(c3._pallas_conv3d_dw(jnp.asarray(x), jnp.asarray(g), 3,
                                           batched=per_sample, interpret=True))
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= TOL * float(np.abs(want).max())


@pytest.mark.parametrize("role", ["s2", "t2"])
def test_fb1_emulation_matches_jax_strided(role):
    """Both roles of `_dw_dil`: the stride-2 conv's dW (full = x, half = g)
    and the transposed conv's (full = g, half = x), per sample."""
    rng = np.random.default_rng(37)
    b, cin, cout, d = 2, 6, 10, 8
    c_full, c_half = (cin, cout) if role == "s2" else (cout, cin)
    full = rng.standard_normal((b, c_full, d, d, d)).astype(np.float32)
    half = rng.standard_normal((b, c_half) + (d // 2,) * 3).astype(np.float32)
    plan = fb1_plan("s2", b, c_full, c_half, d, d, d)
    got = emulate(torch.from_numpy(full), torch.from_numpy(half), plan, True).numpy()
    want = np.asarray(strided._dw_dil(jnp.asarray(full), strided.pack_w(jnp.asarray(half)),
                                      batched=True, interpret=True))
    # [B, 27, Cp, Cf] -> [B, Cp, Cf, 3, 3, 3]
    want = np.moveaxis(want, -3, -1).reshape(want.shape[:1] + want.shape[2:] + (3, 3, 3))
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= TOL * float(np.abs(want).max())
