"""K4's slab halves (`coma_unet_tpu_torch/csrc/norm_act.cu`: `coma_norm_stats`,
`coma_norm_apply`) and their cut (`ops/norm_act.py:slab_plan`), checked on the
CPU, where no kernel runs.

(a) `slab_plan` covers every voxel of every row once, with segments of a
    multiple of 8 voxels (16-byte groups of the row) of at least
    SLAB_MIN_BYTES unless the row is shorter; each segment's aligned
    decomposition (16-byte groups inside it, at most EPG - 1 elements at
    each ragged end) covers it once for every row offset and both element
    sizes; and at 132 SMs the statistics' plan fills one wave for every
    slab shape of phase 3 and phase 14 as closely as its rows allow (a
    whole wave where they divide it), or takes every segment SLAB_MIN_BYTES
    allows, while the apply's takes pieces of SLAB_MIN_BYTES.
(b) A numpy emulation of the one-launch statistics -- each 16-byte group's
    shifted sums in f32 added to its thread's f64 sums in the kernel's
    order, the CTA's fixed reduction in f64, the f32 partial, the tickets
    and the last CTA's f64 merge in segment order -- matches `row_partials`
    (f64) within STATS_TOL of max|plain| a column, also where rows start off
    16 bytes, and within LONG_TOL over a segment longer than any of the
    path's, and gives the same bits for every arrival order of the
    segments, leaving every counter zero.
(c) The emulation of both halves over 2 and 4 depth slabs, merged by
    `merge_partials`, matches the Pallas `_norm_act_fwd_impl` on the whole
    rows in interpret mode within PALLAS_TOL of max|plain|, for every
    activation, with and without FiLM.
(d) The 2-D apply emulation (rows folded past the grid's y) writes every
    voxel once and matches `norm_apply_plain` in f32 within APPLY_TOL of
    max|plain|, with y's rows at several offsets past 16 bytes (the kernel
    cuts in y's aligned coordinates and loads x's groups whole where x
    shares the offset, element by element where not: the same values).
"""

import itertools

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from coma_unet_tpu.ops.pallas.norm_act import _norm_act_fwd_impl  # noqa: E402
from coma_unet_tpu_torch import ops  # noqa: E402
from coma_unet_tpu_torch.ops.norm_act import (  # noqa: E402
    SLAB_MIN_BYTES,
    apply_act,
    mean_rstd,
    merge_partials,
    row_partials,
    slab_plan,
)

THREADS, UNROLL = 256, 4   # csrc/norm_act.cu: SLAB_THREADS, SLAB_UNROLL
EPS = 1e-5
STATS_TOL = 1e-5     # f32 partials of bf16 values against two-pass f64
LONG_TOL = 1e-6      # the same over a segment of 2,560 values a thread
PALLAS_TOL = 1e-5    # the Pallas kernel's E[x^2] - mean^2 in f32 at a mean of 0.5
APPLY_TOL = 1e-6     # the same f32 operations; the card may fuse a multiply-add


def _cdiv(a, b):
    return -(-a // b)


# ------------------------------------------------------------- (a) the cut
def _slab_shapes():
    """(rows, N) of every slab case of phase 3 and every slab shape of
    phase 14."""
    shapes = {(x[0] * x[1], int(np.prod(x[2:])))
              for family, _, x, _, _, _ in chip_smoke._kernel_cases()
              if family == "norm_stats"}
    shapes |= {(x[0] * x[1], int(np.prod(x[2:]))) for x, _ in chip_smoke.SP_SLAB_SHAPES}
    return sorted(shapes)


PLAN_CASES = sorted(set(_slab_shapes()) | {
    (1, 7), (1, 4095), (3, 20_003), (32, 2 * 64 ** 3 + 6), (64, 64 ** 3),
    (512, 512), (512, 27 * 18 * 45), (70_000, 24)})


def piece(o, e0, e1, epg):
    """The kernel's `piece`: segment [e0, e1) of a row whose element 0 lies
    o elements past a 16-byte boundary, in the aligned coordinates: (lo, hi,
    g0, g1, a, b) with groups [g0, g1) wholly inside and the ragged ends
    [lo, a) and [b, hi)."""
    lo, hi = o + e0, o + e1
    g0, g1 = _cdiv(lo, epg), hi // epg
    if g0 < g1:
        return lo, hi, g0, g1, epg * g0, epg * g1
    return lo, hi, g0, g0, hi, hi


@pytest.mark.parametrize("per_sm", [2, 4, 8])
@pytest.mark.parametrize("case", PLAN_CASES, ids=lambda c: "x".join(map(str, c)))
def test_slab_plan_covers_every_voxel_once(case, per_sm):
    rows, n = case
    for sms, elem, one_wave in itertools.product((132, 66), (2, 4), (True, False)):
        plan = slab_plan(rows, n, sms, per_sm, elem, one_wave=one_wave)
        assert plan.seg % 8 == 0 and (plan.segs - 1) * plan.seg < n <= plan.segs * plan.seg
        assert plan.segs == 1 or elem * plan.seg >= SLAB_MIN_BYTES
        assert plan.ctas == rows * plan.segs
        assert plan.waves == pytest.approx(plan.ctas / (sms * per_sm))
        if one_wave:
            assert plan.ctas <= max(rows, sms * per_sm)
        else:  # the apply: pieces of SLAB_MIN_BYTES, rounded up to 8 voxels
            assert plan.segs <= max(1, n * elem // SLAB_MIN_BYTES)
            assert elem * plan.seg < 2 * SLAB_MIN_BYTES or plan.segs == 1
    spans = [(s * plan.seg, min(n, (s + 1) * plan.seg)) for s in range(plan.segs)]
    assert spans[0][0] == 0 and spans[-1][1] == n
    assert all(a[1] == b[0] < b[1] for a, b in zip(spans, spans[1:]))
    for epg in (8, 4):        # bf16, f32
        for o in range(epg):  # the row's offset past 16 bytes
            for e0, e1 in spans:
                assert e0 % 8 == 0  # a 16-byte group of the row
                lo, hi, g0, g1, a, b = piece(o, e0, e1, epg)
                assert lo <= a <= b <= hi and a - lo < epg and hi - b < epg
                if g0 < g1:  # the groups fill [a, b) and are whole vectors
                    assert (a, b) == (epg * g0, epg * g1)
                else:
                    assert a == b == hi and hi - lo < 2 * epg


@pytest.mark.parametrize("elem", [2, 4])
@pytest.mark.parametrize("per_sm", [4, 5, 8])
def test_slab_plan_fills_one_wave_on_the_path(per_sm, elem):
    sms, wave = 132, 132 * per_sm
    shapes = _slab_shapes()
    assert (64, 32 * 64 * 64) in shapes and (1, 64 * 128 * 128) in shapes
    for rows, n in shapes:
        plan = slab_plan(rows, n, sms, per_sm, elem)
        most = n * elem // SLAB_MIN_BYTES  # segments of at least SLAB_MIN_BYTES
        assert plan.ctas <= wave, (rows, n, plan)
        if plan.segs < most:  # a finer cut would overflow the wave
            # segments are whole multiples of 8 values: the next finer cut,
            # 8 values shorter, may add more than one segment a row (at
            # [1, 1, 104, 216, 216] 1,055 segments of 4,600 leave one CTA of
            # 1,056 idle; 4,592 would make 1,057)
            finer = -(-n // (plan.seg - 8))
            assert rows * finer > wave, (rows, n, plan)
            if (rows, n) == (1, 104 * 216 * 216) and (per_sm, elem) == (8, 4):
                assert (plan.segs, plan.seg) == (1_055, 4_600)  # one CTA idle
            elif wave % rows == 0:  # no other path shape leaves one idle
                assert plan.ctas == wave, (rows, n, plan)
        else:
            assert plan.segs == max(1, most) or plan.seg * plan.segs - n < 8 * plan.segs
    # the wide half slab: 16 segments a row, 512 of the wave's 528 CTAs
    assert slab_plan(32, 64 * 128 * 128, sms, 4)[:3] == (16, 65536, 512)
    # 16 rows of the modulator fill the wave
    assert slab_plan(16, 64 * 128 * 128, sms, 4)[:3] == (33, 31776, 528)
    # one channel: 128 segments of one trip a CTA (16 KB)
    assert slab_plan(1, 64 * 128 * 128, sms, 4)[:3] == (128, 8192, 128)
    assert slab_plan(1, 64 * 128 * 128, sms, 4, 4)[:3] == (256, 4096, 256)
    # the apply's cut: 16 KB pieces, as many waves as they make
    assert slab_plan(32, 64 * 128 * 128, sms, 4, one_wave=False)[:3] == (128, 8192, 4096)
    assert slab_plan(32, 64 * 128 * 128, sms, 4, 4, one_wave=False)[:3] == (256, 4096, 8192)


# ---------------------------------------------- (b) the statistics' arithmetic
def _fma32(a, b, c):
    """fmaf in f32: the f64 product of two f32 values is exact."""
    a, b, c = (np.asarray(v, np.float64) for v in (a, b, c))
    return (a * b + c).astype(np.float32)


def _block_total(v):
    """`block_total` over SLAB_THREADS / 32 warps: a butterfly in each warp,
    then warp 0..7 in order, in f64."""
    w = np.asarray(v, np.float64).reshape(THREADS // 32, 32)
    lanes = np.arange(32)
    for o in (16, 8, 4, 2, 1):
        w = w + w[:, lanes ^ o]
    t = 0.0
    for x in w[:, 0]:
        t = t + x
    return t


def _warp_total(v):
    """`warp_total`: lane 0 of a shfl_down tree over 32 lanes, in f64."""
    v = np.asarray(v, np.float64).copy()
    lanes = np.arange(32)
    for o in (16, 8, 4, 2, 1):
        v = v + np.where(lanes + o < 32, v[(lanes + o) % 32], v)
    return v[0]


def _merge(parts, n, s0):
    """The last CTA's merge of a row's partials [segs, 3] (f32), in segment
    order, one warp, in f64: (count, mean, M2)."""
    sn, m2 = np.zeros(32), np.zeros(32)
    for i, (c, m, _) in enumerate(parts):
        sn[i % 32] += np.float64(c) * np.float64(m)
    mt = _warp_total(sn) / n
    for i, (c, m, q) in enumerate(parts):
        d = np.float64(m) - mt
        m2[i % 32] += np.float64(q) + np.float64(c) * d * d
    return np.array([float(n), np.float64(s0) + mt, _warp_total(m2)])


def _cta_partial(xr, o, e0, e1, epg):
    """One CTA's partial of row values xr (f32) for segment [e0, e1), as the
    kernel forms it: thread t takes the groups g0 + t, g0 + t + THREADS,
    ..., each group's shifted values summed in f32 and the group's sums
    added to the thread's f64 sums; then the ragged-end elements i = t, t +
    THREADS, ... one by one in f64; the CTA's fixed reduction in f64; the
    (count, mean, M2) stored as f32."""
    lo, hi, g0, g1, a, b = piece(o, e0, e1, epg)
    s0 = xr[0]
    s = np.zeros(THREADS)
    q = np.zeros(THREADS)
    for k0 in range(g0, g1, THREADS):
        ks = np.arange(k0, min(k0 + THREADS, g1))
        gs = np.zeros(len(ks), np.float32)
        gq = np.zeros(len(ks), np.float32)
        for j in range(epg):
            t = (xr[epg * ks + j - o] - s0).astype(np.float32)
            gs = (gs + t).astype(np.float32)
            gq = _fma32(t, t, gq)
        s[:len(ks)] += gs
        q[:len(ks)] += gq
    head = a - lo
    for i in range(head + (hi - b)):
        t = np.float64(np.float32(xr[(lo + i if i < head else b + i - head) - o] - s0))
        s[i % THREADS] += t
        q[i % THREADS] += t * t  # exact product of an f32 value: the kernel's fma
    s, q = _block_total(s), _block_total(q)
    cnt = float(e1 - e0)
    m = s / cnt
    return np.array([cnt, m, max(q - s * m, 0.0)], np.float32)


def emulate_stats(x, plan, epg, off=0, order=None, count=None):
    """`coma_norm_stats` on x [rows, n] (f32 values) cut by `plan`, x's first
    element `off` elements past 16 bytes: the CTAs arrive in `order` (a
    permutation of the (row, segment) CTAs), each stores its partial and
    takes a ticket; the last of a row merges. Returns ([rows, 3] f64, the
    counters after the call)."""
    rows, n = x.shape
    part = np.zeros((rows, plan.segs, 3), np.float32)
    count = np.zeros(rows, np.int64) if count is None else count
    out = np.full((rows, 3), np.nan)
    ctas = [(r, s) for r in range(rows) for s in range(plan.segs)]
    for i in (order if order is not None else range(len(ctas))):
        row, sidx = ctas[i]
        e0 = sidx * plan.seg
        part[row, sidx] = _cta_partial(x[row], (off + row * n) % epg, e0,
                                       min(n, e0 + plan.seg), epg)
        count[row] += 1
        if count[row] == plan.segs:
            out[row] = _merge(part[row], n, x[row, 0])
            count[row] = 0
    return out, count


def _bf16_rows(rows, n, seed, mean=3.0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy((mean + rng.normal(size=(rows, n))).astype(np.float32))
    return x.bfloat16().float().numpy()


def _rel_cols(got, want):
    return [float(np.abs(got[:, j] - want[:, j]).max() / np.abs(want[:, j]).max())
            for j in range(got.shape[1])]


# (rows, N, sms, per_sm, min_bytes): several segments a row, N % 8 != 0
EMU_CASES = [(3, 2005, 4, 2, 512), (2, 4096, 3, 2, 1024), (5, 777, 16, 1, 192)]


@pytest.mark.parametrize("off", [0, 1, 3])
@pytest.mark.parametrize("epg", [8, 4], ids=["bf16", "f32"])
@pytest.mark.parametrize("case", EMU_CASES, ids=lambda c: "x".join(map(str, c[:2])))
def test_stats_emulation_matches_f64_in_any_arrival_order(case, epg, off):
    rows, n, sms, per_sm, min_bytes = case
    plan = slab_plan(rows, n, sms, per_sm, 16 // epg, min_bytes)
    assert plan.segs > 1
    x = _bf16_rows(rows, n, seed=rows + n)
    want = row_partials(torch.from_numpy(x).reshape(rows, 1, n)).numpy()
    got, count = emulate_stats(x, plan, epg, off)
    assert not count.any()
    assert np.array_equal(got[:, 0], want[:, 0])
    assert max(_rel_cols(got, want)) < STATS_TOL
    rng = np.random.default_rng(off + epg)
    for _ in range(3):  # any arrival order: the same bits
        again, count = emulate_stats(x, plan, epg, off, rng.permutation(plan.ctas))
        assert np.array_equal(again, got) and not count.any()


@pytest.mark.parametrize("epg", [8, 4], ids=["bf16", "f32"])
def test_stats_emulation_holds_a_long_segment(epg):
    # one CTA a row, 2,560 values a thread: longer than any segment of
    # phase 3 or phase 14 (about 2,460 at the one-rank 216^3 slab
    # [1, 32, 216, 216, 216]); f32 sums over a thread's whole run read 2e-5
    rows, n = 2, 2 * 327_680 + 6
    plan = slab_plan(rows, n, 1, 2, 16 // epg)
    assert plan.segs == 1 and n // THREADS > 2_500
    x = _bf16_rows(rows, n, seed=5)
    want = row_partials(torch.from_numpy(x).reshape(rows, 1, n)).numpy()
    got, count = emulate_stats(x, plan, epg, 3)
    assert not count.any()
    assert max(_rel_cols(got, want)) < LONG_TOL


# ------------------------------------------------- (d) the apply's arithmetic
def emulate_apply(x, stats, sc, sh, alpha, act, plan, epg, off=0, rows_y=65535):
    """`coma_norm_apply` on x [rows, n] (f32 values) cut by `plan`, y's first
    element `off` elements past 16 bytes: a (segment, row) grid whose rows
    fold past `rows_y`; each CTA reads its row's parameters once and writes
    its segment's groups, in y's aligned coordinates, and its ragged ends.
    Returns (y f32, times each voxel was written)."""
    rows, n = x.shape
    y = np.full_like(x, np.nan)
    written = np.zeros(x.shape, np.int64)
    for by in range(min(rows, rows_y)):
        for bx in range(plan.segs):
            e0 = bx * plan.seg
            e1 = min(n, e0 + plan.seg)
            for row in range(by, rows, rows_y):
                o = (off + row * n) % epg
                lo, hi, g0, g1, a, b = piece(o, e0, e1, epg)
                el = np.concatenate([np.arange(epg * g0, epg * g1), np.arange(lo, a),
                                     np.arange(b, hi)]) - o
                v = x[row, el]
                u = np.float32(sc[row]) * ((v - stats[row, 0]) * stats[row, 1]).astype(
                    np.float32) + np.float32(sh[row])
                y[row, el] = apply_act(torch.from_numpy(u.astype(np.float32)), act,
                                       alpha).numpy()
                written[row, el] += 1
    return y, written


@pytest.mark.parametrize("act", ["none", "relu", "leakyrelu", "prelu"])
@pytest.mark.parametrize("off", [0, 2, 5])
def test_apply_emulation_matches_plain(act, off):
    b, c, sp = 3, 3, (5, 7, 9)          # 9 rows of N = 315 (N % 8 = 3)
    rows, n = b * c, int(np.prod(sp))
    x = _bf16_rows(rows, n, seed=7)
    rng = np.random.default_rng(8)
    sc = (1.0 + 0.3 * rng.normal(size=rows)).astype(np.float32)
    sh = (0.3 * rng.normal(size=rows)).astype(np.float32)
    alpha = torch.tensor([0.25])
    xt = torch.from_numpy(x).reshape((b, c) + sp)
    stats = mean_rstd(row_partials(xt))
    plan = slab_plan(rows, n, 16, 2, 2, 128)
    assert plan.segs > 1
    got, written = emulate_apply(x, stats.numpy(), sc, sh, alpha, act, plan, 8, off,
                                 rows_y=4)
    assert (written == 1).all()
    want = ops.norm_apply_plain(xt, stats, alpha, act, torch.from_numpy(sc).view(b, c),
                                torch.from_numpy(sh).view(b, c)).reshape(rows, n).numpy()
    assert np.abs(got - want).max() <= APPLY_TOL * np.abs(want).max()


# ----------------------------------------- (c) both halves over depth slabs
@pytest.mark.parametrize("act", ["none", "relu", "leakyrelu", "prelu"])
@pytest.mark.parametrize("film", [False, True])
def test_slab_halves_over_depth_slabs_match_pallas(act, film):
    shape = (2, 2, 8, 4, 128)
    b, c = shape[:2]
    rows = b * c
    rng = np.random.default_rng(11)
    # the Pallas kernel takes var = E[x^2] - mean^2 in f32: a mean of 0.5
    x = torch.from_numpy((0.5 + rng.normal(size=shape)).astype(np.float32)).bfloat16().float()
    alpha = np.array([0.25], np.float32)
    sc = (1.0 + 0.3 * rng.normal(size=(b, c))).astype(np.float32) if film else np.ones(
        (b, c), np.float32)
    sh = (0.3 * rng.normal(size=(b, c))).astype(np.float32) if film else np.zeros(
        (b, c), np.float32)
    want, _ = _norm_act_fwd_impl(jnp.asarray(x.numpy()), jnp.asarray(alpha), jnp.asarray(sc),
                                 jnp.asarray(sh), act, EPS, True)
    want = np.asarray(want)
    for slabs in (2, 4):
        pieces = x.split(shape[2] // slabs, dim=2)
        parts = []
        for s in pieces:
            xs = s.reshape(rows, -1).numpy()
            plan = slab_plan(rows, xs.shape[1], 4, 2, 2, 512)
            assert plan.segs > 1
            parts.append(torch.from_numpy(emulate_stats(xs, plan, 8)[0]))
        stats = mean_rstd(merge_partials(torch.stack(parts)), EPS)
        out = []
        for s in pieces:
            xs = s.reshape(rows, -1).numpy()
            plan = slab_plan(rows, xs.shape[1], 4, 2, 2, 512)
            y, written = emulate_apply(xs, stats.numpy(), sc.reshape(-1), sh.reshape(-1),
                                       torch.from_numpy(alpha), act, plan, 8)
            assert (written == 1).all()
            out.append(torch.from_numpy(y).reshape(s.shape))
        got = torch.cat(out, dim=2).numpy()
        assert np.abs(got - want).max() <= PALLAS_TOL * np.abs(want).max(), slabs
