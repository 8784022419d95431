"""K4's and KB3's plan (`coma_unet_tpu_torch/ops/norm_act.py:na_plan`) and
the arithmetic of their persistent kernels (`csrc/norm_act.cu`), checked on
the CPU, where no kernel runs.

(a) For every K4 and KB3 shape of `chip_smoke.py` phase 3, ragged odd sizes
    (N % 8 != 0), a row larger than the grid's shared memory and 128 small
    rows, at element size 2 (bf16) and 4 (the float32 forms, whose 16-byte
    groups hold 4 values), the plan covers every voxel of every row exactly
    once; a row's segments all fall in one round, on distinct CTAs; the
    grid is at most the SM count; the kept bytes fit a CTA's shared memory,
    also for rows that start off 16 bytes (the kernel's aligned groups); and
    the segments it marks for the bulk copy start and end on 16 bytes.
(b) A torch emulation of the kernels' arithmetic, cut as the plan says --
    per segment the f32 (count, mean, M2) of x - s (s the row's first
    voxel) or the five f32 backward sums, the f64 merge of a row's
    partials (Chan's formula in closed form; plain sums), dalpha summed
    over the rows in row order in f64 -- equals `norm_act_plain` /
    `norm_act_bwd_plain` on the f32 values within 1e-5 of max|plain|, for
    every activation, FiLM on and off, C = 1, odd N and a mean large against
    the spread; at two small cases it also equals the Pallas
    `_norm_act_fwd_impl` / `_norm_act_bwd_impl` in interpret mode. The cases
    pin a small grid and little shared memory, so rows take several
    segments, rounds and partial keeps.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from coma_unet_tpu.ops.pallas.norm_act import (  # noqa: E402
    _norm_act_bwd_impl,
    _norm_act_fwd_impl,
)
from coma_unet_tpu_torch import ops  # noqa: E402
from coma_unet_tpu_torch.ops.norm_act import (  # noqa: E402
    NA_SMEM,
    NA_SMS,
    act_deriv,
    apply_act,
    na_plan,
)

TOL = 1e-5
EPS = 1e-5


def _cdiv(a, b):
    return -(-a // b)


def _phase3_shapes():
    """(rows, N, kept bytes a voxel) of every K4 and KB3 case of phase 3."""
    shapes = []
    for family, _, xshape, _, _, _ in chip_smoke._kernel_cases():
        if family in ("norm_act", "norm_act_bwd"):
            shapes.append((xshape[0] * xshape[1], int(np.prod(xshape[2:])),
                           2 if family == "norm_act" else 4))
    return shapes


# (rows, N, kept bytes a voxel, sms, smem_per_cta) at element size 2; then
# each at element size 4, (rows, N, 2 x kept bytes, sms, smem_per_cta, 4)
BF16_PLAN_CASES = sorted(set(
    [s + (NA_SMS, NA_SMEM) for s in _phase3_shapes()]
    + [(rows, n, kb, NA_SMS, NA_SMEM) for kb in (2, 4) for rows, n in (
        (48, 27 * 18 * 45),          # [2,24,27,18,45]: N % 8 = 6
        (128, 64 ** 3),              # 128 small rows ([2,64,64^3])
        (3, 20_000_003),             # a row larger than the grid's shared memory
        (1024, 6 ** 3), (5, 11 ** 3), (1, 7))]
    + [(rows, n, kb, sms, smem) for kb in (2, 4) for rows, n, sms, smem in (
        (6, 210, 8, 160), (3, 216, 7, 96), (17, 1001, 16, 512), (2, 4096, 5, 4096))]))
PLAN_CASES = BF16_PLAN_CASES + [(rows, n, 2 * kb, sms, smem, 4)
                                for rows, n, kb, sms, smem in BF16_PLAN_CASES]


def _segments(plan, rows, n):
    """(round, CTA, row, e0, e1) of every segment the kernel runs: CTA i
    takes segment i % segs of row r * rows_per_round + i // segs in round r."""
    out = []
    for r in range(plan.rounds):
        for cta in range(plan.grid):
            row = r * plan.rows_per_round + cta // plan.segs
            if row >= rows:
                continue
            e0 = (cta % plan.segs) * plan.seg
            out.append((r, cta, row, e0, min(n, e0 + plan.seg)))
    return out


def _row_segments(plan, rows, n):
    """Each row's segments (e0, e1) as the plan hands them out, in segment
    order."""
    by_row = {}
    for _, cta, row, e0, e1 in _segments(plan, rows, n):
        by_row.setdefault(row, []).append((cta % plan.segs, e0, e1))
    return {row: [(e0, e1) for _, e0, e1 in sorted(p)] for row, p in by_row.items()}


def _kept_groups(plan, row, n, e0, e1, kept_bytes_per_voxel, elem=2):
    """The kernel's `segment`: the 16-byte groups the segment touches in
    the row's aligned coordinates (pointers 16-byte aligned), and how many
    of them it keeps of each tensor (g first), for `elem`-byte values."""
    vec = 16 // elem
    o = (row * n) % vec
    g0, g1 = (o + e0) // vec, _cdiv(o + e1, vec)
    groups = g1 - g0
    cap = plan.keep // vec
    kept = []
    for _ in range(kept_bytes_per_voxel // elem):
        kept.append(min(groups, cap))
        cap -= kept[-1]
    return groups, kept


def test_phase3_shapes_cover_every_norm_site():
    shapes = _phase3_shapes()
    # K4 at 10 cases, KB3 at 9, K4's instance_norm entry at 3
    assert len(shapes) == 22
    plans = {s: na_plan(*s) for s in shapes}
    # K4 keeps every path row whole on chip
    for (rows, n, kb), plan in plans.items():
        if kb == 2:
            assert plan.keep >= plan.seg
    k4 = plans[(32, 216 ** 3, 2)]
    assert (k4.segs, k4.rows_per_round, k4.rounds, k4.grid, k4.bulk) == (132, 1, 32, 132, True)
    assert plans[(64, 128 ** 3, 2)][:3] == (22, 6, 11)
    assert plans[(128, 64 ** 3, 2)].rounds == 3
    # KB3 at 216^3: 40 MB a row, more than the grid holds: g whole, x in part
    kb3 = plans[(32, 216 ** 3, 4)]
    assert kb3.segs == 132 and kb3.seg < kb3.keep < 2 * kb3.seg
    assert not plans[(48, 27 * 18 * 45, 2)].bulk


@pytest.mark.parametrize("case", PLAN_CASES, ids=lambda c: "x".join(map(str, c)))
def test_na_plan_covers_every_voxel_once(case):
    rows, n, kb, sms, smem, *size = case
    elem = size[0] if size else 2
    vec = 16 // elem
    plan = na_plan(rows, n, kb, sms, smem, elem=elem)
    assert 1 <= plan.grid == plan.rows_per_round * plan.segs <= sms
    assert plan.seg % 8 == 0 and (plan.segs - 1) * plan.seg < n <= plan.segs * plan.seg
    assert plan.rows_per_round * plan.rounds >= rows > plan.rows_per_round * (plan.rounds - 1)
    assert plan.keep % vec == 0 and elem * plan.keep == plan.smem <= smem
    assert plan.bulk == (n % vec == 0)
    segs = _segments(plan, rows, n)
    # each row once, in one round, its segments on distinct CTAs, tiling [0, n)
    by_row = {}
    for r, cta, row, e0, e1 in segs:
        by_row.setdefault(row, []).append((r, cta, e0, e1))
    assert sorted(by_row) == list(range(rows))
    assert len({(r, cta) for r, cta, _, _, _ in segs}) == len(segs)
    for row, pieces in by_row.items():
        assert len({r for r, _, _, _ in pieces}) == 1
        assert len({cta for _, cta, _, _ in pieces}) == len(pieces) == plan.segs
        spans = sorted((e0, e1) for _, _, e0, e1 in pieces)
        assert spans[0][0] == 0 and spans[-1][1] == n
        assert all(a[1] == b[0] and a[0] < a[1] for a, b in zip(spans, spans[1:] + [(n, n + 1)]))
    for _, cta, row, e0, e1 in segs:
        # the kept groups fit the CTA's shared memory, also off 16 bytes
        groups, kept = _kept_groups(plan, row, n, e0, e1, kb, elem)
        assert sum(kept) <= plan.keep // vec and 16 * sum(kept) <= smem
        assert groups <= _cdiv(e1 - e0, vec) + (n % vec != 0)
        if plan.bulk:  # 16-byte aligned start and length
            assert (elem * (row * n + e0)) % 16 == 0 and (elem * (e1 - e0)) % 16 == 0
    # a segment that fits is kept whole, g first
    groups, kept = _kept_groups(plan, 0, n, 0, min(n, plan.seg), kb, elem)
    if kb // elem * groups * 16 <= smem:
        assert kept == [groups] * (kb // elem)
    else:
        assert 16 * sum(kept) > smem - 16 * kb  # the rest is read again


def test_na_plan_keeps_half_as_many_f32_voxels():
    # the float32 forms: 4 values a 16-byte group, so a CTA keeps half as
    # many voxels; [2,32,128^3] then takes more segments a row, and the
    # persistent grid still fits the SMs
    bf16, f32 = na_plan(64, 128 ** 3, 2), na_plan(64, 128 ** 3, 4, elem=4)
    assert f32.smem == 4 * f32.keep <= NA_SMEM and f32.grid <= NA_SMS
    assert f32.keep <= NA_SMEM // 4 < bf16.keep
    assert f32.segs > bf16.segs
    # N % 4 == 0 is aligned for f32 though N % 8 != 0 is not for bf16
    assert na_plan(2, 4 * 1001, 4, elem=4).bulk and not na_plan(2, 4 * 1001, 2).bulk
    for rows, n in ((32, 216 ** 3), (64, 128 ** 3), (2, 128 ** 3), (48, 27 * 18 * 45)):
        for kb in (4, 8):
            plan = na_plan(rows, n, kb, elem=4)
            assert plan.grid <= NA_SMS and plan.smem <= NA_SMEM


def test_na_plan_spreads_and_balances_rows():
    # two rows of 128^3 take the whole grid; 64 take 11 balanced rounds
    assert na_plan(2, 128 ** 3, 2).grid == 132
    p = na_plan(64, 128 ** 3, 2)
    assert (p.rows_per_round, p.rounds) == (6, 11)
    # small rows are not spread below NA_MIN_SEG voxels a segment
    assert na_plan(2, 1000, 2).segs == 1
    # the SM count comes from the caller
    assert na_plan(64, 128 ** 3, 2, sms=66).grid <= 66


# ------------------------------------------------------ the arithmetic
def _rows_of(x):
    return x.reshape(x.shape[0] * x.shape[1], -1)


def _film(b, c, scale, shift):
    rows = b * c
    sc = torch.ones(rows) if scale is None else scale.reshape(rows).float()
    sh = torch.zeros(rows) if shift is None else shift.reshape(rows).float()
    return sc, sh


def emulate_k4(x, alpha, act, scale, shift, plan):
    """K4's arithmetic as the kernel cuts it: (y in f32, stats [rows, 2])."""
    b, c = x.shape[:2]
    xr = _rows_of(x.float())
    rows, n = xr.shape
    sc, sh = _film(b, c, scale, shift)
    stats = torch.empty(rows, 2)
    y = torch.empty_like(xr)
    for row, spans in sorted(_row_segments(plan, rows, n).items()):
        s = xr[row, 0]
        parts = []
        for e0, e1 in spans:
            t = xr[row, e0:e1] - s                       # f32
            s1, s2 = t.sum(), (t * t).sum()
            cnt = torch.tensor(float(e1 - e0))
            m = s1 / cnt
            parts.append((cnt, m, torch.clamp(s2 - s1 * m, min=0.0)))
        # the f64 merge of the row's partials, segment by segment
        mt = sum(p[0].double() * p[1].double() for p in parts) / n
        m2 = sum(p[2].double() + p[0].double() * (p[1].double() - mt) ** 2 for p in parts)
        mean = (s.double() + mt).float()
        rstd = torch.rsqrt((m2 / n).float() + EPS)
        stats[row] = torch.stack([mean, rstd])
        u = sc[row] * ((xr[row] - mean) * rstd) + sh[row]
        y[row] = apply_act(u, act, alpha)
    return y.reshape(x.shape), stats


def emulate_kb3(x, g, stats, alpha, act, scale, shift, plan):
    """KB3's arithmetic as the kernel cuts it: (dx in f32, dalpha [1],
    dscale [B, C], dshift [B, C])."""
    b, c = x.shape[:2]
    xr, gr = _rows_of(x.float()), _rows_of(g.float())
    rows, n = xr.shape
    sc, sh = _film(b, c, scale, shift)
    dx = torch.empty_like(xr)
    sums = torch.empty(rows, 5)
    for row, spans in sorted(_row_segments(plan, rows, n).items()):
        mean, rstd = stats[row]
        yhat_all = (xr[row] - mean) * rstd
        tot = torch.zeros(5, dtype=torch.float64)
        for e0, e1 in spans:
            yhat = yhat_all[e0:e1]
            u = sc[row] * yhat + sh[row]
            gv = gr[row, e0:e1]
            gt = gv * act_deriv(u, act, alpha)
            gy = gt * sc[row]
            part = torch.stack([gy.sum(), (gy * yhat).sum(), (gv * u.clamp(max=0.0)).sum(),
                                (gt * yhat).sum(), gt.sum()])  # f32
            tot += part.double()
        sums[row] = tot.float()
        m0, m1 = (tot[0] / n).float(), (tot[1] / n).float()
        u = sc[row] * yhat_all + sh[row]
        gy = gr[row] * act_deriv(u, act, alpha) * sc[row]
        dx[row] = rstd * (gy - m0 - yhat_all * m1)
    dalpha = torch.zeros(1, dtype=torch.float64)
    for row in range(rows):  # row order, f64
        dalpha += sums[row, 2].double()
    dalpha = dalpha.float() if act == "prelu" else torch.zeros(1)
    return dx.reshape(x.shape), dalpha, sums[:, 3].reshape(b, c), sums[:, 4].reshape(b, c)


def _inputs(shape, film, seed=0, mean=3.0):
    rng = np.random.default_rng(seed)
    b, c = shape[:2]
    # a mean large against the spread exercises the shifted sums; bf16 values
    x = torch.from_numpy((mean + rng.normal(size=shape)).astype(np.float32))
    x = x.bfloat16().float()
    g = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).bfloat16().float()
    alpha = torch.tensor([0.25])
    scale = shift = None
    if film:
        scale = torch.from_numpy((1.0 + 0.3 * rng.normal(size=(b, c))).astype(np.float32))
        shift = torch.from_numpy((0.3 * rng.normal(size=(b, c))).astype(np.float32))
    return x, g, alpha, scale, shift


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / np.abs(want).max())


# (shape, sms, smem_per_cta): several segments a row, several rounds, and
# (for KB3) x kept in part
EMU_SHAPES = [((2, 3, 5, 6, 7), 8, 96),      # N = 210, N % 8 = 2
              ((3, 1, 6, 6, 6), 7, 96),      # C = 1, N = 216
              ((2, 4, 3, 9, 5), 16, 64)]     # N = 135, N % 8 = 7


def _plans(shape, sms, smem):
    rows, n = shape[0] * shape[1], int(np.prod(shape[2:]))
    return na_plan(rows, n, 2, sms, smem), na_plan(rows, n, 4, sms, smem)


def test_emulation_cases_take_several_segments_and_rounds():
    for shape, sms, smem in EMU_SHAPES:
        rows, n = shape[0] * shape[1], int(np.prod(shape[2:]))
        for plan, kb in zip(_plans(shape, sms, smem), (2, 4)):
            assert plan.segs > 1 and plan.rounds > 1
            if kb == 4:  # x is kept in part
                assert plan.keep < 2 * 8 * (plan.seg // 8 + (n % 8 != 0))


@pytest.mark.parametrize("act", ["none", "relu", "leakyrelu", "prelu"])
@pytest.mark.parametrize("film", [False, True])
@pytest.mark.parametrize("case", EMU_SHAPES, ids=lambda c: "x".join(map(str, c[0])))
def test_k4_emulation_matches_plain(case, film, act):
    shape, sms, smem = case
    x, _, alpha, scale, shift = _inputs(shape, film)
    plan = _plans(shape, sms, smem)[0]
    got, stats = emulate_k4(x, alpha, act, scale, shift, plan)
    want = ops.norm_act_plain(x, alpha, act, scale, shift, EPS)
    assert _rel(got, want) < TOL
    xr = _rows_of(x)
    mean = xr.mean(1)
    assert _rel(stats[:, 0], mean) < TOL
    assert _rel(stats[:, 1], torch.rsqrt(((xr - mean[:, None]) ** 2).mean(1) + EPS)) < TOL


@pytest.mark.parametrize("act", ["none", "relu", "leakyrelu", "prelu"])
@pytest.mark.parametrize("film", [False, True])
@pytest.mark.parametrize("case", EMU_SHAPES, ids=lambda c: "x".join(map(str, c[0])))
def test_kb3_emulation_matches_plain(case, film, act):
    shape, sms, smem = case
    x, g, alpha, scale, shift = _inputs(shape, film, seed=1)
    k4_plan, plan = _plans(shape, sms, smem)
    _, stats = emulate_k4(x, alpha, act, scale, shift, k4_plan)
    got = emulate_kb3(x, g, stats, alpha, act, scale, shift, plan)
    want = ops.norm_act_bwd_plain(x, g, alpha, act, scale, shift, EPS)
    for name, a, w in zip(("dx", "dalpha", "dscale", "dshift"), got, want):
        if name == "dalpha" and act != "prelu":
            assert float(a.abs().max()) == 0.0 == float(w.abs().max())
            continue
        assert _rel(a, w) < TOL, name


@pytest.mark.parametrize("act,film", [("prelu", True), ("relu", False)])
def test_emulation_matches_pallas(act, film):
    shape = (2, 3, 4, 8, 128)
    # the Pallas kernel takes var = E[x^2] - mean^2 in f32, which cancels at
    # a mean of 3: the mean of tests/test_torch_port_grads.py
    x, g, alpha, scale, shift = _inputs(shape, film, seed=2, mean=0.5)
    b, c = shape[:2]
    ones, zeros = np.ones((b, c), np.float32), np.zeros((b, c), np.float32)
    sc = scale.numpy() if film else ones
    sh = shift.numpy() if film else zeros
    want_y, aux = _norm_act_fwd_impl(jnp.asarray(x.numpy()), jnp.asarray(alpha.numpy()),
                                     jnp.asarray(sc), jnp.asarray(sh), act, EPS, True)
    want_b = _norm_act_bwd_impl(jnp.asarray(x.numpy()), aux, jnp.asarray(g.numpy()), act, True)
    k4_plan, plan = _plans(shape, 9, 1024)
    assert k4_plan.segs > 1 and plan.segs > 1
    y, stats = emulate_k4(x, alpha, act, scale, shift, k4_plan)
    assert _rel(y, want_y) < TOL
    dx, dalpha, dscale, dshift = emulate_kb3(x, g, stats, alpha, act, scale, shift, plan)
    assert _rel(dx, want_b[0]) < TOL
    assert _rel(dscale, want_b[2]) < TOL and _rel(dshift, want_b[3]) < TOL
    if act == "prelu":
        assert _rel(dalpha, np.reshape(want_b[1], (1,))) < TOL

