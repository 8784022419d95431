"""Fused instance norm + FiLM + activation: kernels K4 (forward) and KB3
(backward), with their plain versions.

Counterpart of `coma_unet_tpu/ops/pallas/norm_act.py` (`pallas_norm_act`
and its custom VJP, `_norm_act_fwd_impl` / `_norm_act_bwd_impl`). Per (b, c): f32 mean and variance over the spatial dims, eps 1e-5,
then `u = scale * (x - mean) * rsqrt(var + eps) + shift` and
`act(u)` with act in {none, relu, leakyrelu (0.01), prelu (one shared
alpha)}, computed in f32 and stored in x's dtype. The TPU kernel's C == 1
`[1, B, ...]` view is not needed: the kernel treats every (b, c) as a row.
The kernels' source is `coma_unet_tpu_torch/csrc/norm_act.cu`; every kernel
there is templated on the element type, and a CUDA tensor of dtype float32
launches its float32 form (counted as `norm_act_f32` and so on).

`norm_act` is a `torch.autograd.Function`: on a CUDA tensor the forward
launches K4 and keeps its per-row (mean, rstd) for KB3, which returns dx,
dscale and dshift ([B, C] f32) and dalpha (one slope, summed over all rows);
on a CPU tensor both directions run the plain versions.

K4's slab form, for a rank that holds only a depth slab of each row
(`parallel/spatial.py`), is K4's two halves as two entries of the same
source: `norm_stats` (each row's (count, mean, M2) of the slab, f64; the
Pallas `_stats_kernel`), `merge_partials` across the ranks, then
`norm_apply` (the Pallas `_apply_kernel`). Forward only.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional

import torch

from coma_unet_tpu_torch.ops import _build

ACTS = {"none": 0, "relu": 1, "leakyrelu": 2, "prelu": 3}
LEAKY_SLOPE = 1e-2
# K4 and KB3 (csrc/norm_act.cu) run one persistent, co-resident grid: each
# CTA takes one segment of a row a round, keeps it in shared memory, and
# meets the row's other segments at a counter.
NA_SMS = 132             # streaming multiprocessors of the H100 (the wrapper
                         # passes the device's own count)
NA_SMEM = 223 * 1024     # dynamic shared memory a CTA keeps data in
NA_MIN_SEG = 4096        # a row is spread over more CTAs only down to this
                         # many voxels a segment


class NaPlan(NamedTuple):
    """How one K4 or KB3 call is cut. Each row (b, c) of `n` voxels is split
    into `segs` segments of `seg` voxels (a multiple of 8; the last one may
    be shorter), each on its own CTA. A round takes `rows_per_round` rows,
    so the grid is `rows_per_round * segs` CTAs and CTA i takes segment
    i % segs of row r * rows_per_round + i // segs in round r, for `rounds`
    rounds. A CTA keeps `keep` values of its segment (of the plan's element
    size) in shared memory (`smem` bytes): KB3 keeps g's first, then as much
    of x as fits, and reads the rest again. `bulk`: every segment starts and
    ends on 16 bytes, so it is copied by the bulk copy engine."""
    segs: int
    rows_per_round: int
    rounds: int
    seg: int
    keep: int
    grid: int
    bulk: bool
    smem: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=512)
def na_plan(rows: int, n: int, kept_bytes_per_voxel: int, sms: int = NA_SMS,
            smem_per_cta: int = NA_SMEM, elem: int = 2) -> NaPlan:
    """The cut of K4 (`kept_bytes_per_voxel` = `elem`: x) or KB3 (2 `elem`:
    x and g) for `rows` rows of `n` voxels of `elem` bytes (2: bf16, 4: the
    float32 forms) on `sms` CTAs of `smem_per_cta` bytes: the fewest
    segments a row that keep it whole in shared memory (at most one a CTA),
    as many rows a round as the grid takes, the rounds balanced, and each
    row then spread over as many CTAs as the round leaves, down to
    NA_MIN_SEG voxels a segment. A 16-byte group holds 16 / `elem` values;
    rows whose N is not a multiple of that start off 16 bytes: a segment
    may then touch one more group, which the keep allows for. Segments are
    multiples of 8 voxels for either size."""
    tensors = kept_bytes_per_voxel // elem
    vec = 16 // elem                     # values a 16-byte group
    groups = smem_per_cta // 16          # 16-byte groups a CTA can keep
    ragged = n % vec != 0

    def cut(segs):
        seg = 8 * _cdiv(_cdiv(n, segs), 8)
        return seg, _cdiv(n, seg)

    def fits(seg):
        return tensors * (seg // vec + ragged) <= groups

    segs = next((s for s in range(1, sms + 1) if fits(cut(s)[0])), sms)
    seg, segs = cut(segs)
    per_round = min(rows, sms // segs)
    rounds = _cdiv(rows, per_round)
    per_round = _cdiv(rows, rounds)
    spread = min(sms // per_round, max(segs, _cdiv(n, NA_MIN_SEG)))
    if spread > segs:
        seg, segs = cut(spread)
    keep = vec * min(groups, tensors * (seg // vec + ragged))
    return NaPlan(segs, per_round, rounds, seg, keep, per_round * segs,
                  not ragged, elem * keep)


def apply_act(u: torch.Tensor, act: str,
              alpha: Optional[torch.Tensor]) -> torch.Tensor:
    if act == "relu":
        return torch.relu(u)
    if act == "leakyrelu":
        return torch.where(u >= 0, u, LEAKY_SLOPE * u)
    if act == "prelu":
        return torch.where(u >= 0, u, alpha.to(u.dtype).reshape(()) * u)
    return u


def act_deriv(u: torch.Tensor, act: str,
              alpha: Optional[torch.Tensor]) -> torch.Tensor:
    """act'(u) as the JAX package takes it (`norm_act.py:_act_deriv`):
    relu's is 1[u > 0], leakyrelu's and prelu's split at u >= 0."""
    one = torch.ones_like(u)
    if act == "relu":
        return torch.where(u > 0, one, 0.0)
    if act == "leakyrelu":
        return torch.where(u >= 0, one, LEAKY_SLOPE)
    if act == "prelu":
        return torch.where(u >= 0, one, alpha.to(u.dtype).reshape(()))
    return one


def norm_act_plain(x: torch.Tensor, alpha: Optional[torch.Tensor],
                   act: Optional[str], scale: Optional[torch.Tensor] = None,
                   shift: Optional[torch.Tensor] = None,
                   eps: float = 1e-5) -> torch.Tensor:
    """Plain PyTorch version of K4 (two-pass f32 statistics)."""
    _build.count_plain("norm_act", x)
    act = act or "none"
    b, c = x.shape[:2]
    bshape = (b, c) + (1,) * (x.dim() - 2)
    dims = tuple(range(2, x.dim()))
    xf = x.float()
    mean = xf.mean(dims, keepdim=True)
    var = (xf - mean).square().mean(dims, keepdim=True)
    u = (xf - mean) * torch.rsqrt(var + eps)
    if scale is not None:
        u = u * scale.float().reshape(bshape)
    if shift is not None:
        u = u + shift.float().reshape(bshape)
    return apply_act(u, act, alpha).to(x.dtype)


def norm_act_bwd_plain(x: torch.Tensor, g: torch.Tensor,
                       alpha: Optional[torch.Tensor], act: Optional[str],
                       scale: Optional[torch.Tensor] = None,
                       shift: Optional[torch.Tensor] = None,
                       eps: float = 1e-5):
    """Plain PyTorch version of KB3, in f32 from the closed form of
    `norm_act.py:_norm_act_bwd_impl`: (dx in x's dtype, dalpha [1],
    dscale [B, C], dshift [B, C])."""
    _build.count_plain("norm_act_bwd", x)
    act = act or "none"
    b, c = x.shape[:2]
    bshape = (b, c) + (1,) * (x.dim() - 2)
    dims = tuple(range(2, x.dim()))
    xf, gf = x.float(), g.float()
    mean = xf.mean(dims, keepdim=True)
    rstd = torch.rsqrt((xf - mean).square().mean(dims, keepdim=True) + eps)
    yhat = (xf - mean) * rstd
    s = 1.0 if scale is None else scale.float().reshape(bshape)
    u = s * yhat + (0.0 if shift is None else shift.float().reshape(bshape))
    gt = gf * act_deriv(u, act, alpha)
    gy = gt * s
    dx = rstd * (gy - gy.mean(dims, keepdim=True)
                 - yhat * (gy * yhat).mean(dims, keepdim=True))
    dalpha = (gf * u.clamp(max=0.0)).sum().reshape(1)
    if act != "prelu":
        dalpha = torch.zeros_like(dalpha)
    return dx.to(x.dtype), dalpha, (gt * yhat).sum(dims), gt.sum(dims)


def _f32_rows(name: str, t: Optional[torch.Tensor], n: int,
              device: torch.device):
    if t is None:
        return None
    if t.numel() != n or t.device != device:
        raise ValueError(f"{name}: need {n} values on {device}, got "
                         f"{tuple(t.shape)} on {t.device}")
    if t.dtype != torch.float32 or not t.is_contiguous():
        t = t.float().contiguous()
    return t


def _rows(x: torch.Tensor):
    b, c = x.shape[:2]
    return b * c, math.prod(x.shape[2:])


_SMS: dict = {}


def _sms(x: torch.Tensor) -> int:
    """The SM count of x's device (cached)."""
    index = x.device.index
    if index not in _SMS:
        props = torch.cuda.get_device_properties(x.device)
        _SMS[index] = props.multi_processor_count
    return _SMS[index]


def _plan(x: torch.Tensor, tensors: int) -> NaPlan:
    """`na_plan` for x's rows on x's device (its own SM count), keeping
    `tensors` tensors of x's element size (K4 1, KB3 2)."""
    elem = x.element_size()
    return na_plan(*_rows(x), tensors * elem, _sms(x), elem=elem)


def _plan_args(plan: NaPlan):
    return (plan.segs, plan.rows_per_round, plan.rounds, plan.seg, plan.keep,
            plan.grid, int(plan.bulk), plan.smem)


def _entry(name: str, dtype: torch.dtype) -> tuple:
    """(family, C entry) of kernel `name` for tensors of `dtype`: the C
    entry of a float32 form is named like its family."""
    family = _build.family(name, dtype)
    return family, "coma_" + family


def _k4(x: torch.Tensor, alpha32, scale32, shift32, act: str, eps: float):
    """K4, one launch cut by `na_plan`: (y, stats [rows, 2] = per-row
    (mean, rstd))."""
    dtype = _build.kernel_dtype("x", x)
    _build.check_cuda_input("x", x, x.dim(), x.device, dtype)
    rows, n = _rows(x)
    plan = _plan(x, 1)
    # the partials, then rows + 1 counters that the C entry zeroes
    scratch = torch.empty(rows * plan.segs * 3 + rows + 1,
                          dtype=torch.float32, device=x.device)
    stats = torch.empty((rows, 2), dtype=torch.float32, device=x.device)
    y = torch.empty_like(x)
    _build.launch(*_entry("norm_act", dtype), x.device, x.data_ptr(),
                  _build.ptr(scale32), _build.ptr(shift32),
                  _build.ptr(alpha32), y.data_ptr(), stats.data_ptr(),
                  scratch.data_ptr(), rows, n, ACTS[act], *_plan_args(plan),
                  float(eps))
    return y, stats


def _cuda_params(x, alpha, act, scale, shift):
    """The f32 per-row FiLM parameters and prelu slope the kernels take."""
    rows, _ = _rows(x)
    if act == "prelu" and alpha is None:
        raise ValueError("prelu needs alpha")
    return (_f32_rows("alpha", alpha if act == "prelu" else None, 1,
                      x.device),
            _f32_rows("scale", scale, rows, x.device),
            _f32_rows("shift", shift, rows, x.device))


def norm_act_forward(x: torch.Tensor, alpha: Optional[torch.Tensor],
                     act: Optional[str], scale: Optional[torch.Tensor] = None,
                     shift: Optional[torch.Tensor] = None,
                     eps: float = 1e-5):
    """K4 on a CUDA tensor (bf16, or its float32 form for f32): (y, stats),
    where stats [B * C, 2] holds the per-row (mean, rstd) that
    `norm_act_bwd` takes."""
    act = act or "none"
    return _k4(x, *_cuda_params(x, alpha, act, scale, shift), act, eps)


def norm_act_bwd(x: torch.Tensor, g: torch.Tensor, stats: torch.Tensor,
                 alpha: Optional[torch.Tensor], act: Optional[str],
                 scale: Optional[torch.Tensor] = None,
                 shift: Optional[torch.Tensor] = None):
    """KB3 on CUDA tensors (x and g bf16, or both f32 for its float32
    form): (dx, dalpha [1], dscale [B, C], dshift [B, C]) from the
    forward's `stats`."""
    act = act or "none"
    alpha32, scale32, shift32 = _cuda_params(x, alpha, act, scale, shift)
    dtype = _build.kernel_dtype("x", x)
    _build.check_cuda_input("x", x, x.dim(), x.device, dtype)
    _build.check_cuda_input("g", g, x.dim(), x.device, dtype)
    rows, n = _rows(x)
    if g.shape != x.shape or tuple(stats.shape) != (rows, 2):
        raise ValueError(f"norm_act_bwd: g {tuple(g.shape)} and stats "
                         f"{tuple(stats.shape)} do not fit x {tuple(x.shape)}")
    _build.check_cuda_input("stats", stats, 2, x.device, torch.float32)
    plan = _plan(x, 2)
    # the partials, then rows + 1 counters that the C entry zeroes
    scratch = torch.empty(rows * plan.segs * 5 + rows + 1,
                          dtype=torch.float32, device=x.device)
    # rows [sum gy, gy * yhat, g * min(u, 0), dscale, dshift], then a row
    # whose first value is dalpha (0 unless prelu)
    sums = torch.empty((rows + 1, 5), dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    _build.launch(*_entry("norm_act_bwd", dtype), x.device,
                  x.data_ptr(), g.data_ptr(), stats.data_ptr(),
                  _build.ptr(scale32), _build.ptr(shift32),
                  _build.ptr(alpha32), dx.data_ptr(), sums.data_ptr(),
                  sums.data_ptr() + 20 * rows, scratch.data_ptr(), rows, n,
                  ACTS[act], *_plan_args(plan))
    b, c = x.shape[:2]
    return (dx, sums[rows, :1], sums[:rows, 3].view(b, c),
            sums[:rows, 4].view(b, c))


class NormAct(torch.autograd.Function):
    """`norm_act` with the backward of `norm_act.py:_vjp_bwd`."""

    @staticmethod
    def forward(ctx, x, alpha, scale, shift, act, eps):
        ctx.act, ctx.eps = act, eps
        if x.is_cuda:
            y, stats = norm_act_forward(x, alpha, act, scale, shift, eps)
        else:
            y, stats = norm_act_plain(x, alpha, act, scale, shift, eps), None
        ctx.save_for_backward(x, stats, alpha, scale, shift)
        return y

    @staticmethod
    def backward(ctx, g):
        x, stats, alpha, scale, shift = ctx.saved_tensors
        g = g.to(x.dtype).contiguous()
        if x.is_cuda:
            dx, dalpha, dscale, dshift = norm_act_bwd(
                x, g, stats, alpha, ctx.act, scale, shift)
        else:
            dx, dalpha, dscale, dshift = norm_act_bwd_plain(
                x, g, alpha, ctx.act, scale, shift, ctx.eps)
        need = ctx.needs_input_grad
        return (dx if need[0] else None,
                dalpha.reshape(alpha.shape).to(alpha.dtype) if need[1] else None,
                dscale.reshape(scale.shape).to(scale.dtype) if need[2] else None,
                dshift.reshape(shift.shape).to(shift.dtype) if need[3] else None,
                None, None)


def norm_act(x: torch.Tensor, alpha: Optional[torch.Tensor],
             act: Optional[str], scale: Optional[torch.Tensor] = None,
             shift: Optional[torch.Tensor] = None,
             eps: float = 1e-5) -> torch.Tensor:
    """Instance norm of x [B, C, ...] with f32 stats, then FiLM (`scale`,
    `shift` [B, C] f32, identity when None) and `act` (`alpha`: the PReLU
    slope, [1]), differentiable in x, alpha, scale and shift. A CUDA tensor
    launches K4 (bf16, or its float32 form for f32; KB3 in the backward) or
    raises; a CPU tensor takes the plain versions."""
    act = act or "none"
    if act not in ACTS:
        raise ValueError(f"unknown activation {act!r}")
    if not x.is_cuda and x.device.type != "cpu":
        raise ValueError(f"norm_act: unsupported device {x.device}")
    return NormAct.apply(x, alpha, scale, shift, act, eps)


# --- K4's slab form: statistics, a merge between them, then the apply -------
#
# Where the depth of a volume is split over ranks (`parallel/spatial.py`),
# each rank holds a slab of every row: `norm_stats` gives each row's
# partial of the slab, `merge_partials` merges the ranks' partials, and
# `norm_apply` normalizes with the merged statistics. K4 itself, which
# needs whole rows, runs wherever a rank holds them.

SLAB_MIN_BYTES = 16384   # bytes a CTA of either half takes at least (one
                         # trip of its 256 threads, four 16-byte loads each),
                         # unless the row is shorter
SLAB_PER_SM = 4          # CTAs of 256 threads an SM holds of the
                         # statistics (csrc/norm_act.cu: SLAB_CTAS); the
                         # wrappers ask the runtime for each compiled
                         # kernel's own (`slab_plan_of`)


class SlabPlan(NamedTuple):
    """How K4's slab halves cut `rows` rows of `n` voxels: each row into
    `segs` segments of `seg` voxels (a multiple of 8, so a segment starts
    on a 16-byte group of the row; the last one may be shorter), one a CTA
    of a (segment, row) grid of `ctas` = rows x segs CTAs, `waves` waves of
    sms x per_sm."""
    segs: int
    seg: int
    ctas: int
    waves: float


def slab_plan(rows: int, n: int, sms: int = NA_SMS, per_sm: int = SLAB_PER_SM,
              elem: int = 2, min_bytes: int = SLAB_MIN_BYTES,
              one_wave: bool = True) -> SlabPlan:
    """The cut of either half: segments of at least `min_bytes` of
    `elem`-byte values (or the whole row), as many a row as one wave of sms
    x per_sm CTAs holds where `one_wave` (the statistics: the CTAs all start
    together, a whole wave where the rows divide it, and a second wave
    would cost each row's CTAs one more start, reduction and ticket, about
    2 us, for no more bytes in flight), else as many as there are
    `min_bytes` pieces (the apply: many short CTAs even out over the SMs as
    they finish; `norm_times.py sweep` read 6-8 waves of them 8-10 % faster
    than one wave at the wide half slab)."""
    segs = max(1, n * elem // min_bytes)
    if one_wave:
        segs = max(1, min(sms * per_sm // rows, segs))
    seg = 8 * _cdiv(_cdiv(n, segs), 8)
    segs = _cdiv(n, seg)
    return SlabPlan(segs, seg, rows * segs, rows * segs / (sms * per_sm))


def row_partials(x: torch.Tensor) -> torch.Tensor:
    """Each row's (count, mean, M2) over x's spatial dims, in f64:
    [B * C, 3]."""
    rows, n = _rows(x)
    xd = x.detach().reshape(rows, n).double()
    mean = xd.mean(1)
    m2 = (xd - mean[:, None]).square().sum(1)
    return torch.stack([torch.full_like(mean, n), mean, m2], 1)


def merge_partials(parts: torch.Tensor) -> torch.Tensor:
    """Partials [S, rows, 3] (count, mean, M2) of S slabs merged in slab
    order into the rows' [rows, 3] (Chan's pairwise update). Every rank
    that merges the same gathered buffer gets the same bits."""
    count, mean, m2 = parts[0].unbind(1)
    for part in parts[1:]:
        n_b, mean_b, m2_b = part.unbind(1)
        total = count + n_b
        delta = mean_b - mean
        mean = mean + delta * (n_b / total)
        m2 = m2 + m2_b + delta * delta * (count * n_b / total)
        count = total
    return torch.stack([count, mean, m2], 1)


def mean_rstd(partials: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """[rows, 2] f32 (mean, rstd) from merged [rows, 3] partials, as K4
    takes them: rstd = rsqrt(f32(M2 / count) + eps)."""
    count, mean, m2 = partials.unbind(1)
    return torch.stack([mean.float(), torch.rsqrt((m2 / count).float() + eps)], 1)


def norm_stats_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of `coma_norm_stats` (two-pass f64)."""
    _build.count_plain("norm_stats", x)
    return row_partials(x)


def norm_apply_plain(x: torch.Tensor, stats: torch.Tensor,
                     alpha: Optional[torch.Tensor], act: Optional[str],
                     scale: Optional[torch.Tensor] = None,
                     shift: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of `coma_norm_apply`: `norm_act_plain` with the
    given per-row (mean, rstd) [B * C, 2]."""
    _build.count_plain("norm_apply", x)
    b, c = x.shape[:2]
    bshape = (b, c) + (1,) * (x.dim() - 2)
    mean, rstd = (s.float().reshape(bshape) for s in stats.unbind(1))
    u = (x.float() - mean) * rstd
    if scale is not None:
        u = u * scale.float().reshape(bshape)
    if shift is not None:
        u = u + shift.float().reshape(bshape)
    return apply_act(u, act or "none", alpha).to(x.dtype)


# The statistics half's workspace on each device: (partials f32, one
# counter a row int32), grown when a call needs more and kept between calls;
# the kernel leaves the counters zero. Calls on one device are ordered on
# its current stream, as the port makes them (each rank of the sharded
# forward is a process of its own): two streams of one device at once would
# share it.
_SLAB_WORK: dict = {}


class _SlabCall(NamedTuple):
    family: str      # the counted family
    entry: str       # its C entry
    rows: int
    n: int
    plan: SlabPlan


@functools.lru_cache(maxsize=256)
def _slab_call(device: torch.device, dtype: torch.dtype, shape: torch.Size, half: int,
               act: int) -> _SlabCall:
    """What a call of slab half `half` (0 the statistics, 1 the apply with
    activation number `act`) on a CUDA tensor of `shape` and `dtype` on
    `device` launches: its entry, its rows and `slab_plan` at the device's
    SM count and the CTAs an SM holds of the compiled kernel, as the runtime
    computes them. Cached, so that the host's part of a call is a lookup,
    one allocation and one launch. Raises for a dtype without kernels."""
    name = "norm_apply" if half else "norm_stats"
    if dtype not in _build.KERNEL_DTYPES:
        raise ValueError(f"{name}: the CUDA kernels take bfloat16 or float32, got {dtype}")
    rows, n = shape[0] * shape[1], math.prod(shape[2:])
    with torch.cuda.device(device):
        ctas = _build.library().coma_slab_ctas_per_sm(half, act, dtype.itemsize)
        sms = torch.cuda.get_device_properties(device).multi_processor_count
    if ctas <= 0:
        raise RuntimeError(f"coma_slab_ctas_per_sm failed: CUDA error {-ctas}")
    return _SlabCall(*_entry(name, dtype), rows, n,
                     slab_plan(rows, n, sms, ctas, dtype.itemsize, one_wave=half == 0))


def slab_plan_of(x: torch.Tensor, half: int, act: str = "none") -> SlabPlan:
    """The plan of slab half `half` (0 `norm_stats`, 1 `norm_apply` with
    `act`) on the CUDA tensor x."""
    return _slab_call(x.device, x.dtype, x.shape, half, ACTS[act] if half else 0).plan


def _contiguous(name: str, x: torch.Tensor) -> None:
    if not x.is_contiguous():
        raise ValueError(f"{name}: the CUDA kernel takes a contiguous x, got "
                         f"{tuple(x.shape)} with strides {x.stride()}")


def _slab_work(device: torch.device, parts: int, rows: int):
    part, count = _SLAB_WORK.get(device.index, (None, None))
    if part is None or part.numel() < parts:
        part = torch.empty(parts, dtype=torch.float32, device=device)
    if count is None or count.numel() < rows:
        count = torch.zeros(rows, dtype=torch.int32, device=device)
    _SLAB_WORK[device.index] = (part, count)
    return part, count


def norm_stats(x: torch.Tensor) -> torch.Tensor:
    """Each row's (count, mean, M2) over x's spatial dims, [B * C, 3] f64:
    `coma_norm_stats` on a CUDA tensor (bf16, or its float32 form for f32),
    one launch into the device's kept workspace; the plain version on a CPU
    tensor."""
    if not x.is_cuda:
        if x.device.type != "cpu":
            raise ValueError(f"norm_stats: unsupported device {x.device}")
        return norm_stats_plain(x)
    call = _slab_call(x.device, x.dtype, x.shape, 0, 0)
    _contiguous("norm_stats", x)
    part, count = _slab_work(x.device, call.rows * call.plan.segs * 3, call.rows)
    out = torch.empty((call.rows, 3), dtype=torch.float64, device=x.device)
    _build.launch(call.family, call.entry, x.device, x.data_ptr(), part.data_ptr(),
                  count.data_ptr(), out.data_ptr(), call.rows, call.n, call.plan.seg,
                  call.plan.segs)
    return out


def norm_apply(x: torch.Tensor, stats: torch.Tensor,
               alpha: Optional[torch.Tensor], act: Optional[str],
               scale: Optional[torch.Tensor] = None,
               shift: Optional[torch.Tensor] = None) -> torch.Tensor:
    """act(scale * (x - mean) * rstd + shift) with the per-row (mean, rstd)
    `stats` [B * C, 2] f32: `coma_norm_apply` on a CUDA tensor (bf16, or
    its float32 form for f32), cut by `slab_plan`; the plain version on a
    CPU tensor."""
    act = act or "none"
    if act not in ACTS:
        raise ValueError(f"unknown activation {act!r}")
    if not x.is_cuda:
        if x.device.type != "cpu":
            raise ValueError(f"norm_apply: unsupported device {x.device}")
        return norm_apply_plain(x, stats, alpha, act, scale, shift)
    alpha32, scale32, shift32 = _cuda_params(x, alpha, act, scale, shift)
    call = _slab_call(x.device, x.dtype, x.shape, 1, ACTS[act])
    _contiguous("norm_apply", x)
    if tuple(stats.shape) != (call.rows, 2):
        raise ValueError(f"norm_apply: stats {tuple(stats.shape)} do not fit "
                         f"x {tuple(x.shape)}")
    _build.check_cuda_input("stats", stats, 2, x.device, torch.float32)
    y = torch.empty_like(x)
    _build.launch(call.family, call.entry, x.device, x.data_ptr(), stats.data_ptr(),
                  _build.ptr(scale32), _build.ptr(shift32), _build.ptr(alpha32),
                  y.data_ptr(), call.rows, call.n, ACTS[act], call.plan.seg,
                  call.plan.segs)
    return y


def instance_norm(x: torch.Tensor, eps: float = 1e-5,
                  act: Optional[str] = None,
                  negative_slope: float = LEAKY_SLOPE) -> torch.Tensor:
    """Instance norm of x [B, C, D, H, W] with f32 stats, then act in {None,
    "relu", "leakyrelu"}: counterpart of `coma_unet_tpu/ops/pallas/
    instance_norm.py:pallas_instance_norm`, as K4 with no FiLM. A leaky
    slope other than K4's 0.01 goes to K4 as its PReLU slope. The Pallas
    kernel takes var = E[x^2] - mean^2; K4 merges shifted partials, so the
    two agree to rounding, not bit for bit."""
    act = act or "none"
    if act not in ("none", "relu", "leakyrelu"):
        raise ValueError(f"instance_norm: unknown activation {act!r}")
    alpha = None
    if act == "leakyrelu" and negative_slope != LEAKY_SLOPE:
        act = "prelu"
        alpha = torch.full((1,), float(negative_slope), dtype=torch.float32,
                           device=x.device)
    return norm_act(x, alpha, act, eps=eps)
