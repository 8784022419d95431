"""Fused instance norm + FiLM + activation: kernels K4 (forward) and KB3
(backward), with their plain versions.

Counterpart of `coma_unet_tpu/ops/pallas/norm_act.py` (`pallas_norm_act`
and its custom VJP, `_norm_act_fwd_impl` / `_norm_act_bwd_impl`). Per (b, c): f32 mean and variance over the spatial dims, eps 1e-5,
then `u = scale * (x - mean) * rsqrt(var + eps) + shift` and
`act(u)` with act in {none, relu, leakyrelu (0.01), prelu (one shared
alpha)}, computed in f32 and stored in x's dtype. The TPU kernel's C == 1
`[1, B, ...]` view is not needed: the kernel treats every (b, c) as a row.
The kernels' source is `coma_unet_tpu_torch/csrc/norm_act.cu`.

`norm_act` is a `torch.autograd.Function`: on a CUDA tensor the forward
launches K4 and keeps its per-row (mean, rstd) for KB3, which returns dx,
dscale and dshift ([B, C] f32) and dalpha (one slope, summed over all rows);
on a CPU tensor both directions run the plain versions.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from coma_unet_tpu_torch.ops import _build

ACTS = {"none": 0, "relu": 1, "leakyrelu": 2, "prelu": 3}
LEAKY_SLOPE = 1e-2
# voxels of one row per block of the stats and apply passes (multiple of 8)
CHUNK = 16384


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
    return t.detach().float().contiguous()


def _rows(x: torch.Tensor):
    b, c = x.shape[:2]
    return b * c, math.prod(x.shape[2:])


def _k4(x: torch.Tensor, alpha32, scale32, shift32, act: str, eps: float):
    """K4: (y, stats [rows, 2] = per-row (mean, rstd))."""
    _build.check_cuda_input("x", x, x.dim(), x.device)
    rows, n = _rows(x)
    nchunk = -(-n // CHUNK)
    part = torch.empty(rows * nchunk * 3, dtype=torch.float32,
                       device=x.device)
    stats = torch.empty((rows, 2), dtype=torch.float32, device=x.device)
    y = torch.empty_like(x)
    _build.launch("norm_act", "coma_norm_act", x.device, x.data_ptr(),
                  _build.ptr(scale32), _build.ptr(shift32),
                  _build.ptr(alpha32), y.data_ptr(), part.data_ptr(),
                  stats.data_ptr(), rows, n, CHUNK, ACTS[act], float(eps))
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
    """K4 on a CUDA tensor (bf16 only): (y, stats), where stats [B * C, 2]
    holds the per-row (mean, rstd) that `norm_act_bwd` takes."""
    act = act or "none"
    return _k4(x, *_cuda_params(x, alpha, act, scale, shift), act, eps)


def norm_act_bwd(x: torch.Tensor, g: torch.Tensor, stats: torch.Tensor,
                 alpha: Optional[torch.Tensor], act: Optional[str],
                 scale: Optional[torch.Tensor] = None,
                 shift: Optional[torch.Tensor] = None):
    """KB3 on CUDA tensors (bf16 x and g): (dx, dalpha [1], dscale [B, C],
    dshift [B, C]) from the forward's `stats`."""
    act = act or "none"
    alpha32, scale32, shift32 = _cuda_params(x, alpha, act, scale, shift)
    _build.check_cuda_input("x", x, x.dim(), x.device)
    _build.check_cuda_input("g", g, x.dim(), x.device)
    rows, n = _rows(x)
    if g.shape != x.shape or tuple(stats.shape) != (rows, 2):
        raise ValueError(f"norm_act_bwd: g {tuple(g.shape)} and stats "
                         f"{tuple(stats.shape)} do not fit x {tuple(x.shape)}")
    _build.check_cuda_input("stats", stats, 2, x.device, torch.float32)
    nchunk = -(-n // CHUNK)
    part = torch.empty(rows * nchunk * 5, dtype=torch.float32,
                       device=x.device)
    sums = torch.empty((rows, 5), dtype=torch.float32, device=x.device)
    dalpha = torch.empty(1, dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    _build.launch("norm_act_bwd", "coma_norm_act_bwd", x.device,
                  x.data_ptr(), g.data_ptr(), stats.data_ptr(),
                  _build.ptr(scale32), _build.ptr(shift32),
                  _build.ptr(alpha32), dx.data_ptr(), part.data_ptr(),
                  sums.data_ptr(), dalpha.data_ptr(), rows, n, CHUNK,
                  ACTS[act])
    b, c = x.shape[:2]
    if act != "prelu":
        dalpha.zero_()
    return dx, dalpha, sums[:, 3].reshape(b, c), sums[:, 4].reshape(b, c)


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
    launches K4 (bf16 only; KB3 in the backward) or raises; a CPU tensor
    takes the plain versions."""
    act = act or "none"
    if act not in ACTS:
        raise ValueError(f"unknown activation {act!r}")
    if not x.is_cuda and x.device.type != "cpu":
        raise ValueError(f"norm_act: unsupported device {x.device}")
    return NormAct.apply(x, alpha, scale, shift, act, eps)
