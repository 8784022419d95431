"""Fused instance norm + FiLM + activation, forward: kernel K4 and its plain
version.

Counterpart of `coma_unet_tpu/ops/pallas/norm_act.py` (`norm_act`, forward
only). Per (b, c): f32 mean and variance over the spatial dims, eps 1e-5,
then `u = scale * (x - mean) * rsqrt(var + eps) + shift` and
`act(u)` with act in {none, relu, leakyrelu (0.01), prelu (one shared
alpha)}, computed in f32 and stored in x's dtype. The TPU kernel's C == 1
`[1, B, ...]` view is not needed: the kernel treats every (b, c) as a row.
The kernel's source is `coma_unet_tpu_torch/csrc/norm_act.cu`.
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


def _f32_rows(name: str, t: Optional[torch.Tensor], n: int,
              device: torch.device):
    if t is None:
        return None
    if t.numel() != n or t.device != device:
        raise ValueError(f"{name}: need {n} values on {device}, got "
                         f"{tuple(t.shape)} on {t.device}")
    return t.detach().float().contiguous()


def norm_act(x: torch.Tensor, alpha: Optional[torch.Tensor],
             act: Optional[str], scale: Optional[torch.Tensor] = None,
             shift: Optional[torch.Tensor] = None,
             eps: float = 1e-5) -> torch.Tensor:
    """Instance norm of x [B, C, ...] with f32 stats, then FiLM (`scale`,
    `shift` [B, C] f32, identity when None) and `act` (`alpha`: the PReLU
    slope, [1]). A CUDA tensor launches K4 (bf16 only) or raises; a CPU
    tensor takes the plain version."""
    act = act or "none"
    if act not in ACTS:
        raise ValueError(f"unknown activation {act!r}")
    if not x.is_cuda:
        if x.device.type != "cpu":
            raise ValueError(f"norm_act: unsupported device {x.device}")
        return norm_act_plain(x, alpha, act, scale, shift, eps)
    _build.check_cuda_input("x", x, x.dim(), x.device)
    b, c = x.shape[:2]
    rows, n = b * c, math.prod(x.shape[2:])
    scale32 = _f32_rows("scale", scale, rows, x.device)
    shift32 = _f32_rows("shift", shift, rows, x.device)
    if act == "prelu" and alpha is None:
        raise ValueError("prelu needs alpha")
    alpha32 = _f32_rows("alpha", alpha if act == "prelu" else None, 1,
                        x.device)
    nchunk = -(-n // CHUNK)
    part = torch.empty(rows * nchunk * 3, dtype=torch.float32,
                       device=x.device)
    stats = torch.empty(rows * 2, dtype=torch.float32, device=x.device)
    y = torch.empty_like(x)
    _build.launch("norm_act", "coma_norm_act", x.device, x.data_ptr(),
                  _build.ptr(scale32), _build.ptr(shift32),
                  _build.ptr(alpha32), y.data_ptr(), part.data_ptr(),
                  stats.data_ptr(), rows, n, CHUNK, ACTS[act], float(eps))
    return y
