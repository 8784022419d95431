"""Stride-2 3-D convolutions between the 128^3 and 64^3 levels: kernels K2
(stride-2 SAME conv) and K3 (its transposed conv), KB2 (the weight gradient
of both), with their plain versions.

Counterpart of `coma_unet_tpu/ops/pallas/conv3d_strided.py` (`_s2_fwd`,
`_t2_fwd`) and `phase_split.py` (`pallas_hwsplit`, the parity prepass that K2
makes unnecessary by reading the input with stride-2 addressing). Unlike the
TPU kernels, both take and return the plain NCDHW layout: there is no packed
64^3 layout here. Weights are OIDHW `[Cout, Cin, 3, 3, 3]` shared or
`[B, Cout, Cin, 3, 3, 3]` per sample; K3's weights keep the JAX package's
lhs-dilated correlation convention. The kernels' sources are
`coma_unet_tpu_torch/csrc/conv3d_strided.cu` and `csrc/conv3d_dw.cu`.

`conv3d_s2` and `conv3d_t2` are `torch.autograd.Function`s, closed under
AD as in the JAX package (`conv3d_strided.py:961-1079`): the input gradient
of each is the other's forward with `flip_t(w)`, and both weight gradients
are KB2, `conv3d_strided_dw(full, half)`, with the roles of the operands
swapped for the transposed conv.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from coma_unet_tpu_torch.ops import _build
from coma_unet_tpu_torch.ops.conv3d import (
    bias_grad,
    check_conv_args,
    conv3d_ref,
    conv3d_weight_ref,
    device_check,
    flip_t,
)


def conv_transpose3d_ref(x: torch.Tensor, w: torch.Tensor,
                         bias: Optional[torch.Tensor] = None,
                         stride: int = 2) -> torch.Tensor:
    """The JAX package's transposed conv (lhs dilation `stride`, padding
    (k-1-p, s-1+p) with p = (k-1)//2, correlation weights) through PyTorch's
    built-in ConvTranspose3d: flip the taps and swap in/out channels."""
    k = w.shape[-1]
    p = (k - 1) // 2
    kw = dict(stride=stride, padding=p, output_padding=stride + 2 * p - k)
    wt = flip_t(w)
    if w.dim() == 6:
        b, cin, cout = wt.shape[:3]
        y = F.conv_transpose3d(x.reshape((1, b * cin) + x.shape[2:]),
                               wt.reshape((b * cin, cout) + wt.shape[3:]),
                               groups=b, **kw)
        y = y.reshape((b, cout) + y.shape[2:])
    else:
        y = F.conv_transpose3d(x, wt, **kw)
    if bias is not None:
        y = y + bias.to(y.dtype).reshape(1, -1, 1, 1, 1)
    return y


def conv3d_s2_plain(x: torch.Tensor, w: torch.Tensor,
                    bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of K2."""
    _build.count_plain("s2", x)
    return conv3d_ref(x, w, bias, stride=2)


def conv3d_t2_plain(x: torch.Tensor, w: torch.Tensor,
                    bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of K3."""
    _build.count_plain("t2", x)
    return conv_transpose3d_ref(x, w, bias, stride=2)


def conv3d_strided_dw_plain(full: torch.Tensor, half: torch.Tensor,
                            per_sample: bool) -> torch.Tensor:
    """Plain PyTorch version of KB2: the f32 weight gradient of the stride-2
    conv of `full` whose output cotangent is `half`."""
    _build.count_plain("strided_dw", full)
    return conv3d_weight_ref(full.float(), half.float(), 3, per_sample,
                             stride=2)


DW_KT = 32              # positions per shared-memory step of KB2 (csrc/conv3d_dw.cu)
DW_TARGET_BLOCKS = 2048  # blocks a KB2 launch aims for


def dw_split(b: int, positions: int, a: int, n: int) -> int:
    """Positions per block of KB2 (a multiple of DW_KT): the reduction over
    b * positions is split so that the launch has about DW_TARGET_BLOCKS
    blocks of (a, n) output tiles, and no fewer than 16 steps per block."""
    tiles = -(-a // 32) * -(-n // 128)
    splits = max(1, DW_TARGET_BLOCKS // tiles)
    kc = max(-(-b * positions // splits), 16 * DW_KT)
    return -(-kc // DW_KT) * DW_KT


def _half(n: int) -> int:
    return (n - 1) // 2 + 1


def conv3d_strided_dw(full: torch.Tensor, half: torch.Tensor,
                      per_sample: bool) -> torch.Tensor:
    """M[cp, cf, t] = sum_p half[cp, p] * full[cf, 2p + t - 1] (taps t in
    3^3, zero outside `full`), f32 [Cp, Cf, 3, 3, 3], or [B, Cp, Cf, 3, 3,
    3] per sample: full [B, Cf, D, H, W], half [B, Cp, (D-1)//2+1, ...].
    For the stride-2 conv (full = x, half = g) M is dW; the transposed conv
    takes full = g, half = x. A CUDA tensor launches KB2 (bf16 only) or
    raises; a CPU tensor takes the plain version."""
    if not device_check("conv3d_strided_dw", full):
        return conv3d_strided_dw_plain(full, half, per_sample)
    _build.check_cuda_input("full", full, 5, full.device)
    _build.check_cuda_input("half", half, 5, full.device)
    b, cf, d, h, wd = full.shape
    cp = half.shape[1]
    pshape = (_half(d), _half(h), _half(wd))
    if half.shape[0] != b or tuple(half.shape[2:]) != pshape:
        raise ValueError(f"conv3d_strided_dw: half {tuple(half.shape)} is not "
                         f"the stride-2 grid of full {tuple(full.shape)}")
    positions, n = pshape[0] * pshape[1] * pshape[2], cf * 27
    kc = dw_split(b, positions, cp, n)
    splits = b * -(-positions // kc)
    ws = torch.empty(splits * cp * n, dtype=torch.float32, device=full.device)
    out = torch.empty(((b,) if per_sample else ()) + (cp, cf, 3, 3, 3),
                      dtype=torch.float32, device=full.device)
    _build.launch("strided_dw", "coma_conv3d_strided_dw", full.device,
                  full.data_ptr(), half.data_ptr(), ws.data_ptr(),
                  out.data_ptr(), b, cf, cp, d, h, wd, int(per_sample), kc)
    return out


def _k2(x: torch.Tensor, w: torch.Tensor,
        bias: Optional[torch.Tensor]) -> torch.Tensor:
    """K2 on a CUDA tensor, the plain version on a CPU tensor."""
    if not device_check("conv3d_s2", x):
        return conv3d_s2_plain(x, w, bias)
    _, per_sample, bias32 = check_conv_args(x, w, bias, (3,))
    b, cin, d, h, wd = x.shape
    cout = w.shape[-5]
    y = torch.empty((b, cout, (d - 1) // 2 + 1, (h - 1) // 2 + 1,
                     (wd - 1) // 2 + 1), dtype=x.dtype, device=x.device)
    _build.launch("s2", "coma_conv3d_s2", x.device, x.data_ptr(),
                  w.data_ptr(), _build.ptr(bias32), y.data_ptr(),
                  b, cin, cout, d, h, wd, int(per_sample))
    return y


def _k3(x: torch.Tensor, w: torch.Tensor,
        bias: Optional[torch.Tensor]) -> torch.Tensor:
    """K3 on a CUDA tensor, the plain version on a CPU tensor."""
    if not device_check("conv3d_t2", x):
        return conv3d_t2_plain(x, w, bias)
    _, per_sample, bias32 = check_conv_args(x, w, bias, (3,))
    b, cin, d, h, wd = x.shape
    cout = w.shape[-5]
    y = torch.empty((b, cout, 2 * d, 2 * h, 2 * wd), dtype=x.dtype,
                    device=x.device)
    _build.launch("t2", "coma_conv3d_t2", x.device, x.data_ptr(),
                  w.data_ptr(), _build.ptr(bias32), y.data_ptr(),
                  b, cin, cout, d, h, wd, int(per_sample))
    return y


def _input_grad(fn, g: torch.Tensor, w: torch.Tensor,
                like: torch.Tensor) -> torch.Tensor:
    dx = fn(g, flip_t(w), None)
    if dx.shape != like.shape:
        raise ValueError(f"input gradient {tuple(dx.shape)} does not match "
                         f"the input {tuple(like.shape)}: the strided pair is "
                         f"each other's adjoint only for even sizes")
    return dx


class Conv3dS2(torch.autograd.Function):
    """Stride-2 conv; backward as `conv3d_strided.py:_s2_vjp_bwd`: dx is K3
    on g with `flip_t(w)`, dW is KB2 (full = x, half = g)."""

    @staticmethod
    def forward(ctx, x, w, bias):
        ctx.save_for_backward(x, w, bias)
        return _k2(x, w, bias)

    @staticmethod
    def backward(ctx, g):
        x, w, bias = ctx.saved_tensors
        gx = g.to(x.dtype).contiguous()
        dx = dw = dbias = None
        if ctx.needs_input_grad[0]:
            dx = _input_grad(_k3, gx, w, x)
        if ctx.needs_input_grad[1]:
            dw = conv3d_strided_dw(x, gx, w.dim() == 6).to(w.dtype)
        if ctx.needs_input_grad[2]:
            dbias = bias_grad(g, bias)
        return dx, dw, dbias


class Conv3dT2(torch.autograd.Function):
    """Transposed stride-2 conv; backward as `_t2_vjp_bwd`: dx is K2 on g
    with `flip_t(w)`, dW is KB2 (full = g, half = x) with its channel axes
    swapped and its taps flipped."""

    @staticmethod
    def forward(ctx, x, w, bias):
        ctx.save_for_backward(x, w, bias)
        return _k3(x, w, bias)

    @staticmethod
    def backward(ctx, g):
        x, w, bias = ctx.saved_tensors
        gx = g.to(x.dtype).contiguous()
        dx = dw = dbias = None
        if ctx.needs_input_grad[0]:
            dx = _input_grad(_k2, gx, w, x)
        if ctx.needs_input_grad[1]:
            m = conv3d_strided_dw(gx, x, w.dim() == 6)  # [(B,) Cin, Cout, taps]
            dw = torch.flip(m.transpose(-5, -4), dims=(-3, -2, -1)).to(w.dtype)
        if ctx.needs_input_grad[2]:
            dbias = bias_grad(g, bias)
        return dx, dw, dbias


def conv3d_s2(x: torch.Tensor, w: torch.Tensor,
              bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Stride-2 SAME k=3 conv (padding 1/1): [B, Cin, D, H, W] ->
    [B, Cout, (D-1)//2+1, (H-1)//2+1, (W-1)//2+1], differentiable in x, w
    and bias. A CUDA tensor launches K2 (bf16 only; K3 and KB2 in the
    backward) or raises; a CPU tensor takes the plain versions."""
    device_check("conv3d_s2", x)
    return Conv3dS2.apply(x, w, bias)


def conv3d_t2(x: torch.Tensor, w: torch.Tensor,
              bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Transposed stride-2 k=3 conv, [B, Cin, D, H, W] -> [B, Cout, 2D, 2H,
    2W] (= ConvTranspose3d(padding=1, output_padding=1) with flipped,
    io-swapped weights), differentiable in x, w and bias. A CUDA tensor
    launches K3 (bf16 only; K2 and KB2 in the backward) or raises; a CPU
    tensor takes the plain versions."""
    device_check("conv3d_t2", x)
    return Conv3dT2.apply(x, w, bias)
