"""Stride-1 SAME 3-D convolution, k in {1, 3}, and its gradients: kernel K1
(forward, and the input gradient with flipped, io-swapped weights), kernel
KB1 (the weight gradient) and their plain versions.

Counterpart of `coma_unet_tpu/ops/pallas/conv3d.py` (`pallas_conv3d`,
`pallas_conv3d_b` and their custom VJPs: `_pallas_conv3d_fwd`,
`_pallas_conv3d_dw`), `conv3d_p1.py` (`_p1_fwd`, `_p1_dw`) and
`conv3d_packed.py` (`_packed_fwd`, `_packed_dw`): the three compute one
function, split on the TPU only by its 128-lane tiling. Layouts are the JAX
package's: x NCDHW, w OIDHW `[Cout, Cin, k, k, k]` shared or
`[B, Cout, Cin, k, k, k]` per sample. `conv3d_s1` is a
`torch.autograd.Function`: on a CUDA tensor its forward and backward launch
the kernels (sources `coma_unet_tpu_torch/csrc/conv3d_s1.cu`,
`csrc/conv3d_dw.cu`) or raise; on a CPU tensor they run the plain versions.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from coma_unet_tpu_torch.ops import _build


def conv3d_ref(x: torch.Tensor, w: torch.Tensor,
               bias: Optional[torch.Tensor] = None,
               stride: int = 1) -> torch.Tensor:
    """SAME-padded (k // 2) correlation through PyTorch's built-in conv, for
    shared or per-sample weights; the bias is added in x's dtype."""
    k = w.shape[-1]
    if w.dim() == 6:
        b, cout, cin = w.shape[:3]
        y = F.conv3d(x.reshape((1, b * cin) + x.shape[2:]),
                     w.reshape((b * cout, cin) + w.shape[3:]),
                     stride=stride, padding=k // 2, groups=b)
        y = y.reshape((b, cout) + y.shape[2:])
    else:
        y = F.conv3d(x, w, stride=stride, padding=k // 2)
    if bias is not None:
        y = y + bias.to(y.dtype).reshape(1, -1, 1, 1, 1)
    return y


def conv3d_weight_ref(x: torch.Tensor, g: torch.Tensor, k: int,
                      per_sample: bool, stride: int = 1) -> torch.Tensor:
    """Weight gradient of `conv3d_ref(x, w, stride=stride)` for the output
    cotangent g, through PyTorch's built-in in the operands' dtype (for bf16
    operands, what autograd of a bf16 conv runs): [Cout, Cin, k, k, k], or
    [B, Cout, Cin, k, k, k] per sample (a grouped conv over the batch)."""
    b, cin = x.shape[:2]
    cout = g.shape[1]
    kw = dict(stride=stride, padding=k // 2)
    if not per_sample:
        return torch.nn.grad.conv3d_weight(x, (cout, cin, k, k, k), g, **kw)
    dw = torch.nn.grad.conv3d_weight(
        x.reshape((1, b * cin) + x.shape[2:]), (b * cout, cin, k, k, k),
        g.reshape((1, b * cout) + g.shape[2:]), groups=b, **kw)
    return dw.reshape(b, cout, cin, k, k, k)


def flip_t(w: torch.Tensor) -> torch.Tensor:
    """Spatially flipped, io-swapped weights, shared [Cout, Cin, k, k, k] ->
    [Cin, Cout, k, k, k] or per sample [B, Cout, Cin, ...] -> [B, Cin, Cout,
    ...]: the conv with these weights is the adjoint in x of the conv with
    w (stride 1), and the strided pair's adjoints likewise."""
    return torch.flip(w, dims=(-3, -2, -1)).transpose(-5, -4).contiguous()


def conv3d_s1_plain(x: torch.Tensor, w: torch.Tensor,
                    bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of K1."""
    _build.count_plain("s1", x)
    return conv3d_ref(x, w, bias, stride=1)


def conv3d_s1_dw_plain(x: torch.Tensor, g: torch.Tensor, k: int,
                       per_sample: bool) -> torch.Tensor:
    """Plain PyTorch version of KB1: f32 dW of the stride-1 SAME conv."""
    _build.count_plain("s1_dw", x)
    return conv3d_weight_ref(x.float(), g.float(), k, per_sample)


def check_conv_args(x: torch.Tensor, w: torch.Tensor,
                    bias: Optional[torch.Tensor], ks: Sequence[int]):
    """Validate a CUDA conv call; return (k, per_sample, f32 bias or None)."""
    _build.check_cuda_input("x", x, 5, x.device)
    per_sample = w.dim() == 6
    _build.check_cuda_input("w", w, 6 if per_sample else 5, x.device)
    k = w.shape[-1]
    cout, cin = w.shape[-5], w.shape[-4]
    if (k not in ks or tuple(w.shape[-3:]) != (k, k, k) or cin != x.shape[1]
            or (per_sample and w.shape[0] != x.shape[0])):
        raise ValueError(f"weights {tuple(w.shape)} do not fit input "
                         f"{tuple(x.shape)} (k in {tuple(ks)})")
    if bias is None:
        return k, per_sample, None
    if tuple(bias.shape) != (cout,) or bias.device != x.device:
        raise ValueError(f"bias {tuple(bias.shape)} on {bias.device} is not "
                         f"[{cout}] on {x.device}")
    return k, per_sample, bias.detach().float().contiguous()


def device_check(name: str, x: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU tensor; raise otherwise."""
    if x.is_cuda:
        return True
    if x.device.type != "cpu":
        raise ValueError(f"{name}: unsupported device {x.device}")
    return False


def _k1(x: torch.Tensor, w: torch.Tensor,
        bias: Optional[torch.Tensor]) -> torch.Tensor:
    """K1 on a CUDA tensor, the plain version on a CPU tensor."""
    if not device_check("conv3d_s1", x):
        return conv3d_s1_plain(x, w, bias)
    k, per_sample, bias32 = check_conv_args(x, w, bias, (1, 3))
    b, cin, d, h, wd = x.shape
    cout = w.shape[-5]
    y = torch.empty((b, cout, d, h, wd), dtype=x.dtype, device=x.device)
    _build.launch("s1", "coma_conv3d_s1", x.device, x.data_ptr(),
                  w.data_ptr(), _build.ptr(bias32), y.data_ptr(),
                  b, cin, cout, d, h, wd, k, int(per_sample))
    return y


DW_KT = 32              # positions per step of KB1/KB2 (csrc/conv3d_dw.cu)
DW_TARGET_BLOCKS = 2048  # blocks a weight-gradient launch aims for


def dw_split(b: int, positions: int, a: int, n: int) -> int:
    """Positions per block of KB1/KB2 (a multiple of DW_KT): the reduction
    over b * positions is split so that the launch has about
    DW_TARGET_BLOCKS blocks of (a, n) output tiles, and no fewer than
    16 steps per block."""
    tiles = -(-a // 32) * -(-n // 128)
    splits = max(1, DW_TARGET_BLOCKS // tiles)
    kc = max(-(-b * positions // splits), 16 * DW_KT)
    return -(-kc // DW_KT) * DW_KT


def dw_workspace(b: int, positions: int, kc: int, a: int, n: int,
                 device: torch.device) -> torch.Tensor:
    """f32 scratch for the partial sums of every split of KB1/KB2."""
    splits = b * -(-positions // kc)
    return torch.empty(splits * a * n, dtype=torch.float32, device=device)


def conv3d_s1_dw(x: torch.Tensor, g: torch.Tensor, k: int,
                 per_sample: bool) -> torch.Tensor:
    """Weight gradient of the stride-1 SAME conv, f32: [Cout, Cin, k, k, k],
    or [B, Cout, Cin, k, k, k] per sample, from x [B, Cin, ...] and the
    output cotangent g [B, Cout, ...]. A CUDA tensor launches KB1 (bf16
    only) or raises; a CPU tensor takes the plain version."""
    if not device_check("conv3d_s1_dw", x):
        return conv3d_s1_dw_plain(x, g, k, per_sample)
    _build.check_cuda_input("x", x, 5, x.device)
    _build.check_cuda_input("g", g, 5, x.device)
    b, cin, d, h, wd = x.shape
    cout = g.shape[1]
    if k not in (1, 3) or g.shape[0] != b or tuple(g.shape[2:]) != (d, h, wd):
        raise ValueError(f"conv3d_s1_dw: x {tuple(x.shape)} and g "
                         f"{tuple(g.shape)} do not fit a k={k} conv")
    positions, n = d * h * wd, cin * k ** 3
    kc = dw_split(b, positions, cout, n)
    ws = dw_workspace(b, positions, kc, cout, n, x.device)
    out = torch.empty(((b,) if per_sample else ()) + (cout, cin, k, k, k),
                      dtype=torch.float32, device=x.device)
    _build.launch("s1_dw", "coma_conv3d_s1_dw", x.device, x.data_ptr(),
                  g.data_ptr(), ws.data_ptr(), out.data_ptr(), b, cin, cout,
                  d, h, wd, k, int(per_sample), kc)
    return out


def bias_grad(g: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """dbias: the output cotangent summed over all but the channel axis, in
    f32 (the JAX package leaves the bias to XLA; so does the port)."""
    return g.float().sum(dim=(0, 2, 3, 4)).to(bias.dtype)


class Conv3dS1(torch.autograd.Function):
    """y = conv(x, w) + bias; backward as `conv3d.py:_bwd`/`_bwd_b`: dx is
    K1 on g with `flip_t(w)`, dW is KB1, dbias a plain reduction."""

    @staticmethod
    def forward(ctx, x, w, bias):
        ctx.save_for_backward(x, w, bias)
        return _k1(x, w, bias)

    @staticmethod
    def backward(ctx, g):
        x, w, bias = ctx.saved_tensors
        gx = g.to(x.dtype).contiguous()
        dx = dw = dbias = None
        if ctx.needs_input_grad[0]:
            dx = _k1(gx, flip_t(w), None)
        if ctx.needs_input_grad[1]:
            dw = conv3d_s1_dw(x, gx, w.shape[-1], w.dim() == 6).to(w.dtype)
        if ctx.needs_input_grad[2]:
            dbias = bias_grad(g, bias)
        return dx, dw, dbias


def conv3d_s1(x: torch.Tensor, w: torch.Tensor,
              bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y = conv(x, w) + bias, stride 1, SAME padding, k = w.shape[-1] in
    {1, 3}, differentiable in x, w and bias. A CUDA tensor launches K1
    (bf16 only; KB1 and K1 in the backward) or raises; a CPU tensor takes
    the plain versions."""
    device_check("conv3d_s1", x)
    return Conv3dS1.apply(x, w, bias)


def conv3d_w64(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Stride-1 SAME k=3 conv of x [B, Cin, D, H, 64] (D even) with shared
    weights w [Cout, Cin, 3, 3, 3]: counterpart of `coma_unet_tpu/ops/
    pallas/conv3d_packed.py:pallas_conv3d_w64`. The TPU packs D-pairs onto
    its 128 lanes around the kernel; here it is K1 on the plain layout."""
    if (x.dim() != 5 or x.shape[-1] != 64 or x.shape[2] % 2
            or w.dim() != 5 or tuple(w.shape[2:]) != (3, 3, 3)):
        raise ValueError(f"conv3d_w64 takes x [B, C, D even, H, 64] and w "
                         f"[Cout, Cin, 3, 3, 3], got {tuple(x.shape)} and "
                         f"{tuple(w.shape)}")
    return conv3d_s1(x, w)
