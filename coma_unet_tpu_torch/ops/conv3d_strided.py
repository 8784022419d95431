"""Stride-2 3-D convolutions between the 128^3 and 64^3 levels: kernels K2
(stride-2 SAME conv) and K3 (its transposed conv), with their plain
versions.

Counterpart of `coma_unet_tpu/ops/pallas/conv3d_strided.py` (`_s2_fwd`,
`_t2_fwd`) and `phase_split.py` (`pallas_hwsplit`, the parity prepass that K2
makes unnecessary by reading the input with stride-2 addressing). Unlike the
TPU kernels, both take and return the plain NCDHW layout: there is no packed
64^3 layout here. Weights are OIDHW `[Cout, Cin, 3, 3, 3]` shared or
`[B, Cout, Cin, 3, 3, 3]` per sample; K3's weights keep the JAX package's
lhs-dilated correlation convention. The kernels' source is
`coma_unet_tpu_torch/csrc/conv3d_strided.cu`.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from coma_unet_tpu_torch.ops import _build
from coma_unet_tpu_torch.ops.conv3d import check_conv_args, conv3d_ref


def conv_transpose3d_ref(x: torch.Tensor, w: torch.Tensor,
                         bias: Optional[torch.Tensor] = None,
                         stride: int = 2) -> torch.Tensor:
    """The JAX package's transposed conv (lhs dilation `stride`, padding
    (k-1-p, s-1+p) with p = (k-1)//2, correlation weights) through PyTorch's
    built-in ConvTranspose3d: flip the taps and swap in/out channels."""
    k = w.shape[-1]
    p = (k - 1) // 2
    kw = dict(stride=stride, padding=p, output_padding=stride + 2 * p - k)
    wt = torch.flip(w, dims=(-3, -2, -1)).transpose(-5, -4)
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


def _device_check(name: str, x: torch.Tensor) -> bool:
    if x.is_cuda:
        return True
    if x.device.type != "cpu":
        raise ValueError(f"{name}: unsupported device {x.device}")
    return False


def conv3d_s2(x: torch.Tensor, w: torch.Tensor,
              bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Stride-2 SAME k=3 conv (padding 1/1): [B, Cin, D, H, W] ->
    [B, Cout, (D-1)//2+1, (H-1)//2+1, (W-1)//2+1]. A CUDA tensor launches K2
    (bf16 only) or raises; a CPU tensor takes the plain version."""
    if not _device_check("conv3d_s2", x):
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


def conv3d_t2(x: torch.Tensor, w: torch.Tensor,
              bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Transposed stride-2 k=3 conv, [B, Cin, D, H, W] -> [B, Cout, 2D, 2H,
    2W] (= ConvTranspose3d(padding=1, output_padding=1) with flipped,
    io-swapped weights). A CUDA tensor launches K3 (bf16 only) or raises; a
    CPU tensor takes the plain version."""
    if not _device_check("conv3d_t2", x):
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
