"""Stride-1 SAME 3-D convolution, k in {1, 3}: kernel K1 and its plain
version.

Counterpart of `coma_unet_tpu/ops/pallas/conv3d.py` (`_pallas_conv3d_fwd`),
`conv3d_p1.py` (`_p1_fwd`) and `conv3d_packed.py` (`_packed_fwd`): the three
compute one function, split on the TPU only by its 128-lane tiling. Layouts
are the JAX package's: x NCDHW, w OIDHW `[Cout, Cin, k, k, k]` shared or
`[B, Cout, Cin, k, k, k]` per sample. The kernel's source is
`coma_unet_tpu_torch/csrc/conv3d_s1.cu`.
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


def conv3d_s1_plain(x: torch.Tensor, w: torch.Tensor,
                    bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of K1."""
    _build.count_plain("s1", x)
    return conv3d_ref(x, w, bias, stride=1)


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


def conv3d_s1(x: torch.Tensor, w: torch.Tensor,
              bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y = conv(x, w) + bias, stride 1, SAME padding, k = w.shape[-1] in
    {1, 3}. A CUDA tensor launches K1 (bf16 only) or raises; a CPU tensor
    takes the plain version."""
    if not x.is_cuda:
        if x.device.type != "cpu":
            raise ValueError(f"conv3d_s1: unsupported device {x.device}")
        return conv3d_s1_plain(x, w, bias)
    k, per_sample, bias32 = check_conv_args(x, w, bias, (1, 3))
    b, cin, d, h, wd = x.shape
    cout = w.shape[-5]
    y = torch.empty((b, cout, d, h, wd), dtype=x.dtype, device=x.device)
    _build.launch("s1", "coma_conv3d_s1", x.device, x.data_ptr(),
                  w.data_ptr(), _build.ptr(bias32), y.data_ptr(),
                  b, cin, cout, d, h, wd, k, int(per_sample))
    return y
