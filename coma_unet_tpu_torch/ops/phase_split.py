"""The H-parity split: kernel KS and its plain version.

Counterpart of `coma_unet_tpu/ops/pallas/phase_split.py:pallas_hsplit`:
x [B, C, D, H, W] (H even) -> (h0, h1), the phases [B, C, D, H/2, W] of
even and odd H. The JAX package uses it only as a standalone prepass
(`scripts/kernel_probe.py`); no strided kernel of the port needs it, since
K2 reads its input with stride-2 addressing. The kernel's source is
`coma_unet_tpu_torch/csrc/phase_split.cu`; it copies bits, so it agrees
with the plain version exactly. Its entries are templated on the element
type: bf16 (`phase_split`) and float32 (`phase_split_f32`).
"""

from __future__ import annotations

from typing import Tuple

import torch

from coma_unet_tpu_torch.ops import _build
from coma_unet_tpu_torch.ops.conv3d import device_check


def hsplit_plain(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of KS."""
    _build.count_plain("phase_split", x)
    return x[..., 0::2, :].contiguous(), x[..., 1::2, :].contiguous()


def hsplit(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(h0, h1) = (x[..., 0::2, :], x[..., 1::2, :]) of x [B, C, D, H, W],
    H even, as contiguous tensors. A CUDA tensor launches KS (bf16, or its
    float32 form for f32) or raises; a CPU tensor takes the plain
    version."""
    if x.dim() != 5 or x.shape[3] % 2:
        raise ValueError(f"hsplit takes [B, C, D, H, W] with H even, got "
                         f"{tuple(x.shape)}")
    if not device_check("hsplit", x):
        return hsplit_plain(x)
    dtype = _build.kernel_dtype("x", x)
    _build.check_cuda_input("x", x, 5, x.device, dtype)
    b, c, d, h, w = x.shape
    shape = (b, c, d, h // 2, w)
    h0 = torch.empty(shape, dtype=x.dtype, device=x.device)
    h1 = torch.empty(shape, dtype=x.dtype, device=x.device)
    if x.numel():
        family = _build.family("phase_split", dtype)
        entry = "coma_hsplit" + ("_f32" if dtype == torch.float32 else "")
        _build.launch(family, entry, x.device, x.data_ptr(),
                      h0.data_ptr(), h1.data_ptr(), b * c * d * (h // 2),
                      w * x.element_size())
    return h0, h1
