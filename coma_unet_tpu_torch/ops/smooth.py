"""Gaussian smoothing with MONAI `GaussianSmooth`'s semantics (counterpart
of `coma_unet_tpu/ops/smooth.py`): the 1-D kernel, which the data
pipeline's `smoothing` option convolves along each axis on the host, and
`gaussian_smooth`, the separable 3-D smoothing of a tensor on its device
(sigma 1.0 by default; 2 / 2.355 is an FWHM-2 kernel).

The default "erf" approximation integrates the Gaussian over [x-0.5, x+0.5]
at each integer tap x, truncated at `truncated` sigmas and normalized.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def gaussian_kernel1d(sigma: float, truncated: float = 4.0,
                      approx: str = "erf") -> np.ndarray:
    tail = max(int(sigma * truncated + 0.5), 1)
    xs = np.arange(-tail, tail + 1, dtype=np.float64)
    if approx == "erf":
        from scipy.special import erf

        s = sigma * math.sqrt(2.0)
        k = 0.5 * (erf((xs + 0.5) / s) - erf((xs - 0.5) / s))
    else:  # "sampled"
        k = np.exp(-0.5 * (xs / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def gaussian_smooth(x: torch.Tensor, sigma: float = 1.0,
                    truncated: float = 4.0, approx: str = "erf") -> torch.Tensor:
    """Separable 3-D Gaussian smoothing of a [B, C, D, H, W] or [D, H, W]
    tensor with zero (SAME) padding: three depthwise 1-D convs in x's
    dtype, on x's device. The JAX package leaves this conv to XLA, so it
    is PyTorch's conv here."""
    squeeze = x.dim() == 3
    if squeeze:
        x = x[None, None]
    kernel = torch.as_tensor(gaussian_kernel1d(sigma, truncated, approx),
                             dtype=x.dtype, device=x.device)
    size, c = kernel.numel(), x.shape[1]
    for axis in range(3):
        shape, padding = [1, 1, 1], [0, 0, 0]
        shape[axis], padding[axis] = size, size // 2
        weight = kernel.reshape(shape).expand((c, 1, *shape)).contiguous()
        x = F.conv3d(x, weight, padding=tuple(padding), groups=c)
    return x[0, 0] if squeeze else x
