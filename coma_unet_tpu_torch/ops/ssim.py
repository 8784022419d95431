"""3-D SSIM (counterpart of `coma_unet_tpu/ops/ssim.py`): MONAI's
`SSIMMetric(spatial_dims=3, data_range=1.0)` as the reference uses it, a
uniform window of 7, k1 = 0.01, k2 = 0.03, VALID windows, the mean over the
SSIM map per sample, then over samples; or a Gaussian window. Layout NCDHW.

The JAX package leaves SSIM to XLA; here the separable window is a sum of
shifted slices in f32 (f64 for f64 inputs), so that no TF32 convolution
enters the metric on the GPU.
"""

from __future__ import annotations

import numpy as np
import torch


def _gaussian_kernel1d(size: int, sigma: float) -> np.ndarray:
    half = (size - 1) / 2.0
    xs = np.arange(size) - half
    k = np.exp(-0.5 * (xs / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def _sep_filter(x: torch.Tensor, taps) -> torch.Tensor:
    """VALID separable filter with the 1-D `taps` over the last three dims."""
    n = len(taps)
    for dim in (-3, -2, -1):
        size = x.shape[dim] - n + 1
        out = taps[0] * x.narrow(dim, 0, size)
        for i in range(1, n):
            out = out + taps[i] * x.narrow(dim, i, size)
        x = out
    return x


def ssim3d(pred: torch.Tensor, target: torch.Tensor, data_range: float = 1.0,
           win_size: int = 7, k1: float = 0.01, k2: float = 0.03,
           kernel: str = "uniform", kernel_sigma: float = 1.5,
           reduce: str = "mean") -> torch.Tensor:
    """Structural similarity of pred and target [B, C, D, H, W] (or
    [B, D, H, W]): a scalar for reduce "mean", per sample [B] for "none"."""
    if pred.dim() == 4:
        pred, target = pred[:, None], target[:, None]
    dtype = torch.promote_types(pred.dtype, torch.float32)
    pred, target = pred.to(dtype), target.to(dtype)
    if kernel == "uniform":
        taps = [1.0 / win_size] * win_size
    else:
        taps = [float(v) for v in _gaussian_kernel1d(win_size, kernel_sigma)]
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2

    mu_x = _sep_filter(pred, taps)
    mu_y = _sep_filter(target, taps)
    mu_xx = _sep_filter(pred * pred, taps)
    mu_yy = _sep_filter(target * target, taps)
    mu_xy = _sep_filter(pred * target, taps)

    var_x = mu_xx - mu_x * mu_x
    var_y = mu_yy - mu_y * mu_y
    cov_xy = mu_xy - mu_x * mu_y
    num = (2.0 * mu_x * mu_y + c1) * (2.0 * cov_xy + c2)
    den = (mu_x * mu_x + mu_y * mu_y + c1) * (var_x + var_y + c2)
    per_sample = (num / den).mean(dim=(1, 2, 3, 4))
    if reduce == "mean":
        return per_sample.mean()
    return per_sample
