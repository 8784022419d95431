"""The 1-D Gaussian kernel of MONAI's `GaussianSmooth` (counterpart of
`coma_unet_tpu/ops/smooth.py:gaussian_kernel1d`), which the data pipeline's
`smoothing` option convolves along each axis on the host.

The default "erf" approximation integrates the Gaussian over [x-0.5, x+0.5]
at each integer tap x, truncated at `truncated` sigmas and normalized.
"""

from __future__ import annotations

import math

import numpy as np


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
