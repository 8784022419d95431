"""Host-side spatial preprocessing (counterpart of
`coma_unet_tpu/ops/preprocess.py`, in numpy).

`center_pad_crop` center-pads each spatial dim with zeros up to the target,
and center-crops any dim that overshoots it symmetrically.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import numpy as np


def _pad_crop_amounts(n: int, target: int
                      ) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """Returns ((pad_lo, pad_hi), (crop_lo, crop_hi))."""
    if n < target:
        lo = (target - n) // 2
        return (lo, target - n - lo), (0, n)
    lo = (n - target) // 2
    return (0, 0), (lo, lo + target)


def center_pad_crop(vol: np.ndarray,
                    target: Union[int, Sequence[int]] = (128, 128, 128),
                    fill_value: float = 0.0) -> np.ndarray:
    """Center pad (and crop, if larger) the trailing 3 dims of a
    [..., D, H, W] array to `target`."""
    if isinstance(target, int):
        target = (target,) * 3
    pads, crops = zip(*[_pad_crop_amounts(n, t)
                        for n, t in zip(vol.shape[-3:], target)])
    vol = vol[(Ellipsis,) + tuple(slice(lo, hi) for lo, hi in crops)]
    if any(lo or hi for lo, hi in pads):
        vol = np.pad(vol, [(0, 0)] * (vol.ndim - 3) + list(pads),
                     mode="constant", constant_values=fill_value)
    return vol
