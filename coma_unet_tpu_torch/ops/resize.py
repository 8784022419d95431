"""Spacing-based volume resampling (counterpart of
`coma_unet_tpu/ops/resize.py`): nearest-neighbour and trilinear on the
host in numpy, and nearest-neighbour on a tensor's device for a fixed
output shape, index for index the host's.

SimpleITK's resample-to-2mm semantics: the output size is
``round(size * spacing / new_spacing)`` per axis (numpy's round), identity
transform, same origin and direction. ITK's nearest-neighbour interpolator
maps output index ``i`` to the continuous input index
``i * new_spacing / spacing`` and rounds half up; out-of-range samples take
`fill_value` (0, where the original pipeline used the pixel type's enum).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch


def output_size(size: Sequence[int], spacing: Sequence[float],
                new_spacing: Sequence[float]) -> Tuple[int, ...]:
    """``int(round(n * s / s'))`` per axis, numpy's (banker's) rounding."""
    return tuple(int(np.round(n * (s / ns)))
                 for n, s, ns in zip(size, spacing, new_spacing))


def resize_nearest(vol: np.ndarray, spacing: Sequence[float],
                   new_spacing: Sequence[float] = (2.0, 2.0, 2.0),
                   fill_value: float = 0.0) -> np.ndarray:
    """Nearest-neighbour resample of a [D, H, W] array whose axes are in
    the order of `spacing`."""
    out_shape = output_size(vol.shape, spacing, new_spacing)
    gathered = vol
    for axis in range(3):
        ratio = new_spacing[axis] / spacing[axis]
        idx = np.floor(np.arange(out_shape[axis]) * ratio + 0.5).astype(np.int64)
        in_range = (idx >= 0) & (idx < vol.shape[axis])
        gathered = np.take(gathered, np.clip(idx, 0, vol.shape[axis] - 1),
                           axis=axis)
        if not in_range.all():
            sl = [slice(None)] * 3
            sl[axis] = ~in_range
            gathered[tuple(sl)] = fill_value
    return gathered


def resize_linear(vol: np.ndarray, spacing: Sequence[float],
                  new_spacing: Sequence[float] = (2.0, 2.0, 2.0)) -> np.ndarray:
    """Trilinear resample, separable per axis."""
    out = vol.astype(np.float32)
    for axis in range(3):
        ratio = new_spacing[axis] / spacing[axis]
        n_out = int(np.round(vol.shape[axis] * (spacing[axis] / new_spacing[axis])))
        pos = np.arange(n_out) * ratio
        lo = np.floor(pos).astype(np.int64)
        frac = (pos - lo).astype(np.float32)
        lo = np.clip(lo, 0, out.shape[axis] - 1)
        hi = np.clip(lo + 1, 0, out.shape[axis] - 1)
        shape = [1, 1, 1]
        shape[axis] = n_out
        w = frac.reshape(shape)
        out = (np.take(out, lo, axis=axis) * (1.0 - w)
               + np.take(out, hi, axis=axis) * w)
    return out


def resize_nearest_device(vol: torch.Tensor, ratios,
                          out_shape: Tuple[int, int, int]) -> torch.Tensor:
    """Nearest-neighbour resample of a [D, H, W] tensor to `out_shape` on
    its device; `ratios` = new_spacing / spacing per axis. Output index i
    reads input index floor(i * ratio + 0.5), both steps in float32,
    clamped into the volume."""
    ratios = torch.as_tensor(ratios, dtype=torch.float32, device=vol.device)
    out = vol
    for axis in range(3):
        pos = torch.arange(out_shape[axis], dtype=torch.float32,
                           device=vol.device) * ratios[axis]
        idx = torch.clamp(torch.floor(pos + 0.5).long(), 0, vol.shape[axis] - 1)
        out = torch.index_select(out, axis, idx)
    return out
