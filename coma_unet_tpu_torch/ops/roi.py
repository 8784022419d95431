"""ROI label compaction, per-ROI sums, per-ROI painting and the ROI weight
mask (counterpart of `coma_unet_tpu/ops/roi.py:26-126`).

A raw ROI label volume is compacted once to ids in [0, R] through a lookup
table (0 = background); per-ROI scalars are painted back onto the volume
with one gather, which is exact, and per-ROI sums are one scatter-add.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

# FreeSurfer aparc+aseg labels go up to 2035 in the 36-ROI set; round the
# LUT up to a power of two.
LUT_SIZE = 4096


def make_roi_lut(roi_indices: Sequence[int],
                 lut_size: int = LUT_SIZE) -> torch.Tensor:
    """int32 LUT: `roi_indices[i]` -> i + 1, every other label -> 0."""
    lut = np.zeros((lut_size,), dtype=np.int32)
    for i, idx in enumerate(roi_indices):
        if not 0 <= idx < lut_size:
            raise ValueError(f"ROI label {idx} out of LUT range [0,{lut_size})")
        lut[idx] = i + 1
    return torch.from_numpy(lut)


def compact_roi(roi: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """Map a raw ROI label volume to compact ids in [0, R]."""
    idx = roi.to(torch.int64).clamp(0, lut.shape[0] - 1)
    return lut.to(roi.device)[idx]


# voxels per partial sum of `roi_reduce`: each ROI's sum is the sum of its
# partials, so no f32 accumulator takes more than this many additions
ROI_CHUNK = 4096


def roi_reduce(values: torch.Tensor, compact: torch.Tensor,
               num_rois: int) -> torch.Tensor:
    """Per-sample, per-ROI sums of `values` [B, ...] over the compact ids
    [B, ...] in [0, R]: [B, R + 1], column 0 the background; ids outside
    [0, R] count nowhere. Sums in f32 (f64 for f64 values): one scatter-add
    into per-chunk partials of ROI_CHUNK voxels, then a sum over the
    chunks, so that a sum over a whole 216^3 ROI keeps its precision."""
    b = values.shape[0]
    dtype = torch.promote_types(values.dtype, torch.float32)
    v = values.reshape(b, -1).to(dtype)
    ids = compact.reshape(b, -1).to(torch.int64)
    width = num_rois + 2   # ids 0..R and one column for the ids outside
    ids = torch.where((ids >= 0) & (ids <= num_rois), ids, num_rois + 1)
    chunk = torch.arange(v.shape[1], device=v.device) // ROI_CHUNK
    nchunk = -(-v.shape[1] // ROI_CHUNK)
    part = torch.zeros((b, nchunk * width), dtype=dtype, device=v.device)
    part.scatter_add_(1, ids + chunk * width, v)
    return part.reshape(b, nchunk, width).sum(dim=1)[:, :num_rois + 1]


def roi_sums(values: torch.Tensor, compact: torch.Tensor,
             num_rois: int) -> torch.Tensor:
    """Per-sample per-ROI sums over the foreground ROIs only: [B, R]."""
    return roi_reduce(values, compact, num_rois)[:, 1:]


def roi_counts(compact: torch.Tensor, num_rois: int) -> torch.Tensor:
    """Per-sample per-ROI voxel counts: [B, R] f32."""
    ones = torch.ones(compact.shape, dtype=torch.float32,
                      device=compact.device)
    return roi_sums(ones, compact, num_rois)


def paint_roi_values(compact: torch.Tensor, per_roi_values: torch.Tensor,
                     background: float = 0.0) -> torch.Tensor:
    """Paint per-ROI scalars `per_roi_values` [B, R] onto the compact id
    volume [B, ...]: id i in 1..R takes column i - 1, every other id takes
    `background`."""
    b, r = per_roi_values.shape
    table = torch.cat([per_roi_values.new_full((b, 1), background),
                       per_roi_values], dim=1)
    ids = compact.reshape(b, -1).to(torch.int64)
    ids = torch.where((ids >= 1) & (ids <= r), ids, 0)
    return table.gather(1, ids).reshape(compact.shape)


def roi_weight_mask(compact: torch.Tensor, roi_weights: torch.Tensor,
                    background: float = 1.0) -> torch.Tensor:
    """Weight volume (counterpart of `coma_unet_tpu/ops/roi.py:110-126`):
    `roi_weights[i - 1]` [R] where the compact id is i in 1..R, `background`
    everywhere else."""
    r = roi_weights.shape[-1]
    table = torch.cat([roi_weights.new_full((1,), background), roi_weights])
    ids = compact.to(torch.int64)
    return table[torch.where((ids >= 1) & (ids <= r), ids, 0)]
