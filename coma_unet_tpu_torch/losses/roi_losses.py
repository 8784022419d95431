"""ROI-weighted generative loss (counterpart of
`coma_unet_tpu/losses/roi_losses.py`: `roi_mse`, `make_voxel_weights`).

Volumes are [B, ...] (a channel dim of 1 included); `roi_compact` holds ids
in [0, R], 0 the background; `roi_weights` is [R].
"""

from __future__ import annotations

from typing import Optional

import torch

from coma_unet_tpu_torch.ops.roi import roi_weight_mask


def _spatial(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[0], -1)


def roi_mse(pred: torch.Tensor, gt: torch.Tensor, roi_compact: torch.Tensor,
            roi_weights: torch.Tensor,
            voxel_weights: Optional[torch.Tensor] = None,
            reduction: Optional[str] = "mean") -> torch.Tensor:
    """Per sample: mean over voxels of (pred - gt)^2, times the mean of the
    weight mask (0 background, w_i inside ROI i), or of `voxel_weights`
    when given. A scalar for reduction "mean", else per sample [B]."""
    se = (_spatial(pred) - _spatial(gt)).square().mean(dim=-1)
    if voxel_weights is not None:
        per_sample = se * voxel_weights.mean()
    else:
        mask = roi_weight_mask(roi_compact, roi_weights, background=0.0)
        per_sample = se * _spatial(mask).mean(dim=-1)
    return per_sample.mean() if reduction == "mean" else per_sample


def make_voxel_weights(template_compact: torch.Tensor,
                       roi_weights: torch.Tensor) -> torch.Tensor:
    """Voxel-wise weight grid from the template ROI ids: ones in the
    background, w_i in ROI i, L2-normalized, rescaled to a mean of 5."""
    w = roi_weight_mask(template_compact, roi_weights, background=1.0)
    w = w / torch.linalg.vector_norm(w.reshape(-1))
    return (5.0 / w.mean()) * w
