"""ROI-weighted generative losses and the adaptive weights (counterpart
of `coma_unet_tpu/losses/roi_losses.py`).

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


def roi_rse(pred: torch.Tensor, gt: torch.Tensor, roi_compact: torch.Tensor,
            roi_weights: torch.Tensor, reduction: str = "mean") -> torch.Tensor:
    """Weighted relative squared error: the sum of mask * (gt - pred)^2 over
    the sum of (gt - mean(mask * gt))^2, the mask ones in the background
    and w_i inside ROI i; the mean (or sum) over samples."""
    mask = _spatial(roi_weight_mask(roi_compact, roi_weights, background=1.0))
    p, g = _spatial(pred), _spatial(gt)
    gt_mean = (mask * g).mean(dim=-1, keepdim=True)
    num = (mask * (g - p).square()).sum(dim=-1)
    den = (g - gt_mean).square().sum(dim=-1)
    wrse = num / den
    return wrse.mean() if reduction == "mean" else wrse.sum()


def roi_rrmse(pred: torch.Tensor, gt: torch.Tensor, roi_compact: torch.Tensor,
              roi_weights: torch.Tensor, reduction: str = "mean") -> torch.Tensor:
    """sqrt(sum mask * (gt - pred)^2 / sum mask * gt^2), the mask as in
    `roi_rse`; the mean (or sum) over samples."""
    mask = _spatial(roi_weight_mask(roi_compact, roi_weights, background=1.0))
    p, g = _spatial(pred), _spatial(gt)
    num = (mask * (g - p).square()).sum(dim=-1)
    den = (mask * g.square()).sum(dim=-1)
    wrrmse = torch.sqrt(num / den)
    return wrrmse.mean() if reduction == "mean" else wrrmse.sum()


def update_roi_weights(roi_weights: torch.Tensor, errors: torch.Tensor,
                       scale_factor: float = 360.0) -> torch.Tensor:
    """Adaptive per-ROI weights from the validation errors (per-ROI MAPE
    fractions): w * 0.5 * e, rescaled to an L2 norm of `scale_factor`."""
    new = roi_weights * 0.5 * errors
    return scale_factor * new / torch.linalg.vector_norm(new)


def update_voxel_weights(voxel_weights: torch.Tensor,
                         errors: torch.Tensor) -> torch.Tensor:
    """Adaptive voxel weights from the validation error grid: w * (1 + e),
    L2-normalized, then rescaled to the old grid's mean."""
    new = voxel_weights * (1.0 + errors)
    new = new / torch.linalg.vector_norm(new.reshape(-1))
    return new * (voxel_weights.mean() / new.mean())
