"""Per-sample, per-ROI evaluation metrics (counterpart of
`coma_unet_tpu/metrics/roi.py`): every quantity falls out of per-ROI sums
(`ops.roi.roi_sums`).
"""

from __future__ import annotations

from typing import Dict

import torch

from coma_unet_tpu_torch.ops.roi import roi_sums


def roi_metrics(pred: torch.Tensor, gt: torch.Tensor,
                roi_compact: torch.Tensor, num_rois: int,
                eps: float = 1e-8) -> Dict[str, torch.Tensor]:
    """All values [B, R], in f32 (f64 for f64 inputs). pred, gt
    [B, C, D, H, W] or [B, D, H, W]; roi_compact [B, D, H, W] ids in
    [0, R]. Keys: mae, mape_num (sum of |rel err| over the valid voxels),
    mape_cnt, wrrmse, rse, pred_mean, gt_mean and count."""
    if pred.dim() == 5:
        pred, gt = pred[:, 0], gt[:, 0]
    dtype = torch.promote_types(pred.dtype, torch.float32)
    pred, gt = pred.to(dtype), gt.to(dtype)
    diff = pred - gt

    def sums(v):
        return roi_sums(v, roi_compact, num_rois)

    count = sums(torch.ones_like(gt))
    safe_count = torch.clamp(count, min=1.0)
    mae = sums(diff.abs()) / safe_count

    valid = gt.abs() > eps
    rel = torch.where(valid, (diff / torch.where(valid, gt, 1.0)).abs(), 0.0)
    mape_num = sums(rel)
    mape_cnt = sums(valid.to(dtype))

    sq_sum = sums(diff.square())
    gt_sq_sum = sums(gt.square())
    wrrmse = torch.sqrt(sq_sum / torch.clamp(gt_sq_sum, min=eps))

    gt_mean = sums(gt) / safe_count
    # sum (gt - mean)^2 over the ROI = sum gt^2 - count * mean^2
    den = gt_sq_sum - count * gt_mean.square()
    rse = sq_sum / torch.clamp(den, min=eps)
    pred_mean = sums(pred) / safe_count
    return {"mae": mae, "mape_num": mape_num, "mape_cnt": mape_cnt,
            "wrrmse": wrrmse, "rse": rse, "pred_mean": pred_mean,
            "gt_mean": gt_mean, "count": count}
