"""Per-sample voxel-level evaluation metrics (counterpart of
`coma_unet_tpu/metrics/voxel.py`): MAE, MAPE (numerator and valid-voxel
count), RSE, RRMSE, PSNR and SSIM, as true per-sample values; the host
accumulator (`metrics/aggregate.py`) averages them per sample.
"""

from __future__ import annotations

from typing import Dict

import torch

from coma_unet_tpu_torch.ops.ssim import ssim3d


def voxel_metrics(pred: torch.Tensor, gt: torch.Tensor,
                  with_ssim: bool = True, data_range: float = 1.0,
                  eps: float = 1e-8) -> Dict[str, torch.Tensor]:
    """pred, gt [B, C, D, H, W] (or [B, D, H, W]), computed in f32 (f64 for
    f64 inputs). Keys: mae, mape_num (sum of 100 |rel err| over the voxels
    where |gt| > eps), mape_cnt (their count), rse, rrmse, psnr, ssim (each
    [B]) and abs_rel_vol (|rel err| per voxel, gt's shape)."""
    if pred.dim() == 4:
        pred, gt = pred[:, None], gt[:, None]
    dtype = torch.promote_types(pred.dtype, torch.float32)
    pred, gt = pred.to(dtype), gt.to(dtype)
    b = pred.shape[0]
    diff = pred - gt
    flat_diff = diff.reshape(b, -1)
    flat_gt = gt.reshape(b, -1)

    mae = flat_diff.abs().mean(dim=-1)
    valid = flat_gt.abs() > eps
    rel = torch.where(valid, (flat_diff / torch.where(valid, flat_gt, 1.0)).abs(),
                      0.0)
    mape_num = (rel * 100.0).sum(dim=-1)
    mape_cnt = valid.to(dtype).sum(dim=-1)

    sq = flat_diff.square().sum(dim=-1)
    gt_mean = flat_gt.mean(dim=-1, keepdim=True)
    rse = sq / (flat_gt - gt_mean).square().sum(dim=-1)
    rrmse = torch.sqrt(sq / flat_gt.square().sum(dim=-1))
    mse = flat_diff.square().mean(dim=-1)
    psnr = 10.0 * torch.log10(data_range ** 2 / torch.clamp(mse, min=1e-12))

    out = {"mae": mae, "mape_num": mape_num, "mape_cnt": mape_cnt,
           "rse": rse, "rrmse": rrmse, "psnr": psnr,
           "abs_rel_vol": rel.reshape(gt.shape)}
    if with_ssim:
        out["ssim"] = ssim3d(pred, gt, data_range=data_range, reduce="none")
    return out
