"""Column-weighted vector regression losses for the ROI-SUVR-vector side
experiments (counterpart of `coma_unet_tpu/losses/weighted.py`): pred and
target [N, C], weights [C]."""

from __future__ import annotations

import torch


def weighted_mse(pred: torch.Tensor, target: torch.Tensor,
                 weights: torch.Tensor) -> torch.Tensor:
    """`WeightedMSE`: mean of w_c (pred - target)^2."""
    return torch.mean(torch.square(pred - target) * weights[None, :])


def weighted_l1(pred: torch.Tensor, target: torch.Tensor,
                weights: torch.Tensor) -> torch.Tensor:
    """`WeightedLoss`: mean over columns of w_c * sum_n |pred - target|."""
    per_col = torch.sum(torch.abs(pred - target), dim=0)
    return torch.sum(weights * per_col) / weights.shape[0]


def _pearson(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    vx, vy = x - x.mean(), y - y.mean()
    return torch.sum(vx * vy) / (torch.clamp(torch.linalg.norm(vx), min=1e-12)
                                 * torch.clamp(torch.linalg.norm(vy), min=1e-12))


def weighted_cc(pred: torch.Tensor, target: torch.Tensor,
                weights: torch.Tensor) -> torch.Tensor:
    """`WeightedCC`: sum over columns of w_c (1 - pearson). The original
    overwrites its accumulator each column, so only the last column counts;
    this sums them, as the JAX package does (its documented deviation)."""
    total = pred.new_zeros(())
    for c in range(pred.shape[1]):
        total = total + weights[c] * (1.0 - _pearson(pred[:, c], target[:, c]))
    return total


def weighted_cccl(pred: torch.Tensor, target: torch.Tensor,
                  weights: torch.Tensor) -> torch.Tensor:
    """`WeightedCCCL`: the concordance correlation coefficient loss, sum
    over columns of w_c (1 - ccc); a NaN column contributes w_c."""
    total = pred.new_zeros(())
    for c in range(pred.shape[1]):
        x, y = pred[:, c], target[:, c]
        r = _pearson(x, y)
        sx, sy = x.std(correction=0), y.std(correction=0)
        ccc = (2.0 * r * sx * sy) / (x.var(correction=0) + y.var(correction=0)
                                     + torch.square(x.mean() - y.mean()))
        total = total + weights[c] * (1.0 - torch.nan_to_num(ccc, nan=0.0))
    return total
