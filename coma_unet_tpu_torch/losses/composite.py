"""The composite training loss (counterpart of
`coma_unet_tpu/losses/composite.py`):

    L = gen_weight * sum_b L_gen[b] + reg_weight * L_predspace
        + ds_reg_weight * (RnC or tCDS)

with L_gen the per-sample RoiMSE, the pred-space triplet term only when
`reg_weight != 0`, and Rank-N-Contrast in the tCDS slot when `rnc`.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence, Tuple

import torch

from coma_unet_tpu_torch.config import LossConfig
from coma_unet_tpu_torch.losses.contrastive import (
    rnc_loss,
    triplet_loss,
    truncated_cds,
)
from coma_unet_tpu_torch.losses.roi_losses import roi_mse


@dataclass
class LossOutputs:
    total: torch.Tensor
    gen: torch.Tensor          # per sample [B]
    pred_space: torch.Tensor   # reg_weight applied
    tcds: torch.Tensor         # ds_reg_weight applied


@dataclass(frozen=True)
class GenerativeContrastiveLoss:
    config: LossConfig = field(default_factory=LossConfig)

    def __call__(
        self, pred: torch.Tensor, target: torch.Tensor,
        roi_compact: torch.Tensor, roi_weights: torch.Tensor, *,
        rnc_features: Optional[torch.Tensor] = None,
        rnc_labels: Optional[torch.Tensor] = None,
        anchor_projs: Optional[Sequence[torch.Tensor]] = None,
        pos_projs: Optional[Sequence[torch.Tensor]] = None,
        neg_projs: Optional[Sequence[torch.Tensor]] = None,
        final_reprs: Optional[Tuple[torch.Tensor, torch.Tensor,
                                    torch.Tensor]] = None,
        voxel_weights: Optional[torch.Tensor] = None,
        valid: Optional[torch.Tensor] = None,
    ) -> LossOutputs:
        """`valid` ([B] 0/1) excludes wrap-padded rows from every term."""
        cfg = self.config
        gen = roi_mse(pred, target, roi_compact, roi_weights,
                      voxel_weights=voxel_weights, reduction=None)
        vsum = gen if valid is None else gen * valid.reshape(-1).to(gen.dtype)
        total = cfg.gen_weight * vsum.sum()
        zero = torch.zeros((), dtype=torch.float32, device=pred.device)
        pred_space = zero
        if cfg.reg_weight != 0.0 and final_reprs is not None:
            a, p, n = final_reprs
            pred_space = cfg.reg_weight * triplet_loss(
                a, p, n, margin=cfg.triplet_margin, valid=valid)
        if cfg.rnc:
            if rnc_features is None or rnc_labels is None:
                raise ValueError("rnc=True requires rnc_features and rnc_labels")
            tcds = cfg.ds_reg_weight * rnc_loss(
                rnc_features, rnc_labels, temperature=cfg.rnc_temperature,
                valid=valid)
        else:
            if anchor_projs is None:
                raise ValueError("rnc=False requires per-level projections")
            tcds = cfg.ds_reg_weight * truncated_cds(
                anchor_projs, pos_projs, neg_projs, cfg.cds_weights,
                margin=cfg.triplet_margin, valid=valid)
        return LossOutputs(total=total + pred_space + tcds, gen=gen,
                           pred_space=pred_space, tcds=tcds)
