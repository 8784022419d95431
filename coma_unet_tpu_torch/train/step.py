"""The train step (counterpart of `coma_unet_tpu/train/step.py:
make_train_step`): forward, composite loss, backward through the kernels'
autograd Functions, AdamW update.

Batches are dicts of tensors on the model's device, NCDHW:

    mri, tau     [B, 1, D, H, W]  float
    roi_compact  [B, D, H, W]     int ids in [0, R]
    covars       [B, K]           float ([abeta, age, sex, edu, cog, meta])
    roi_loc      [B, R], roi_std [B, R]
    valid_mask   [B] 0/1          optional: wrap-padded rows are 0
    pos_*/neg_*  mirrors of mri/covars/roi_loc/roi_std/roi_compact for the
                 tCDS triplet path (loss.rnc == False)
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from coma_unet_tpu_torch.config import LossConfig
from coma_unet_tpu_torch.losses.composite import GenerativeContrastiveLoss

_INPUTS = ("mri", "covars", "roi_loc", "roi_std", "roi_compact")


def _apply(model, batch: Dict[str, torch.Tensor], prefix: str = ""):
    outs = model(*(batch.get(prefix + k) for k in _INPUTS),
                 with_projections=True)
    if not getattr(outs, "projections", ()):
        raise NotImplementedError(
            "models without projection heads (the baselines) are not "
            "ported yet")
    return outs


def make_loss_fn(model: torch.nn.Module,
                 loss_config: LossConfig) -> Callable:
    """loss_fn(batch, roi_weights, voxel_weights=None) -> (total, metrics):
    the JAX package's `loss_fn`. Every term carries `valid_mask`; metrics
    hold loss, per-sample gen_loss, pred_space_loss and tcds_loss."""
    criterion = GenerativeContrastiveLoss(loss_config)

    def loss_fn(batch, roi_weights, voxel_weights=None):
        valid = batch.get("valid_mask")
        outs = _apply(model, batch)
        kwargs = dict(voxel_weights=voxel_weights, valid=valid)
        if loss_config.rnc:
            kwargs.update(rnc_features=outs.projections[-1],
                          rnc_labels=batch["covars"])
        else:
            pos, neg = _apply(model, batch, "pos_"), _apply(model, batch, "neg_")
            kwargs.update(anchor_projs=outs.projections,
                          pos_projs=pos.projections, neg_projs=neg.projections,
                          final_reprs=(outs.final_projection,
                                       pos.final_projection,
                                       neg.final_projection))
        losses = criterion(outs.out, batch["tau"], batch["roi_compact"],
                           roi_weights, **kwargs)
        return losses.total, {"loss": losses.total.detach(),
                              "gen_loss": losses.gen.detach(),
                              "pred_space_loss": losses.pred_space.detach(),
                              "tcds_loss": losses.tcds.detach()}

    return loss_fn


def global_norm(tensors) -> torch.Tensor:
    """L2 norm over all tensors (optax `global_norm`), in f32."""
    return torch.sqrt(sum(t.float().square().sum() for t in tensors))


def make_train_step(model: torch.nn.Module, loss_config: LossConfig,
                    optimizer: torch.optim.Optimizer) -> Callable:
    """step(batch, roi_weights, voxel_weights=None) -> metrics: one forward
    and backward in `.train()` mode, then one optimizer step. The gradients
    stay in the parameters' `.grad` until the next step; `grad_norm` is
    their global L2 norm."""
    loss_fn = make_loss_fn(model, loss_config)
    params = [p for p in model.parameters() if p.requires_grad]

    def step(batch: Dict[str, torch.Tensor], roi_weights: torch.Tensor,
             voxel_weights: Optional[torch.Tensor] = None):
        model.train()
        optimizer.zero_grad(set_to_none=True)
        total, metrics = loss_fn(batch, roi_weights, voxel_weights)
        total.backward()
        metrics["grad_norm"] = global_norm(
            p.grad for p in params if p.grad is not None)
        optimizer.step()
        return metrics

    return step
