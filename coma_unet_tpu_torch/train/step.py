"""The train and eval steps (counterpart of `coma_unet_tpu/train/step.py:
make_train_step`, `make_eval_step`): forward, composite loss, backward
through the kernels' autograd Functions, AdamW update; and the inference
forward with the voxel and ROI metric suite.

Both steps follow the model's device: batches are dicts of tensors or
arrays, moved to the model's device, NCDHW:

    mri, tau     [B, 1, D, H, W]  float
    roi_compact  [B, D, H, W]     int ids in [0, R]
    covars       [B, K]           float ([abeta, age, sex, edu, cog, meta])
    roi_loc      [B, R], roi_std [B, R]
    valid_mask   [B] 0/1          optional: wrap-padded rows are 0
    pos_*/neg_*  mirrors of mri/covars/roi_loc/roi_std/roi_compact for the
                 tCDS triplet path (loss.rnc == False)

A model without projection heads (the registry's baselines) trains on the
generative loss alone, as the JAX package's step does: gen_weight times the
sum over the valid rows of the per-sample RoiMSE, with pred_space_loss and
tcds_loss 0. Batch norm's running statistics move in the train step and
stay as they are in the eval step; dropout draws from generators seeded
with (seed, step) each step (`seed_dropout`).

A train step records its phases as spans (`utils.profiling.span`):
`train.step` around the whole step, and inside it `train.forward` around
each forward (three on the tCDS path), `train.loss` around the generative
and the batch-coupled terms, `train.backward`, `train.grad_norm` and
`train.optimizer`.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from coma_unet_tpu_torch.config import LossConfig
from coma_unet_tpu_torch.losses.composite import GenerativeContrastiveLoss
from coma_unet_tpu_torch.metrics.roi import roi_metrics
from coma_unet_tpu_torch.metrics.voxel import voxel_metrics
from coma_unet_tpu_torch.models.blocks import Dropout, seed_dropout
from coma_unet_tpu_torch.models.registry import MODEL_INPUTS, apply_model
from coma_unet_tpu_torch.train.state import TrainState
from coma_unet_tpu_torch.utils.profiling import span


def _device_of(model: torch.nn.Module) -> Optional[torch.device]:
    """The device of the model's parameters (None for a model without)."""
    param = next(model.parameters(), None)
    return None if param is None else param.device


def _to_device(batch, device: Optional[torch.device]) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def _apply(model, batch: Dict[str, torch.Tensor], prefix: str = "",
           with_projections: bool = True):
    return apply_model(model, *(batch.get(prefix + k) for k in MODEL_INPUTS),
                       with_projections=with_projections)


def make_loss_fn(model: torch.nn.Module, loss_config: LossConfig,
                 gather: Optional[Callable] = None, world: int = 1) -> Callable:
    """loss_fn(batch, roi_weights, voxel_weights=None) -> (total, metrics):
    the JAX package's `loss_fn`. Every term carries `valid_mask`; metrics
    hold loss, per-sample gen_loss, pred_space_loss and tcds_loss. A
    data-parallel step (`parallel/mesh.py`) passes `gather`, which
    all-gathers a tensor's rows over its `world` ranks differentiably: the
    batch-coupled terms are then taken over every rank's rows and divided by
    `world`, so that summed over the ranks they count once."""
    criterion = GenerativeContrastiveLoss(loss_config)
    gather = gather or (lambda x: x)

    def loss_fn(batch, roi_weights, voxel_weights=None):
        valid = batch.get("valid_mask")
        with span("train.forward"):
            outs = _apply(model, batch)
        with span("train.loss"):
            gen, total = criterion.generative(
                outs.out, batch["tau"], batch["roi_compact"], roi_weights,
                voxel_weights=voxel_weights, valid=valid)
        pred_space = tcds = torch.zeros((), dtype=torch.float32,
                                        device=total.device)
        if outs.projections:  # the baselines train on the generative term
            if loss_config.rnc:
                kwargs = dict(rnc_features=gather(outs.projections[-1]),
                              rnc_labels=gather(batch["covars"]))
            else:
                with span("train.forward"):
                    pos = _apply(model, batch, "pos_")
                with span("train.forward"):
                    neg = _apply(model, batch, "neg_")
                kwargs = dict(
                    anchor_projs=[gather(p) for p in outs.projections],
                    pos_projs=[gather(p) for p in pos.projections],
                    neg_projs=[gather(p) for p in neg.projections],
                    final_reprs=(tuple(gather(o.final_projection)
                                       for o in (outs, pos, neg))
                                 if loss_config.reg_weight != 0.0 else None))
            with span("train.loss"):
                pred_space, tcds = criterion.coupled(
                    valid=None if valid is None else gather(valid), **kwargs)
            pred_space, tcds = pred_space / world, tcds / world
            total = total + pred_space + tcds
        return total, {"loss": total.detach(), "gen_loss": gen.detach(),
                       "pred_space_loss": pred_space.detach(),
                       "tcds_loss": tcds.detach()}

    return loss_fn


def global_norm(tensors) -> torch.Tensor:
    """L2 norm over all tensors (optax `global_norm`), in f32."""
    return torch.sqrt(sum(t.float().square().sum() for t in tensors))


def make_train_step(model: torch.nn.Module, loss_config: LossConfig,
                    optimizer: torch.optim.Optimizer,
                    seed: int = 0) -> Callable:
    """step(batch, roi_weights, voxel_weights=None) -> metrics: one forward
    and backward in `.train()` mode, then one optimizer step. The gradients
    stay in the parameters' `.grad` until the next step; `grad_norm` is
    their global L2 norm. Dropout sites are seeded from (`seed`, the
    state's step count) before each forward."""
    return _step_of(model, optimizer, seed, make_loss_fn(model, loss_config))


def _step_of(model: torch.nn.Module, optimizer, seed: int, loss_fn: Callable,
             reduce: Optional[Callable] = None) -> Callable:
    """The train step around `loss_fn`; `reduce(grads, batch, metrics)`,
    when given, runs between the backward and the update (a data-parallel
    step sums the gradients there) and returns the metrics."""
    params = [p for p in model.parameters() if p.requires_grad]
    device = _device_of(model)
    state = TrainState(model, optimizer)
    dropout = any(isinstance(m, Dropout) for m in model.modules())

    def step(batch: Dict[str, torch.Tensor], roi_weights: torch.Tensor,
             voxel_weights: Optional[torch.Tensor] = None):
        with span("train.step"):
            model.train()
            if dropout:
                seed_dropout(model, seed, state.step)
            optimizer.zero_grad(set_to_none=True)
            batch = _to_device(batch, device)
            roi_weights = torch.as_tensor(roi_weights, device=device)
            if voxel_weights is not None:
                voxel_weights = torch.as_tensor(voxel_weights, device=device)
            total, metrics = loss_fn(batch, roi_weights, voxel_weights)
            with span("train.backward"):
                total.backward()
            grads = [p.grad for p in params if p.grad is not None]
            if reduce is not None:
                metrics = reduce(grads, batch, metrics)
            with span("train.grad_norm"):
                metrics["grad_norm"] = global_norm(grads)
            with span("train.optimizer"):
                optimizer.step()
            return metrics

    return step


def make_eval_step(model: torch.nn.Module, num_rois: int) -> Callable:
    """eval_step(batch) -> (pred, vox, roi): the inference forward in
    `.eval()` mode under `torch.inference_mode()`, then `voxel_metrics`
    and `roi_metrics` of `pred` against `batch["tau"]` over the compact ROI
    ids 1..num_rois, all on the model's device (the device half of the
    reference's `contrastive_test`)."""
    device = _device_of(model)

    @torch.inference_mode()
    def eval_step(batch):
        model.eval()
        batch = _to_device(batch, device)
        pred = _apply(model, batch, with_projections=False).out
        vox = voxel_metrics(pred, batch["tau"])
        roi = roi_metrics(pred, batch["tau"], batch["roi_compact"], num_rois)
        return pred, vox, roi

    return eval_step
