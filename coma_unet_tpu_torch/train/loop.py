"""The training loop and the evaluation pass (counterpart of
`coma_unet_tpu/train/loop.py:evaluate`, `train`).

The reference's cadence: epochs of the train step over a shuffled loader;
the epoch-average loss drives the plateau controller; full validation every
`val_iter` epochs with the overall / Abeta+ / Abeta- CSVs, the ROI-mean
matrices, two pred/gt NIfTI samples and the charts; ROI (or voxel) weights
adapted from the validation MAPE; `checkpoint_latest_epoch` every epoch and
`checkpoint_epoch_{E}` every `checkpoint_iter`; in-sample validation every
`overfit_val_iter` epochs after epoch 29; the best MAPE and the best average
ROI correlation tracked. A step's loss is read on the host only after the
next step is enqueued, so the host does not drain the device every step.

Batches come from the loader as numpy; on a GPU the producer thread pins
them and the loop copies them to the card asynchronously, the pos_*/neg_*
partners of a tCDS batch (`loss.rnc` false) with the anchors. Three things
differ from the JAX package, so that a resumed run continues as an
uninterrupted one would: the checkpoint also holds the adapted ROI (voxel)
weights, it is written after the epoch's validation, which adapts them, and
a resumed run's loader shuffles each epoch as the uninterrupted run did.
The model is any of the registry's (`models/registry.py`); its state
dict, batch norm's running statistics included, is what a checkpoint
keeps of it.

Under a data-parallel `mesh` (`parallel/mesh.py`) every rank runs the loop
on its rows of each global batch (the loaders are built with its `shard`):
the step and the validation are the sharded ones, whose metrics are global,
so every rank books the same losses and every rank's plateau controller
and adaptive weights decide alike (checked each epoch by one all-reduce);
only rank 0 writes checkpoints, CSVs, charts, samples and `LAST_RUN`.
`train.spatial_parallel` S keeps the reference's meaning: its training mesh
has S devices to each data-parallel shard, but its sharded step maps every
batch entry over the `data` axis alone (`coma_unet_tpu/parallel/mesh.py:88-90`,
`shard_map` with `P("data")` specs and a `psum` over `data`), so the
spatial axis only replicates each shard's work; the loop runs on the D
ranks of `data_parallel` and computes what the run without S computes. It
refuses D x S beyond the visible cards, as the reference's `make_mesh`
does. The JAX package's split step and AOT precompile are TPU paths and
are not here.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from coma_unet_tpu_torch.config import ExperimentConfig, ROI_INDICES
from coma_unet_tpu_torch.data.pipeline import (
    HOST_KEYS,
    batch_to_device,
    compact_roi_np,
    pin_batch,
)
from coma_unet_tpu_torch.io.volume import load_template, write_tensor_to_nii
from coma_unet_tpu_torch.losses.roi_losses import (
    make_voxel_weights,
    update_roi_weights,
    update_voxel_weights,
)
from coma_unet_tpu_torch.metrics.aggregate import MetricAccumulator, MetricResults
from coma_unet_tpu_torch.train.checkpoint import CheckpointManager, restore_payload
from coma_unet_tpu_torch.train.optim import ReduceLROnPlateau, get_lr, set_lr
from coma_unet_tpu_torch.train.recorder import MetricRecorder, loss_graph
from coma_unet_tpu_torch.train.state import TrainState, create_train_state
from coma_unet_tpu_torch.train.step import make_eval_step, make_train_step

log = logging.getLogger(__name__)

# What the last call of `train` saw: the checkpoint restore's seconds, and
# per epoch the average and per-step losses and, on the host clock, the
# loader wait, the step time, each step's time, the validation and the
# checkpoint saves. Read by the smoke run; each call of `train` starts it
# anew.
LAST_RUN: Dict[str, Any] = {}


def require_device(device=None) -> torch.device:
    """`device`, the GPU when None; without a card, asking for it raises
    and names the way to the CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port trains, validates and synthesizes on "
            "the GPU unless asked otherwise; pass device=\"cpu\" (the CLI's "
            "--device cpu) to run on the CPU")
    return device


def _model_device(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


def _write_samples(pred: torch.Tensor, batch, save_path: str, saved: int,
                   limit: int) -> int:
    """Write the batch's valid (pred, gt) pairs as NIfTI into `save_path`
    (none where it is empty) until `limit` are counted; returns the count so
    far."""
    p = pred.float().cpu().numpy()
    t = np.asarray(batch["tau"])
    valid = batch.get("valid")
    vmask = (np.ones(p.shape[0], bool) if valid is None
             else np.asarray(valid).reshape(-1).astype(bool))
    ids = batch.get("sample_ids") or [f"sample{saved + j}" for j in range(p.shape[0])]
    for j in range(p.shape[0]):
        if saved >= limit:
            break
        if vmask[j]:
            if save_path:
                sid = str(ids[j]).replace("/", "_")
                write_tensor_to_nii(p[j], os.path.join(save_path, f"{sid}_pred.nii"))
                write_tensor_to_nii(t[j], os.path.join(save_path, f"{sid}_gt.nii"))
            saved += 1
    return saved


def _gather_host(batch, mesh, with_tau: bool):
    """The global batch's host entries (abeta, valid, sample_ids and, with
    `with_tau`, tau) from every rank's rows, in rank order."""
    from coma_unet_tpu_torch.parallel.mesh import gather_objects

    b = len(np.asarray(batch["abeta"]).reshape(-1))
    mine = {"abeta": np.asarray(batch["abeta"]).reshape(-1),
            "valid": (np.ones(b, bool) if batch.get("valid") is None
                      else np.asarray(batch["valid"]).reshape(-1))}
    if batch.get("sample_ids") is not None:
        mine["sample_ids"] = list(batch["sample_ids"])
    if with_tau:
        mine["tau"] = np.asarray(batch["tau"])
    parts = gather_objects(mine, mesh)
    return {k: (sum((p[k] for p in parts), []) if k == "sample_ids"
                else np.concatenate([p[k] for p in parts])) for k in mine}


def evaluate(eval_step, loader, num_rois: int, save_path: str = "",
             save_matrices: bool = True, save_samples: int = 0,
             device: Optional[torch.device] = None, mesh=None
             ) -> Tuple[MetricResults, MetricResults, MetricResults,
                        Optional[np.ndarray]]:
    """Run `eval_step` over the loader and accumulate the overall, Abeta+
    and Abeta- metrics and the per-ROI Pearson r. `save_samples` > 0 writes
    the first N valid (pred, gt) pairs as NIfTI into `save_path`; the
    wrap-padded rows count nowhere. Returns the three results and the voxel
    MAPE grid. Under a data-parallel `mesh` the loader yields this rank's
    rows and `eval_step` is the sharded one: every rank accumulates the
    whole batch, and only rank 0 writes."""
    if mesh is not None and mesh.rank != 0:
        save_path = ""
    acc = MetricAccumulator(num_rois)
    saved = 0
    # cuDNN runs deterministically here, so that a checkpoint validates to
    # the numbers its run recorded: the transposed convs of levels 2-4 run
    # on cuDNN's backward-data algorithms, some of which add with atomics,
    # and the bf16 roundings they flip moved a per-ROI MAPE of the
    # synthetic 128^3 cohort by 1.2e-3 on an NVIDIA H100
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        with torch.inference_mode():
            for batch in loader:
                db = (batch_to_device(batch, device) if device is not None
                      else {k: v for k, v in batch.items() if k not in HOST_KEYS})
                pred, vox, roi = eval_step(db)
                if mesh is not None:
                    batch = _gather_host(batch, mesh, saved < save_samples)
                acc.update(vox, roi, batch["abeta"], batch.get("sample_ids"),
                           valid=batch.get("valid"))
                if saved < save_samples:
                    saved = _write_samples(pred, batch, save_path, saved,
                                           save_samples)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    if save_path and save_matrices:
        acc.save_matrices(save_path)
    general, pos, neg = acc.results()
    return general, pos, neg, acc.voxel_mape_grid()


def _in_sample(epoch: int, every: int) -> bool:
    return epoch != 0 and epoch > 29 and epoch % every == 0


def train(model: torch.nn.Module, config: ExperimentConfig, train_loader,
          val_loader=None, save_path: Optional[str] = None, train_step=None,
          eval_step=None, resume_from: Optional[str] = None,
          num_rois: Optional[int] = None, roi_indices=ROI_INDICES,
          device=None, mesh=None) -> TrainState:
    """Train `model`, whose parameters must be on `device` (the GPU when
    None), for `config.train.epochs` epochs; returns the TrainState. With
    `config.train.data_parallel` N > 1, `mesh` must be this rank's place in
    a group of N (`parallel.make_mesh`) and the loaders must read its
    shard."""
    device = require_device(device)
    if _model_device(model).type != device.type:
        raise ValueError(f"the model is on {_model_device(model)}, "
                         f"training was asked on {device}")
    device = _model_device(model)
    tcfg, lcfg = config.train, config.loss
    dp = max(int(tcfg.data_parallel), 1)
    sp = max(int(tcfg.spatial_parallel), 1)
    if sp > 1:
        if device.type == "cuda" and dp * sp > torch.cuda.device_count():
            raise ValueError(f"mesh {dp}x{sp} > {torch.cuda.device_count()} "
                             f"devices")
        if mesh is None or mesh.rank == 0:
            log.info("spatial_parallel %d: the reference's training step maps "
                     "its batches over the data axis alone, so the spatial "
                     "axis adds no work; training on %d rank(s)", sp, dp)
    if (mesh.size if mesh is not None else 1) != dp:
        raise ValueError(
            f"data_parallel {dp} needs an initialized process group of {dp} "
            f"ranks (parallel.make_mesh), got "
            f"{'none' if mesh is None else mesh.size}")
    if mesh is not None:
        if tcfg.batch_size % dp:
            raise ValueError(f"batch_size {tcfg.batch_size} must be divisible "
                             f"by data_parallel {dp}")
        for ld in (train_loader, val_loader):
            if getattr(ld, "shard", (mesh.rank, dp)) != (mesh.rank, dp):
                raise ValueError(f"a loader reads shard {ld.shard}, not this "
                                 f"rank's {(mesh.rank, dp)}")
    writer = mesh is None or mesh.rank == 0  # the rank that writes files
    if num_rois is None:
        num_rois = len(roi_indices)
    save_path = save_path or config.save_path
    if writer:
        os.makedirs(save_path, exist_ok=True)
    LAST_RUN.clear()
    if writer:
        LAST_RUN.update(restore_s=0.0, epochs=[])

    # the first batch is drawn before anything else, as the JAX loop draws
    # its init example: it spends one pass of the loader's shuffle
    example = next(iter(train_loader))

    state = create_train_state(model, tcfg.lr, tcfg.weight_decay, tcfg.grad_acc)
    scheduler = ReduceLROnPlateau(patience=tcfg.plateau_patience,
                                  factor=tcfg.plateau_factor)
    ckpt = CheckpointManager(save_path) if writer else None
    roi_weights = torch.full((num_rois,), lcfg.roi_weight, dtype=torch.float32,
                             device=device)
    voxel_weights = None
    if lcfg.voxel_wise:
        if config.data.roi_template_path:
            tpl = load_template(config.data.roi_template_path,
                                target=config.data.volume_shape,
                                resize=config.data.resize)
            tpl_compact = compact_roi_np(tpl, roi_indices=roi_indices)
        else:
            tpl_compact = np.asarray(example["roi_compact"][0])
        voxel_weights = make_voxel_weights(
            torch.as_tensor(tpl_compact, device=device), roi_weights)
        if mesh is not None:  # the first sample of the global batch
            from coma_unet_tpu_torch.parallel.mesh import broadcast_

            broadcast_([voxel_weights], mesh)
    del example

    start_epoch = 0
    if resume_from:
        t0 = time.perf_counter()
        payload = restore_payload(state, resume_from, scheduler)
        last_epoch = int(payload["epoch"])
        if payload.get("roi_weights") is not None:
            roi_weights = payload["roi_weights"].to(device)
        if payload.get("voxel_weights") is not None and voxel_weights is not None:
            voxel_weights = payload["voxel_weights"].to(device)
        if writer:
            LAST_RUN["restore_s"] = time.perf_counter() - t0
        start_epoch = last_epoch + 1
        # the passes the uninterrupted run made before this epoch: the
        # first batch's, one per epoch, one per in-sample validation
        if hasattr(train_loader, "set_epoch"):
            train_loader.set_epoch(1 + start_epoch + sum(
                _in_sample(e, tcfg.overfit_val_iter) for e in range(start_epoch)))
        log.info("resumed from %s at epoch %d (step %d)", resume_from,
                 start_epoch, state.step)

    if device.type == "cuda":
        for ld in (train_loader, val_loader):
            if ld is not None and getattr(ld, "device_put", False) is None:
                ld.device_put = pin_batch
    if mesh is not None:
        from coma_unet_tpu_torch.parallel.mesh import (
            make_sharded_eval_step,
            make_sharded_train_step,
            replicate_state,
        )

        replicate_state(state, mesh)
        if train_step is None:
            train_step = make_sharded_train_step(model, lcfg, state.optimizer,
                                                 mesh, seed=tcfg.seed)
        if eval_step is None:
            eval_step = make_sharded_eval_step(model, num_rois, mesh)
    if train_step is None:
        train_step = make_train_step(model, lcfg, state.optimizer,
                                     seed=tcfg.seed)
    if eval_step is None:
        eval_step = make_eval_step(model, num_rois)

    if writer:
        recorder = MetricRecorder(save_path)
        pos_recorder = MetricRecorder(os.path.join(save_path, "pos_metrics"))
        neg_recorder = MetricRecorder(os.path.join(save_path, "neg_metrics"))
    hist: Dict[str, list] = {k: [] for k in (
        "avg", "total", "pos_avg", "neg_avg", "gen_avg", "tcds_avg")}
    best_mape, best_corr = float("inf"), -float("inf")

    for epoch in range(start_epoch, tcfg.epochs):
        t0 = time.perf_counter()
        epoch_loss = epoch_gen = epoch_tcds = 0.0
        pos_loss = neg_loss = 0.0
        n = n_pos = n_neg = 0
        wait_s = 0.0
        step_ms, step_losses = [], []
        it = iter(train_loader)
        batch_idx = -1
        pending = None  # (packed metrics, valid, abeta, batch_idx) of step i-1

        def consume(item):
            # book step i-1's metrics: one device -> host copy, made after
            # step i is enqueued
            nonlocal epoch_loss, epoch_gen, epoch_tcds, n
            nonlocal pos_loss, neg_loss, n_pos, n_neg
            packed, valid, abeta, idx = item
            hm = packed.cpu().numpy()
            bl, tcds, gen = float(hm[0]), float(hm[1]), hm[2:]
            if valid is None:  # data parallel: the rows' gathered valid, abeta
                gen, valid, abeta = np.split(gen, 3)
                valid = valid.astype(bool)
            step_losses.append(bl)
            epoch_loss += bl
            epoch_gen += float(gen[valid].sum())
            epoch_tcds += tcds
            n += int(valid.sum())
            is_pos, is_neg = valid & (abeta == 1), valid & (abeta == 0)
            pos_loss += float(gen[is_pos].sum()) + tcds * int(is_pos.sum())
            neg_loss += float(gen[is_neg].sum()) + tcds * int(is_neg.sum())
            n_pos += int(is_pos.sum())
            n_neg += int(is_neg.sum())
            if idx % 10 == 0:
                log.info("epoch %d batch %d loss %.4f", epoch, idx, bl)

        while True:
            t_w = time.perf_counter()
            try:
                batch = next(it)
            except StopIteration:
                break
            wait_s += time.perf_counter() - t_w
            batch_idx += 1
            t_s = time.perf_counter()
            abeta = np.asarray(batch["abeta"]).reshape(-1)
            valid = batch.get("valid")
            valid = (np.ones(abeta.shape[0], bool) if valid is None
                     else np.asarray(valid).reshape(-1).astype(bool))
            db = batch_to_device(batch, device)
            # wrap-padded rows carry no gradient: every loss term is masked
            db["valid_mask"] = torch.from_numpy(valid.astype(np.float32)).to(
                device, non_blocking=True)
            metrics = train_step(db, roi_weights, voxel_weights)
            parts = [metrics["loss"].reshape(1), metrics["tcds_loss"].reshape(1),
                     metrics["gen_loss"].reshape(-1)]
            if mesh is not None:  # the metrics cover the global batch
                parts += [metrics["valid_mask"], metrics["abeta"]]
                valid = abeta = None
            packed = torch.cat([t.float() for t in parts])
            if pending is not None:
                consume(pending)
            pending = (packed, valid, abeta, batch_idx)
            # a step's time: from its batch's arrival to the request for the
            # next, which holds the wait for step i-1's loss
            step_ms.append((time.perf_counter() - t_s) * 1e3)
        if pending is not None:
            t_s = time.perf_counter()
            consume(pending)
            pending = None
            step_ms[-1] += (time.perf_counter() - t_s) * 1e3
        step_s = sum(step_ms) / 1e3
        # the gradients are not needed until the next step zeroes them
        state.optimizer.zero_grad(set_to_none=True)

        avg = epoch_loss / max(n, 1)
        new_lr = scheduler.step(avg, get_lr(state.optimizer))
        set_lr(state.optimizer, new_lr)
        hist["avg"].append(avg)
        hist["total"].append(epoch_loss)
        hist["gen_avg"].append(epoch_gen / max(n, 1))
        hist["tcds_avg"].append(epoch_tcds / max(n, 1))
        hist["pos_avg"].append(pos_loss / max(n_pos, 1))
        hist["neg_avg"].append(neg_loss / max(n_neg, 1))
        busy = max(wait_s + step_s, 1e-9)
        log.info("epoch %d: avg loss %.4f (lr %.2e, %.1fs; loader wait %.2fs / "
                 "step %.2fs = %.1f%% stalled)", epoch, avg, new_lr,
                 time.perf_counter() - t0, wait_s, step_s, 100.0 * wait_s / busy)
        if writer:
            loss_graph((hist["avg"], hist["pos_avg"], hist["neg_avg"]),
                       os.path.join(save_path, "train_average_loss"),
                       labels=["Total", "Pos", "Neg"])
            loss_graph((hist["gen_avg"], hist["tcds_avg"]),
                       os.path.join(save_path, "train_average_component_losses"),
                       labels=["Gen.", "tCDS/RnC (weighted)"])
        record = dict(epoch=epoch, loss=avg, losses=step_losses, wait_s=wait_s,
                      step_s=step_s, step_ms=step_ms, validate_s=0.0)

        if val_loader is not None and epoch % tcfg.val_iter == 0:
            t_v = time.perf_counter()
            val_dir = os.path.join(save_path, f"{epoch}_output_samples")
            if writer:
                os.makedirs(val_dir, exist_ok=True)
            general, pos, neg, voxel_mape = evaluate(
                eval_step, val_loader, num_rois, save_path=val_dir,
                save_samples=2, device=device, mesh=mesh)
            if writer:
                recorder.record(general, epoch)
                pos_recorder.record(pos, epoch)
                neg_recorder.record(neg, epoch)
                recorder.plot()
                pos_recorder.plot()
                neg_recorder.plot()
            if tcfg.adaptive_roi_weights:
                if voxel_weights is not None and voxel_mape is not None:
                    errors = torch.as_tensor(voxel_mape / 100.0,
                                             dtype=torch.float32, device=device)
                    voxel_weights = update_voxel_weights(voxel_weights, errors)
                    log.info("updated voxel weights: mean %.4f max %.4f",
                             float(voxel_weights.mean()), float(voxel_weights.max()))
                else:
                    errors = torch.as_tensor(general.roi_mapes / 100.0,
                                             dtype=torch.float32, device=device)
                    roi_weights = update_roi_weights(roi_weights, errors,
                                                     lcfg.scale_factor)
                    log.info("updated roi weights: mean %.2f max %.2f",
                             float(roi_weights.mean()), float(roi_weights.max()))
            if general.mape < best_mape:
                best_mape = general.mape
                log.info("lowest MAPE so far at epoch %d: %.3f", epoch, best_mape)
            corr = float(np.nanmean(general.roi_correlations))
            if corr > best_corr:
                best_corr = corr
                log.info("highest avg ROI corr so far at epoch %d: %.4f",
                         epoch, best_corr)
            record["validate_s"] = time.perf_counter() - t_v

        if mesh is not None:
            # what the ranks decided from the global metrics must agree
            from coma_unet_tpu_torch.parallel.mesh import check_same

            decided = [torch.tensor([new_lr], dtype=torch.float64),
                       roi_weights.double().cpu()]
            if voxel_weights is not None:
                decided.append(voxel_weights.double().sum().reshape(1).cpu())
            check_same(torch.cat(decided), mesh,
                       "the learning rate and the adapted weights")

        t_c = time.perf_counter()
        if writer:
            ckpt.save_epoch(state, epoch, avg, scheduler, tcfg.checkpoint_iter,
                            roi_weights=roi_weights, voxel_weights=voxel_weights)
        record["checkpoint_s"] = time.perf_counter() - t_c
        record["seconds"] = time.perf_counter() - t0
        if writer:
            LAST_RUN["epochs"].append(record)

        if _in_sample(epoch, tcfg.overfit_val_iter):
            log.info("in-sample (overfit) validation at epoch %d", epoch)
            general, _, _, _ = evaluate(eval_step, train_loader, num_rois,
                                        save_matrices=False, device=device,
                                        mesh=mesh)
            log.info("in-sample MAE %.4f MAPE %.2f SSIM %.4f",
                     general.mae, general.mape, general.ssim)

    return state
