"""Command-line interface of the port (counterpart of
`coma_unet_tpu/cli/main.py`):

    python -m coma_unet_tpu_torch.cli.main train    ...  # fold training
    python -m coma_unet_tpu_torch.cli.main validate ...  # metrics + CSVs
    python -m coma_unet_tpu_torch.cli.main infer    ...  # MRI-only synthesis

The parser has the JAX CLI's options with the same defaults, and one of its
own: `--device` (default `cuda`). Without a card, `--device cuda` raises
and names `--device cpu`. The Hopper kernels take bfloat16 and float32:
with a CUDA device and any other `compute_dtype` (flag or `--config`) the
CLI exits with status 2 before it builds a model; `--device cpu` runs any.
Float32 on CUDA turns TF32 off in cuDNN and in matmul before the model is
built, so that the convs and matmuls outside the kernels (levels 2-4, the
baselines) sum in full f32 too, as the reference's Precision.HIGHEST does.
The training objective is the config's: `"loss": {"rnc": false}` in
`--config` trains with tCDS on (anchor, positive, negative) triplets.
Every `-model_type` of the registry runs (`models/registry.py`), with
`--norm batch` and a config's dropout; the baselines train on the
generative loss alone, and `--save_attention` asks for psi maps that only
ContraAttnUNET returns (ValueError before anything is written otherwise).

`train` and `validate` with `--data_parallel N` > 1 (the flag or the
config's `train.data_parallel`) start N rank processes themselves, one a
device: rank r on `cuda:r` over NCCL with `--device cuda`, on the CPU over
gloo with `--device cpu`; the group meets at a file store in a temporary
directory (`parallel/mesh.py`). Each rank reads its rows of every global
batch, and the run gives the single-process numbers on the concatenated
batch; rank 0 writes the files and prints. The command exits with status 2
before anything is written where N exceeds the visible cards
(`--device cuda`) or does not divide the batch size, and fails where a rank
fails. `infer` with `--data_parallel` alone runs the plain forward, as the
JAX CLI's does.

`infer --spatial_parallel S` > 1 (without `--sliding_window`, which ignores
it, as the JAX CLI does) synthesizes each volume on D x S ranks, D the
data-parallel size: each rank holds a depth slab of the volume and its
activations (`parallel/spatial.py`; the slabs may be uneven, and the
last rank's odd), and rank 0 writes the volumes. It exits with status 2
before anything is written where D x S exceeds the visible cards
(`--device cuda`), where the volume's deepest level holds too few planes
to give every rank one, for a `-model_type` other than ContraAttnUNET
(the reference's spatial forward passes `with_projections=False`, which no
baseline takes) and with `--save_attention`, whose export needs the whole
forward in one process. A config's `train.spatial_parallel` S trains with
the numbers of `data_parallel` D alone, on D ranks, as the reference's
spatial axis only replicates its step; D x S beyond the visible cards
exits with status 2 there too.

The results directory is the reference's: <save>/<run>/checkpoints/,
<save>/<run>/validation_metric_results/, <save>/<run>/<epoch>_output_samples/.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import sys
import time
from typing import Optional

import numpy as np
import torch

from coma_unet_tpu_torch.models.registry import MODEL_TYPES


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="coma-unet-torch")
    sub = p.add_subparsers(dest="command", required=True)

    def common(sp):
        sp.add_argument("-save_path", default="results")
        sp.add_argument("-model_type", default="ContraAttnUNET",
                        choices=list(MODEL_TYPES))
        sp.add_argument("-batch_size", type=int, default=2)
        sp.add_argument("-description", default="")
        sp.add_argument("-template_space", action="store_true")
        sp.add_argument("-covariates", action="store_true", default=True)
        sp.add_argument("-smoothing", action="store_true")
        sp.add_argument("-rnc", action="store_true", default=True)
        sp.add_argument("-checkpoint_path", default=None)
        sp.add_argument("--config", default=None,
                        help="ExperimentConfig JSON file (overrides flags)")
        sp.add_argument("--splits_dir", default="training_folds")
        sp.add_argument("--covariate_csv", default=None)
        sp.add_argument("--quartile_csv", default=None)
        sp.add_argument("--predictions_json", default=None)
        sp.add_argument("--cognition_json", default=None,
                        help="KNN-predicted MMSCORE table (combined cohort)")
        sp.add_argument("--abeta_fallback_json", default=None,
                        help="predicted abeta fallback table (combined cohort)")
        sp.add_argument("--fold", type=int, default=4)
        sp.add_argument("--data_parallel", type=int, default=1)
        sp.add_argument("--norm", default="instance")
        sp.add_argument("--compute_dtype", default="bfloat16")
        sp.add_argument("--voxel_wise", action="store_true",
                        help="voxel-wise RoiMSE weight grid + adaptive voxel "
                             "updates")
        sp.add_argument("--roi_template", default=None,
                        help="template ROI mask NIfTI for the voxel-wise "
                             "weight grid")
        sp.add_argument("--holdout_ids", default=None,
                        help="subjects excluded from training: comma-separated"
                             " ids or a file with one id per line")
        sp.add_argument("--device", default="cuda",
                        help="torch device: cuda (the Hopper kernels, bf16 "
                             "or f32) or cpu (the plain versions, any dtype)")

    t = sub.add_parser("train", help="train a model on fold lookups")
    common(t)
    t.add_argument("-resume_training", action="store_true")
    t.add_argument("-cross_val", action="store_true")
    t.add_argument("--train_lookup", default=None,
                   help="explicit training lookup CSV (overrides "
                        "splits_dir/fold)")
    t.add_argument("--test_lookup_file", default=None,
                   help="explicit test lookup CSV")
    t.add_argument("--epochs", type=int, default=61)
    t.add_argument("--lr", type=float, default=1e-3)
    t.add_argument("--combined", action="store_true",
                   help="combined ADNI+A4 flat dataset (lr default 1e-4)")

    v = sub.add_parser("validate", help="run the evaluation suite")
    common(v)
    v.add_argument("--test_lookup", required=True)

    i = sub.add_parser("infer", help="MRI-only tau-PET synthesis")
    common(i)
    i.add_argument("--input_lookup", default=None,
                   help="CSV with MRI (+roi) path columns")
    i.add_argument("--cohort", default=None,
                   choices=("ucsf", "a4", "nacc", "nacc_nonscan",
                            "adni_autopsy"),
                   help="named per-cohort preset bundle")
    i.add_argument("--cohort_dir", default=None,
                   help="base directory of the cohort preset bundle")
    i.add_argument("--out_dir", default="synth_out")
    i.add_argument("--sliding_window", action="store_true")
    i.add_argument("--spatial_parallel", type=int, default=1,
                   help="shard the volume spatially over this many devices")
    i.add_argument("--patch_size", type=int, default=128)
    i.add_argument("--overlap", type=float, default=0.25)
    i.add_argument("--save_attention", action="store_true",
                   help="also export per-level attention maps as NIfTI")
    return p


def _parse_holdout_ids(spec: Optional[str]):
    """Comma-separated ids, or a file of one id per line."""
    if not spec:
        return ()
    if os.path.isfile(spec):
        with open(spec) as f:
            return tuple(line.strip() for line in f if line.strip())
    return tuple(s.strip() for s in spec.split(",") if s.strip())


def _experiment_config(args):
    from coma_unet_tpu_torch.config import (
        DataConfig, ExperimentConfig, LossConfig, ModelConfig, TrainConfig,
    )

    if args.config:
        with open(args.config) as f:
            cfg = ExperimentConfig.from_json(f.read())
        # data-source flags overlay the config file
        data_overrides = {}
        for flag, field_name in (
            ("splits_dir", "splits_dir"), ("covariate_csv", "covariate_csv"),
            ("quartile_csv", "quartile_csv"), ("fold", "fold"),
        ):
            v = getattr(args, flag, None)
            if v not in (None, "", "training_folds", 4):
                data_overrides[field_name] = v
        if data_overrides:
            cfg = dataclasses.replace(
                cfg, data=dataclasses.replace(cfg.data, **data_overrides))
        if getattr(args, "save_path", "results") != "results":
            cfg = dataclasses.replace(cfg, save_path=args.save_path)
        if getattr(args, "model_type", "ContraAttnUNET") != "ContraAttnUNET":
            cfg = dataclasses.replace(cfg, model_type=args.model_type)
        train_overrides = {}
        if getattr(args, "data_parallel", 1) != 1:
            train_overrides["data_parallel"] = args.data_parallel
        if getattr(args, "batch_size", 2) != 2:
            train_overrides["batch_size"] = args.batch_size
        if train_overrides:
            cfg = dataclasses.replace(
                cfg, train=dataclasses.replace(cfg.train, **train_overrides))
        if getattr(args, "voxel_wise", False):
            cfg = dataclasses.replace(
                cfg, loss=dataclasses.replace(cfg.loss, voxel_wise=True))
        late_data = {}
        if getattr(args, "roi_template", None):
            late_data["roi_template_path"] = args.roi_template
        if getattr(args, "holdout_ids", None):
            late_data["holdout_ids"] = _parse_holdout_ids(args.holdout_ids)
        if late_data:
            cfg = dataclasses.replace(
                cfg, data=dataclasses.replace(cfg.data, **late_data))
        return cfg
    model = ModelConfig(
        conditional=args.covariates,
        norm=args.norm,
        compute_dtype=args.compute_dtype,
        with_modulator=args.model_type == "ContraAttnUNET",
    )
    loss = LossConfig(
        rnc=args.rnc,
        roi_weight=1.0 if args.template_space else 225.0,
        voxel_wise=getattr(args, "voxel_wise", False),
    )
    train_cfg = TrainConfig(
        epochs=getattr(args, "epochs", 61),
        lr=getattr(args, "lr", 1e-3) if not getattr(args, "combined", False)
        else 1e-4,
        batch_size=args.batch_size,
        data_parallel=args.data_parallel,
    )
    data = DataConfig(
        splits_dir=args.splits_dir,
        covariate_csv=args.covariate_csv or "",
        quartile_csv=args.quartile_csv or "",
        fold=args.fold,
        template_space=args.template_space,
        smoothing=args.smoothing,
        roi_template_path=getattr(args, "roi_template", None) or "",
        holdout_ids=_parse_holdout_ids(getattr(args, "holdout_ids", None)),
    )
    return ExperimentConfig(
        model=model, loss=loss, train=train_cfg, data=data,
        save_path=args.save_path, description=args.description,
        model_type=args.model_type,
    )


KERNEL_DTYPES = ("bfloat16", "float32")  # the compute dtypes with Hopper kernels


def _refuse_dtype(args, config) -> bool:
    """The dtype decision: on CUDA the Hopper kernels take bfloat16 and
    float32, so any other compute dtype is refused (status 2) before a model
    is built; the CPU's plain versions run any dtype. Float32 on CUDA turns
    TF32 off in cuDNN and in matmul."""
    dtype = config.model.compute_dtype
    if torch.device(args.device).type != "cuda":
        return False
    if dtype not in KERNEL_DTYPES:
        print(f"compute_dtype {dtype!r} on {args.device}: the port's Hopper "
              f"kernels take bfloat16 or float32; use --compute_dtype "
              f"bfloat16 or float32, or --device cpu to run {dtype} through "
              f"the plain versions", file=sys.stderr)
        return True
    if dtype == "float32":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    return False


def _cards_why(args, data: int, spatial: int) -> Optional[str]:
    """Why a mesh of data x spatial devices cannot be had, or None: on CUDA
    it needs as many visible cards (the JAX `make_mesh`'s ValueError)."""
    n = data * spatial
    if (n > 1 and torch.device(args.device).type == "cuda"
            and n > torch.cuda.device_count()):
        return (f"data_parallel {data} x spatial_parallel {spatial} runs one "
                f"rank a card, and {torch.cuda.device_count()} CUDA devices "
                f"are visible")
    return None


def _refuse_parallel(args, config, spatial: int = 1) -> bool:
    """The data-parallel decision, made before anything is written: N ranks
    must split the batch, and N x `spatial` need as many visible cards on
    CUDA."""
    n = int(config.train.data_parallel)
    why = None
    if n > 1 and config.train.batch_size % n:
        why = (f"batch_size {config.train.batch_size} must be divisible by "
               f"data_parallel {n}")
    else:
        why = _cards_why(args, n, spatial)
    if why:
        print(why, file=sys.stderr)
    return why is not None


def _refuse_spatial(args, config, spatial: int) -> bool:
    """The spatial-inference decision, made before anything is written."""
    from coma_unet_tpu_torch.parallel.spatial import level_strides, plan_slabs

    data = max(int(config.train.data_parallel), 1)
    why = _cards_why(args, data, spatial)
    if why is None and config.model_type != "ContraAttnUNET":
        why = (f"--spatial_parallel runs ContraAttnUNET only, not "
               f"{config.model_type}: the reference's spatial forward passes "
               f"with_projections=False, which no baseline takes")
    if why is None and args.save_attention:
        why = ("--save_attention exports from the whole forward in one "
               "process; it does not run with --spatial_parallel")
    if why is None:
        try:
            plan_slabs(config.data.volume_shape[0], level_strides(config.model),
                       data * spatial)
        except ValueError as e:
            why = f"--spatial_parallel {spatial} (x data_parallel {data}): {e}"
    if why:
        print(why, file=sys.stderr)
    return why is not None


def _prepare(args, mesh=None, parallel: bool = True, spatial: bool = False,
             refuse=None):
    """The normalized config and the device, or None where the dtype, the
    data-parallel layout (with `spatial`, the config's
    `train.spatial_parallel` devices to each data-parallel rank, as the
    reference's training mesh has) or `refuse(config)` refuses; raises for
    a missing card. A rank of a parallel run takes its mesh's device."""
    from coma_unet_tpu_torch.train.loop import require_device

    config = _experiment_config(args).normalized()
    sp = max(int(config.train.spatial_parallel), 1) if spatial else 1
    if (_refuse_dtype(args, config)
            or (parallel and _refuse_parallel(args, config, sp))
            or (refuse is not None and refuse(config))):
        return None, None
    if mesh is not None:
        return config, mesh.device
    return config, require_device(args.device)


def _build_model(config, device):
    from coma_unet_tpu_torch.models.registry import build_model

    return build_model(config.model_type, config.model, device=device,
                       generator=torch.Generator().manual_seed(config.train.seed))


def _roi_indices(config):
    from coma_unet_tpu_torch.config import ROI_INDICES, TEMPLATE_ROI_INDICES

    return TEMPLATE_ROI_INDICES if config.data.template_space else ROI_INDICES


def _tables(args, config):
    from coma_unet_tpu_torch.data import (
        CovariateTable, PredictionTable, QuartileTable,
    )

    cov = CovariateTable(config.data.covariate_csv)
    quart = (QuartileTable(config.data.quartile_csv)
             if config.data.quartile_csv else None)
    preds = (PredictionTable(args.predictions_json)
             if getattr(args, "predictions_json", None) else None)
    return cov, quart, preds


def _load_json(path: Optional[str]) -> dict:
    if not path:
        return {}
    with open(path) as f:
        return json.load(f)


def _build_loaders(args, config, shard=(0, 1)):
    from coma_unet_tpu_torch.data import (
        CombinedVolumeDataset, DataLoader, PredictedMetaTauDataset,
        filter_for_holdout,
    )

    cov, quart, preds = _tables(args, config)
    k = config.data.fold
    train_csv = getattr(args, "train_lookup", None) or os.path.join(
        config.data.splits_dir, f"training_lookup_{k}.csv")
    test_csv = getattr(args, "test_lookup_file", None) or os.path.join(
        config.data.splits_dir, f"test_lookup_{k}.csv")
    ds_kwargs = dict(template_space=config.data.template_space,
                     smoothing=config.data.smoothing,
                     pad_dims=config.data.volume_shape)
    if getattr(args, "combined", False):
        if not config.loss.rnc:
            raise ValueError(
                "--combined reads the flat CombinedVolumeDataset, which has no "
                "triplets; the tCDS loss (loss.rnc = false) needs them")
        aux = dict(cognition_table=_load_json(args.cognition_json),
                   abeta_fallback_table=_load_json(args.abeta_fallback_json))
        train_ds, test_ds = (CombinedVolumeDataset(csv, cov, meta_tau_table=preds,
                                                   **aux, **ds_kwargs)
                             for csv in (train_csv, test_csv))
    else:
        train_ds, test_ds = (PredictedMetaTauDataset(csv, cov, quart,
                                                     meta_tau_table=preds,
                                                     **ds_kwargs)
                             for csv in (train_csv, test_csv))
    roi_idx = _roi_indices(config)
    # holdout subjects are excluded from training only
    sampler = None
    if config.data.holdout_ids:
        ids = [train_ds.sample_id(i) for i in range(len(train_ds))]
        keep = filter_for_holdout(ids, config.data.holdout_ids)
        sampler = [i for i, kept in enumerate(keep) if kept]
        logging.getLogger(__name__).info(
            "holdout filter: %d/%d training samples kept",
            len(sampler), len(train_ds))
    train_loader = DataLoader(train_ds, config.train.batch_size,
                              predictions=preds, shuffle=True, drop_last=False,
                              with_triplets=not config.loss.rnc,
                              roi_indices=roi_idx, sampler=sampler, shard=shard)
    test_loader = DataLoader(test_ds, config.train.batch_size,
                             predictions=preds, roi_indices=roi_idx, shard=shard)
    return train_loader, test_loader


def _run_dir_name(args) -> str:
    """A timestamped results dir; resuming from a checkpoint writes to
    `native_target_finetune_<original run dir>`, so that the finetune never
    overwrites the source run. The ranks of a data-parallel run take the
    name their launcher chose."""
    if getattr(args, "run_dir_name", None):
        return args.run_dir_name
    if getattr(args, "resume_training", False) and \
            getattr(args, "checkpoint_path", None):
        ckpt = os.path.abspath(args.checkpoint_path)
        # .../<run dir>/checkpoints/<checkpoint>
        orig = os.path.basename(os.path.dirname(os.path.dirname(ckpt)))
        return "native_target_finetune_" + orig
    return time.strftime("%Y-%m-%d_%H-%M-%S")


def _load_weights(model, path: Optional[str]) -> None:
    if path:
        from coma_unet_tpu_torch.train.checkpoint import load_checkpoint

        model.load_state_dict(load_checkpoint(path)["model"])


def _shard(mesh):
    return (0, 1) if mesh is None else (mesh.rank, mesh.size)


def cmd_train(args, mesh=None) -> int:
    from coma_unet_tpu_torch.data.table import read_csv
    from coma_unet_tpu_torch.train.loop import train
    from coma_unet_tpu_torch.utils.logging import setup_logging

    config, device = _prepare(args, mesh, spatial=True)
    if config is None:
        return 2
    if config.train.data_parallel > 1 and mesh is None:
        args.run_dir_name = _run_dir_name(args)
        return _launch(cmd_train, args, config.train.data_parallel)
    writer = mesh is None or mesh.rank == 0
    run_dir = os.path.join(config.save_path, _run_dir_name(args))
    if writer:
        os.makedirs(run_dir, exist_ok=True)
        setup_logging(os.path.join(run_dir, f"train_{config.model_type}.log"))
        with open(os.path.join(run_dir, "config.json"), "w") as f:
            f.write(config.to_json())
    else:
        setup_logging(None, level=logging.WARNING)

    folds = [config.data.fold]
    if getattr(args, "cross_val", False):
        # 5-fold cross validation: a fresh model per fold, fold_k/ subdirs
        folds = list(range(1, 6))
    fold_metrics = []
    for k in folds:
        fold_cfg = dataclasses.replace(
            config, data=dataclasses.replace(config.data, fold=k))
        fold_dir = run_dir if len(folds) == 1 else os.path.join(run_dir, f"fold_{k}")
        if writer:
            os.makedirs(fold_dir, exist_ok=True)
        model = _build_model(fold_cfg, device)
        train_loader, test_loader = _build_loaders(args, fold_cfg, _shard(mesh))
        resume = args.checkpoint_path if args.resume_training else None
        train(model, fold_cfg, train_loader, val_loader=test_loader,
              save_path=fold_dir, resume_from=resume,
              roi_indices=_roi_indices(fold_cfg), device=device, mesh=mesh)
        mape_csv = os.path.join(fold_dir, "validation_metric_results", "mape.csv")
        if writer and os.path.exists(mape_csv):
            table = read_csv(mape_csv)
            if table.columns:
                fold_metrics.append(float(table[table.columns[-1]][0]))
    if len(fold_metrics) > 1:
        print(f"cross-val final MAPE per fold: {fold_metrics}; "
              f"mean {np.mean(fold_metrics):.3f}")
    return 0


def cmd_validate(args, mesh=None) -> int:
    from coma_unet_tpu_torch.data import DataLoader, PredictedMetaTauDataset, pin_batch
    from coma_unet_tpu_torch.train.loop import evaluate
    from coma_unet_tpu_torch.train.step import make_eval_step
    from coma_unet_tpu_torch.utils.logging import setup_logging

    config, device = _prepare(args, mesh)
    if config is None:
        return 2
    if config.train.data_parallel > 1 and mesh is None:
        return _launch(cmd_validate, args, config.train.data_parallel)
    if mesh is not None and mesh.rank != 0:
        setup_logging(None, level=logging.WARNING)
    else:
        setup_logging(None)
    model = _build_model(config, device)
    cov, quart, preds = _tables(args, config)
    ds = PredictedMetaTauDataset(
        args.test_lookup, cov, quart, meta_tau_table=preds,
        template_space=config.data.template_space,
        pad_dims=config.data.volume_shape)
    roi_idx = _roi_indices(config)
    loader = DataLoader(ds, config.train.batch_size, predictions=preds,
                        roi_indices=roi_idx,
                        device_put=pin_batch if device.type == "cuda" else None,
                        shard=_shard(mesh))
    _load_weights(model, args.checkpoint_path)
    if mesh is not None:
        from coma_unet_tpu_torch.parallel.mesh import make_sharded_eval_step

        eval_step = make_sharded_eval_step(model, len(roi_idx), mesh)
    else:
        eval_step = make_eval_step(model, len(roi_idx))
    general, pos, neg, _ = evaluate(
        eval_step, loader, len(roi_idx), save_path=args.save_path,
        device=device, mesh=mesh)
    if mesh is not None and mesh.rank != 0:
        return 0
    for tag, res in (("overall", general), ("abeta+", pos), ("abeta-", neg)):
        print(f"[{tag}] MAE={res.mae:.4f} MAPE={res.mape:.2f}% "
              f"RSE={res.rse:.4f} RRMSE={res.rrmse:.4f} SSIM={res.ssim:.4f} "
              f"avg_roi_corr={np.nanmean(res.roi_correlations):.4f} "
              f"(n={res.num_samples})")
    # the overall numbers at full precision, as the recorder's CSVs hold them
    print(json.dumps({"validate": {
        "mae": general.mae, "mape": general.mape,
        "avg_corr": float(np.mean(np.nan_to_num(general.roi_correlations))),
        "roi_maes": general.roi_maes.tolist(),
        "roi_mapes": general.roi_mapes.tolist(),
        "num_samples": general.num_samples}}))
    return 0


def cmd_infer(args, mesh=None) -> int:
    from coma_unet_tpu_torch.data import (
        CovariateTable, DataLoader, InferenceVolumeDataset, PredictionTable,
        batch_to_device, pin_batch,
    )
    from coma_unet_tpu_torch.infer import make_infer_fn, sliding_window_inference
    from coma_unet_tpu_torch.io.volume import write_tensor_to_nii
    from coma_unet_tpu_torch.utils.logging import setup_logging

    # --data_parallel alone runs the plain forward here, as in the JAX CLI;
    # so does --sliding_window, whatever --spatial_parallel says
    sp = max(int(args.spatial_parallel or 1), 1)
    spatial = sp > 1 and not args.sliding_window
    config, device = _prepare(
        args, mesh, parallel=False,
        refuse=lambda c: spatial and mesh is None and _refuse_spatial(args, c, sp))
    if config is None:
        return 2
    writer = mesh is None or mesh.rank == 0
    setup_logging(None, level=logging.INFO if writer else logging.WARNING)
    if args.cohort and not args.cohort_dir:
        print("--cohort requires --cohort_dir", file=sys.stderr)
        return 2
    if not args.cohort and not args.input_lookup:
        print("--input_lookup is required without --cohort", file=sys.stderr)
        return 2
    if spatial and mesh is None:
        return _launch(cmd_infer, args,
                       max(int(config.train.data_parallel), 1) * sp)
    model = _build_model(config, device)
    if args.save_attention:
        from coma_unet_tpu_torch.models.registry import has_attention_maps

        if not has_attention_maps(model):
            raise ValueError(f"--save_attention: -model_type "
                             f"{config.model_type} returns no attention maps")
    preds = (PredictionTable(args.predictions_json)
             if args.predictions_json else None)
    if args.cohort:
        from coma_unet_tpu_torch.data.cohorts import load_cohort_dataset

        ds = load_cohort_dataset(args.cohort, args.cohort_dir,
                                 pad_dims=config.data.volume_shape,
                                 paths_csv=args.input_lookup)
        preds = preds or ds.meta_tau_table
    else:
        ds = InferenceVolumeDataset(
            args.input_lookup, CovariateTable(config.data.covariate_csv),
            meta_tau_table=preds, pad_dims=config.data.volume_shape)
    pin = device.type == "cuda" and not spatial
    loader = DataLoader(ds, 1, predictions=preds,
                        device_put=pin_batch if pin else None)
    _load_weights(model, args.checkpoint_path)
    if spatial:
        from coma_unet_tpu_torch.parallel.spatial import make_spatial_infer_fn

        infer = make_spatial_infer_fn(model, mesh)
    else:
        infer = make_infer_fn(model)
    if writer:
        os.makedirs(args.out_dir, exist_ok=True)
    keys = ("mri", "covars", "roi_loc", "roi_std", "roi_compact")
    for bi, batch in enumerate(loader):
        if args.sliding_window:
            out = sliding_window_inference(
                infer, *(np.asarray(batch[k]) for k in keys),
                patch_size=(args.patch_size,) * 3, overlap=args.overlap)
        elif spatial:  # every rank takes its slab; rank 0 gets the volume
            out = infer(*(batch[k] for k in keys))
        else:
            db = batch_to_device(batch, device)
            out = infer(*(db[k] for k in keys))
        if not writer:
            continue
        sid = batch["sample_ids"][0].replace("/", "_") or f"sample_{bi}"
        path = os.path.join(args.out_dir, f"{sid}_synth_tau.nii")
        write_tensor_to_nii(out[0], path)
        print(f"wrote {path}")
        if args.save_attention:
            from coma_unet_tpu_torch.analysis import export_attention_maps

            export_attention_maps(model, batch,
                                  os.path.join(args.out_dir, "attention"),
                                  sample_ids=batch["sample_ids"])
    return 0


def _rank_main(rank: int, command, args, world: int, init_method: str,
               out_path: str) -> None:
    """One rank of a parallel `command`: joins the group on its device
    (`cuda:<rank>` or the CPU), runs the command with its mesh and exits
    with its status; rank 0's standard output goes to `out_path`, which the
    launcher prints."""
    import contextlib

    from coma_unet_tpu_torch.parallel.mesh import destroy_mesh, make_mesh

    torch.set_num_threads(max(1, torch.get_num_threads() // world))
    cuda = torch.device(args.device).type == "cuda"
    mesh = make_mesh(rank, world, f"cuda:{rank}" if cuda else "cpu",
                     init_method)
    try:
        with open(out_path if rank == 0 else os.devnull, "w") as out, \
                contextlib.redirect_stdout(out):
            rc = command(args, mesh)
    finally:
        destroy_mesh()
    if rc:
        sys.exit(rc)


def _launch(command, args, world: int) -> int:
    """Run `command` on `world` rank processes and wait
    for them: 0 when every rank succeeded, else 1 (a rank that fails ends
    the others). The kernels are built here first, so the ranks load one
    library and none rebuilds it. The ranks are forked from a fork server
    that imports torch once for this process's launches (and touches no
    device)."""
    import multiprocessing
    import shutil
    import tempfile

    import torch.multiprocessing as mp
    from torch.multiprocessing.spawn import ProcessException

    if torch.device(args.device).type == "cuda":
        from coma_unet_tpu_torch.ops._build import build

        build()
    tmp = tempfile.mkdtemp(prefix="coma_dp_")
    out_path = os.path.join(tmp, "rank0.out")
    try:
        multiprocessing.get_context("forkserver").set_forkserver_preload(
            ["torch", "coma_unet_tpu_torch.cli.main"])
        ctx = mp.start_processes(
            _rank_main, args=(command, args, world,
                              "file://" + os.path.join(tmp, "store"), out_path),
            nprocs=world, join=False, start_method="forkserver")
        try:
            while not ctx.join():
                pass
            rc = 0
        except ProcessException as e:
            print(f"{world}-rank {args.command} failed: {e}", file=sys.stderr)
            rc = 1
        if os.path.exists(out_path):
            with open(out_path) as f:
                print(f.read(), end="")
        return rc
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main(argv: Optional[list] = None) -> int:
    args = build_parser().parse_args(argv)
    if args.command == "train":
        return cmd_train(args)
    if args.command == "validate":
        return cmd_validate(args)
    if args.command == "infer":
        return cmd_infer(args)
    return 1


if __name__ == "__main__":
    sys.exit(main())
