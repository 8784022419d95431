"""The port's command line (`coma_unet_tpu_torch/cli/main.py`) on the CPU.

The parser has every option of the JAX CLI with the same default, plus
`--device`; `train` -> `validate` -> `infer` with `--device cpu` write the
files that `tests/test_cli.py` names, `validate` prints the metrics the
run's last validation CSV holds, a resume writes to
`native_target_finetune_<run>` and continues the epochs, and `-cross_val`
trains one fold directory per fold. The device and dtype rules: `--device
cuda` without a card raises and names `--device cpu`; float32 on CUDA
builds a float32 model with TF32 off, and a compute dtype other than
bfloat16 and float32 exits with status 2 before a model is built;
the baselines and `--norm batch` run. `infer --spatial_parallel 2` on two
gloo ranks writes the volumes of the single-process `infer`, a config's
`train.spatial_parallel` trains as the run without it, and a baseline,
`--save_attention`, more ranks than the deepest level has planes or more
ranks than cards exit with status 2 before writing. `train` and `validate` with
`--data_parallel 2` on two gloo ranks give the single-process numbers, the
run's checkpoint resumes in one process, a batch the ranks cannot split or
more ranks than cards exit with status 2 before writing, and a rank that
fails fails the command. A fresh
interpreter that refuses jax, flax, optax, orbax, pandas, matplotlib and
the JAX package runs `train`, and holds no model after it.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import coma_unet_tpu_torch.train.loop as ploop
from coma_unet_tpu_torch.cli import build_parser, main
from coma_unet_tpu_torch.data.synthetic import make_synthetic_cohort
from coma_unet_tpu_torch.data.table import read_csv, write_rows
from coma_unet_tpu_torch.io import load_nifti_vol
from coma_unet_tpu_torch.train.recorder import MetricRecorder

ROOT = Path(__file__).resolve().parents[1]

TINY = {
    "model": {"channels": [4, 8], "strides": [2, 2], "latent_spaces": [16, 16],
              "prompt_shape": [16, 16, 16], "num_experts": 2,
              "compute_dtype": "float32"},
    "loss": {"cds_weights": [0.0, 1.0]},
    "train": {"epochs": 1, "batch_size": 2, "val_iter": 1,
              "adaptive_roi_weights": False},
    "data": {"volume_shape": [16, 16, 16]},
}


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    c = make_synthetic_cohort(str(root / "cohort"))
    rows = read_csv(c["lookup"]).rows()
    splits = root / "splits"
    splits.mkdir()
    for k in range(1, 6):
        write_rows(str(splits / f"training_lookup_{k}.csv"), rows[:4])
        write_rows(str(splits / f"test_lookup_{k}.csv"), rows[4:6])
    c["splits"] = str(splits)
    c["root"] = str(root)
    return c


def _config_file(path, **train):
    cfg = json.loads(json.dumps(TINY))
    cfg["train"].update(train)
    cfg["save_path"] = str(path.parent / "results")
    with open(str(path), "w") as f:
        json.dump(cfg, f)
    return str(path)


def _tables(c):
    return ["--covariate_csv", c["cov"], "--quartile_csv", c["quart"],
            "--predictions_json", c["preds"]]


def test_parser_has_every_jax_option_with_its_default():
    jax_cli = pytest.importorskip("coma_unet_tpu.cli")

    def options(parser):
        sub = next(a for a in parser._actions if a.choices and
                   isinstance(a.choices, dict))
        return {cmd: {a.dest: (tuple(a.option_strings), a.default, a.choices,
                               a.required)
                      for a in sp._actions if a.dest != "help"}
                for cmd, sp in sub.choices.items()}

    ours, theirs = options(build_parser()), options(jax_cli.build_parser())
    assert set(ours) == set(theirs) == {"train", "validate", "infer"}
    for cmd in theirs:
        assert {k: v for k, v in ours[cmd].items() if k != "device"} == theirs[cmd]
        assert ours[cmd]["device"][:2] == (("--device",), "cuda")


def test_train_validate_infer_on_the_cpu(cohort, tmp_path, capsys):
    cfg = _config_file(tmp_path / "config.json", epochs=2, checkpoint_iter=1,
                       adaptive_roi_weights=True)
    common = ["--config", cfg, "--device", "cpu"] + _tables(cohort)
    assert main(["train", "--splits_dir", cohort["splits"], "--fold", "1"]
                + common) == 0
    runs = sorted((tmp_path / "results").iterdir())
    assert len(runs) == 1
    run = runs[0]
    for name in ("checkpoint_latest_epoch", "checkpoint_epoch_0",
                 "checkpoint_epoch_1"):
        assert (run / "checkpoints" / name).exists()
    assert (run / "config.json").exists()
    assert (run / "train_ContraAttnUNET.log").exists()
    assert (run / "val_MAE.png").exists() and (run / "train_average_loss.png").exists()
    mae = read_csv(str(run / "validation_metric_results" / "mae.csv"))
    assert mae.columns == ["epoch_0", "epoch_1"]
    assert (run / "1_output_samples" / "pred_means.csv").exists()
    assert len(list((run / "1_output_samples").glob("*_pred.nii"))) == 2

    capsys.readouterr()
    latest = str(run / "checkpoints" / "checkpoint_latest_epoch")
    assert main(["validate", "--test_lookup",
                 os.path.join(cohort["splits"], "test_lookup_1.csv"),
                 "-checkpoint_path", latest,
                 "-save_path", str(tmp_path / "val_out")] + common) == 0
    printed = capsys.readouterr().out
    line = next(json.loads(s) for s in printed.splitlines() if s.startswith("{"))
    got = line["validate"]
    assert got["num_samples"] == 2
    assert "[overall] MAE=" in printed and "[abeta-]" in printed
    csv_dir = run / "validation_metric_results"
    for key, name in (("mae", "mae"), ("mape", "mape"), ("avg_corr", "avg_corr"),
                      ("roi_maes", "roi_maes"), ("roi_mapes", "roi_mapes")):
        want = read_csv(str(csv_dir / f"{name}.csv"))["epoch_1"]
        np.testing.assert_allclose(np.atleast_1d(got[key]), want, rtol=1e-12,
                                   atol=0, err_msg=key)
    assert (tmp_path / "val_out" / "pred_means.csv").exists()

    out_dir = tmp_path / "synth"
    assert main(["infer", "--input_lookup", cohort["lookup"],
                 "-checkpoint_path", latest, "--out_dir", str(out_dir)] + common) == 0
    outs = sorted(os.listdir(str(out_dir)))
    assert len(outs) == 8 and all(o.endswith("_synth_tau.nii") for o in outs)
    vol = load_nifti_vol(str(out_dir / outs[0]), resize=False)
    assert vol.shape == (1, 16, 16, 16) and np.isfinite(vol).all()
    win_dir = tmp_path / "synth_window"
    assert main(["infer", "--input_lookup", cohort["lookup"], "-checkpoint_path",
                 latest, "--out_dir", str(win_dir), "--sliding_window",
                 "--patch_size", "16"] + common) == 0
    a = load_nifti_vol(str(out_dir / outs[0]), resize=False)
    b = load_nifti_vol(str(win_dir / outs[0]), resize=False)
    np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-5)  # one patch, f32

    # resume: a new run dir named after the source run, epoch 2 only
    cfg3 = _config_file(tmp_path / "config3.json", epochs=3, checkpoint_iter=1,
                        adaptive_roi_weights=True)
    assert main(["train", "--config", cfg3, "--device", "cpu", "--splits_dir",
                 cohort["splits"], "--fold", "1", "-resume_training",
                 "-checkpoint_path", latest] + _tables(cohort)) == 0
    resumed = tmp_path / "results" / f"native_target_finetune_{run.name}"
    assert resumed.is_dir()
    assert [e["epoch"] for e in ploop.LAST_RUN["epochs"]] == [2]
    assert read_csv(str(resumed / "validation_metric_results" / "mae.csv")).columns \
        == ["epoch_2"]
    payload = torch.load(str(resumed / "checkpoints" / "checkpoint_epoch_2"),
                         weights_only=True)
    assert payload["epoch"] == 2 and payload["step"] == 6


def test_cross_validation_trains_every_fold(cohort, tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(ploop, "loss_graph", lambda *a, **k: None)
    monkeypatch.setattr(MetricRecorder, "plot", lambda self: None)
    cfg = _config_file(tmp_path / "config.json")
    assert main(["train", "--config", cfg, "--device", "cpu", "--splits_dir",
                 cohort["splits"], "-cross_val"] + _tables(cohort)) == 0
    run = next((tmp_path / "results").iterdir())
    for k in range(1, 6):
        assert (run / f"fold_{k}" / "checkpoints" / "checkpoint_latest_epoch").exists()
    assert "cross-val final MAPE per fold" in capsys.readouterr().out


def test_cuda_without_a_card_names_the_cpu(cohort, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tmp_path / "bf16.json"
    raw = json.loads(json.dumps(TINY))
    raw["model"]["compute_dtype"] = "bfloat16"
    cfg.write_text(json.dumps(raw))
    for cmd in (["train", "--splits_dir", cohort["splits"]],
                ["validate", "--test_lookup", cohort["lookup"]],
                ["infer", "--input_lookup", cohort["lookup"]]):
        with pytest.raises(RuntimeError, match="--device cpu"):
            main(cmd + ["--config", str(cfg)] + _tables(cohort))
    model = torch.nn.Linear(2, 2)
    with pytest.raises(RuntimeError, match="--device cpu"):
        ploop.train(model, None, [])


def _dtype_args(tmp_path, how, dtype):
    if how == "flag":
        return ["--compute_dtype", dtype]
    raw = json.loads(json.dumps(TINY))
    raw["model"]["compute_dtype"] = dtype
    raw["save_path"] = str(tmp_path / "results")
    path = tmp_path / f"{dtype}.json"
    path.write_text(json.dumps(raw))
    return ["--config", str(path)]


@pytest.mark.parametrize("how", ["flag", "config"])
def test_float16_on_cuda_exits_2_before_a_model(cohort, tmp_path, monkeypatch,
                                                capsys, how):
    import coma_unet_tpu_torch.models.contra as contra
    import coma_unet_tpu_torch.models.registry as registry

    def no_model(*a, **k):
        raise AssertionError("a model was built")

    monkeypatch.setattr(contra, "ContraAttnUNet", no_model)
    monkeypatch.setattr(registry, "build_model", no_model)
    args = _dtype_args(tmp_path, how, "float16")
    for cmd in (["train", "--splits_dir", cohort["splits"]],
                ["validate", "--test_lookup", cohort["lookup"]],
                ["infer", "--input_lookup", cohort["lookup"]]):
        assert main(cmd + args + ["--device", "cuda"] + _tables(cohort)) == 2
        err = capsys.readouterr().err
        assert "bfloat16" in err and "float32" in err and "--device cpu" in err


class _Built(Exception):
    pass


@pytest.mark.parametrize("how", ["flag", "config"])
def test_float32_on_cuda_builds_a_float32_model(cohort, tmp_path, monkeypatch,
                                                how):
    """Float32 on CUDA runs: each command builds its model in float32 on
    the card (the device and the builder patched: no card is here), with
    TF32 off in cuDNN and in matmul."""
    import coma_unet_tpu_torch.models.registry as registry

    built = []

    def build_model(model_type, cfg, device=None, generator=None):
        built.append((cfg.compute_dtype, torch.device(device),
                      torch.backends.cudnn.allow_tf32,
                      torch.backends.cuda.matmul.allow_tf32))
        raise _Built

    monkeypatch.setattr(ploop, "require_device", lambda d: torch.device(d))
    monkeypatch.setattr(registry, "build_model", build_model)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    args = _dtype_args(tmp_path, how, "float32")
    for cmd in (["train", "--splits_dir", cohort["splits"]],
                ["validate", "--test_lookup", cohort["lookup"]],
                ["infer", "--input_lookup", cohort["lookup"],
                 "--out_dir", str(tmp_path / "out")]):
        with pytest.raises(_Built):
            main(cmd + args + ["--device", "cuda"] + _tables(cohort))
    assert built == [("float32", torch.device("cuda"), False, False)] * 3


@pytest.mark.parametrize("cmd,flag,item", [
    ("train", "spatial_parallel", "queue 1 item 5"),
    ("infer", ["--spatial_parallel", "2"], "queue 1 item 5"),
    ("validate", ["-model_type", "UNET"], "queue 1 item 4"),
    ("train", ["--norm", "batch"], "queue 1 item 4"),
    ("infer", ["--spatial_parallel", "3"], "queue 1 item 5"),
])
def test_deferred_options_raise(cohort, tmp_path, monkeypatch, capsys, cmd,
                                flag, item):
    """The options that once waited on their ROADMAP.md item run. Queue 1
    item 5, spatial parallelism: `infer --spatial_parallel 2` (two gloo
    ranks, each on a depth slab) and 3 (slabs of 6, 4 and 6 planes) write
    the volumes that `infer` in one process writes, within 1e-5 of their
    max; a config's
    `train.spatial_parallel = 2` trains to the validation CSVs of the run
    without it, bit for bit, since the reference's spatial axis only
    replicates its step. Queue 1 item 4 (the baselines, batch norm): its
    cases run the command from the flags alone, the default ModelConfig and
    DataConfig shrunk to the test's widths and 16^3, and check what it
    writes."""
    extra = {"train": ["--splits_dir", cohort["splits"]],
             "validate": ["--test_lookup", cohort["lookup"]],
             "infer": ["--input_lookup", cohort["lookup"]]}[cmd]
    if item == "queue 1 item 5":
        monkeypatch.setattr(ploop, "loss_graph", lambda *a, **k: None)
        monkeypatch.setattr(MetricRecorder, "plot", lambda self: None)
        if cmd == "train":
            runs = [_train(cohort, _config_file(tmp_path / f"{tag}.json", **sp),
                           tmp_path / tag)
                    for tag, sp in (("plain", {}), ("sp", dict(spatial_parallel=2)))]
            for m in ("mae", "mape", "avg_corr", "roi_maes"):
                got, want = (read_csv(str(r / "validation_metric_results" / f"{m}.csv"))
                             for r in runs[::-1])
                assert got.columns == want.columns and got.rows() == want.rows(), m
            return
        cfg = _config_file(tmp_path / "config.json")
        vols = []
        for tag, sp in (("one", []), ("sp", flag)):
            out = tmp_path / tag
            assert main([cmd, "--config", cfg, "--device", "cpu", "--out_dir",
                         str(out)] + extra + sp + _tables(cohort)) == 0
            vols.append({p.name: load_nifti_vol(str(p))
                         for p in sorted(out.glob("*_synth_tau.nii"))})
        assert sorted(vols[1]) == sorted(vols[0]) and len(vols[0]) == 8
        for name, want in vols[0].items():
            err = float(np.abs(vols[1][name] - want).max())
            assert err <= 1e-5 * float(np.abs(want).max()), (name, err)
        return
    argv = ([cmd, "--device", "cpu", "--compute_dtype", "float32"] + extra
            + flag + _tables(cohort))
    import functools

    from coma_unet_tpu_torch import config as pconfig

    monkeypatch.setattr(pconfig, "ModelConfig", functools.partial(
        pconfig.ModelConfig, **{k: tuple(v) if isinstance(v, list) else v
                                for k, v in TINY["model"].items()
                                if k != "compute_dtype"}))
    monkeypatch.setattr(pconfig, "DataConfig", functools.partial(
        pconfig.DataConfig, volume_shape=(16, 16, 16)))
    monkeypatch.setattr(ploop, "loss_graph", lambda *a, **k: None)
    monkeypatch.setattr(MetricRecorder, "plot", lambda self: None)
    out = tmp_path / "out"
    run_args = ["--epochs", "1"] if cmd == "train" else []
    assert main(argv + run_args + ["-save_path", str(out)]) == 0
    if cmd == "validate":  # UNET, random weights: the metrics and matrices
        line = next(json.loads(s) for s in capsys.readouterr().out.splitlines()
                    if s.startswith('{"validate"'))
        assert line["validate"]["num_samples"] == 8
        assert (out / "pred_means.csv").exists()
        return
    (run,) = out.iterdir()  # the flagship with batch norm, one epoch
    assert json.loads((run / "config.json").read_text())["model"]["norm"] == "batch"
    payload = torch.load(str(run / "checkpoints" / "checkpoint_latest_epoch"),
                         weights_only=True)
    means = {k: v for k, v in payload["model"].items() if k.endswith("bnorm.mean")}
    assert means and all(bool(v.abs().max() > 0) for v in means.values())


def _train(cohort, cfg, save, extra=()):
    """`train` on fold 1 with `cfg`'s settings into `save`; its run dir."""
    assert main(["train", "--config", cfg, "--device", "cpu", "--splits_dir",
                 cohort["splits"], "--fold", "1", "-save_path", str(save)]
                + _tables(cohort) + list(extra)) == 0
    (run,) = save.iterdir()
    return run


def _tree(root):
    return sorted(str(p.relative_to(root)) for p in root.rglob("*"))


@pytest.fixture(scope="module")
def dp_runs(cohort, tmp_path_factory):
    """The same 2-epoch run at batch 4 in one process and over two gloo
    ranks (`--data_parallel 2`: 2 rows a rank). Neither draws its charts:
    the single-process run's are patched out, and the ranks, which start
    with this process's `sys.path`, find a `matplotlib` that does not
    import first, so that the recorder skips them as it does without
    matplotlib."""
    root = tmp_path_factory.mktemp("dp")
    cfg = _config_file(root / "config.json", batch_size=4, epochs=2,
                       checkpoint_iter=1, adaptive_roi_weights=True)
    shadow = root / "no_charts" / "matplotlib"
    shadow.mkdir(parents=True)
    (shadow / "__init__.py").write_text(
        "raise ImportError('no charts in this test')\n")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ploop, "loss_graph", lambda *a, **k: None)
        mp.setattr(MetricRecorder, "plot", lambda self: None)
        single = _train(cohort, cfg, root / "single")
        mp.syspath_prepend(str(shadow.parent))
        dp = _train(cohort, cfg, root / "dp", ["--data_parallel", "2"])
    return dict(root=root, cfg=cfg, single=single, dp=dp)


def test_data_parallel_train_matches_single_process(dp_runs):
    """`train --data_parallel 2` on the CPU: the validation metrics of both
    epochs within rtol 1e-3 / atol 1e-5 of the single-process run's, the
    adapted ROI weights and the step count in its checkpoint, and the run
    directory the single-process run writes (rank 0 writes it alone)."""
    single, dp = dp_runs["single"], dp_runs["dp"]
    for m in ("mae", "mape", "avg_corr", "roi_maes"):
        want = read_csv(str(single / "validation_metric_results" / f"{m}.csv"))
        got = read_csv(str(dp / "validation_metric_results" / f"{m}.csv"))
        assert got.columns == want.columns == ["epoch_0", "epoch_1"]
        for col in want.columns:
            np.testing.assert_allclose(got[col], want[col], rtol=1e-3, atol=1e-5,
                                       err_msg=f"{m} {col}")
    payloads = [torch.load(str(r / "checkpoints" / "checkpoint_latest_epoch"),
                           weights_only=True) for r in (single, dp)]
    assert payloads[0]["step"] == payloads[1]["step"] == 2
    np.testing.assert_allclose(payloads[1]["roi_weights"].numpy(),
                               payloads[0]["roi_weights"].numpy(), rtol=1e-3)
    assert not any(k.startswith("module.") for k in payloads[1]["model"])
    files = [f for f in _tree(dp) if not f.endswith(".png")]
    assert files == [f for f in _tree(single) if not f.endswith(".png")]


def test_data_parallel_validate_matches_validate(cohort, dp_runs, capsys):
    """`validate --data_parallel 2` from the data-parallel run's checkpoint
    prints the single-process `validate`'s metrics (8 subjects, 2 batches
    of 4), and only rank 0's lines."""
    latest = str(dp_runs["dp"] / "checkpoints" / "checkpoint_latest_epoch")
    lines = {}
    for tag, extra in (("single", []), ("dp", ["--data_parallel", "2"])):
        capsys.readouterr()
        assert main(["validate", "--config", dp_runs["cfg"], "--device", "cpu",
                     "--test_lookup", cohort["lookup"], "-checkpoint_path", latest,
                     "-save_path", str(dp_runs["root"] / f"val_{tag}")]
                    + _tables(cohort) + extra) == 0
        printed = capsys.readouterr().out
        assert printed.count("[overall] MAE=") == 1
        lines[tag] = next(json.loads(s) for s in printed.splitlines()
                          if s.startswith('{"validate"'))["validate"]
    assert lines["dp"]["num_samples"] == lines["single"]["num_samples"] == 8
    for key in ("mae", "mape", "avg_corr", "roi_maes", "roi_mapes"):
        np.testing.assert_allclose(lines["dp"][key], lines["single"][key],
                                   rtol=1e-3, atol=1e-5, err_msg=key)
    assert (dp_runs["root"] / "val_dp" / "pred_means.csv").exists()


def test_data_parallel_checkpoint_resumes_single_process(cohort, dp_runs,
                                                         monkeypatch):
    """A data-parallel run's checkpoint (the inner model's state dict, no
    prefix) resumes in a single-process `train`, at epoch 2 and step 2."""
    monkeypatch.setattr(ploop, "loss_graph", lambda *a, **k: None)
    monkeypatch.setattr(MetricRecorder, "plot", lambda self: None)
    cfg = _config_file(dp_runs["root"] / "config3.json", batch_size=4, epochs=3,
                       checkpoint_iter=1)
    latest = str(dp_runs["dp"] / "checkpoints" / "checkpoint_latest_epoch")
    run = _train(cohort, cfg, dp_runs["root"] / "resumed",
                 ["-resume_training", "-checkpoint_path", latest])
    assert run.name == f"native_target_finetune_{dp_runs['dp'].name}"
    assert [e["epoch"] for e in ploop.LAST_RUN["epochs"]] == [2]
    payload = torch.load(str(run / "checkpoints" / "checkpoint_epoch_2"),
                         weights_only=True)
    assert payload["epoch"] == 2 and payload["step"] == 3


@pytest.mark.parametrize("how", ["baseline", "attention", "uneven", "cards"])
def test_spatial_refusals_exit_2_before_writing(cohort, tmp_path, capsys,
                                               monkeypatch, how):
    """`infer --spatial_parallel` with a baseline (the reference's spatial
    forward passes with_projections=False, which none takes), with
    `--save_attention`, with 9 ranks (the deepest level's 8 planes cannot
    give each one; 3 ranks, uneven, run) or on CUDA
    beyond the visible cards (here none), and `train` with a config's
    `train.spatial_parallel` 2 on CUDA, exit with status 2 before any rank
    starts and before anything is written."""
    import importlib

    cli = importlib.import_module("coma_unet_tpu_torch.cli.main")
    monkeypatch.setattr(cli, "_launch", lambda *a, **k: pytest.fail("launched"))
    argv = ["infer", "--config", _config_file(tmp_path / "config.json"),
            "--input_lookup", cohort["lookup"], "--out_dir", str(tmp_path / "out"),
            "--spatial_parallel", "9" if how == "uneven" else "2"]
    device, why = ["--device", "cpu"], {
        "baseline": "ContraAttnUNET only", "attention": "--save_attention",
        "uneven": "level 1 holds 8 planes", "cards": "CUDA devices"}[how]
    if how == "baseline":
        argv += ["-model_type", "UNET"]
    elif how == "attention":
        argv += ["--save_attention"]
    elif how == "cards":
        raw = json.loads(json.dumps(TINY))
        raw["model"]["compute_dtype"] = "bfloat16"
        raw["train"]["spatial_parallel"] = 2
        raw["save_path"] = str(tmp_path / "results")
        (tmp_path / "bf16.json").write_text(json.dumps(raw))
        argv[2] = str(tmp_path / "bf16.json")
        device = ["--device", "cuda"]
        assert main(["train", "--config", argv[2], "--splits_dir",
                     cohort["splits"]] + device + _tables(cohort)) == 2
        assert why in capsys.readouterr().err
    assert main(argv + device + _tables(cohort)) == 2
    assert why in capsys.readouterr().err
    assert not (tmp_path / "out").exists() and not (tmp_path / "results").exists()


@pytest.mark.parametrize("how", ["batch", "cards"])
def test_data_parallel_refusals_exit_2_before_writing(cohort, tmp_path, capsys,
                                                      how):
    """`--data_parallel 2` with a batch of 3, or on CUDA beyond the visible
    cards (here none), exits with status 2 before anything is written."""
    if how == "batch":
        argv = ["--device", "cpu", "-batch_size", "3"]
    else:
        argv = ["--device", "cuda", "--compute_dtype", "bfloat16"]
    for cmd, extra in (("train", ["--splits_dir", cohort["splits"]]),
                       ("validate", ["--test_lookup", cohort["lookup"]])):
        assert main([cmd, "--data_parallel", "2", "-save_path",
                     str(tmp_path / "results")] + extra + argv
                    + _tables(cohort)) == 2
        err = capsys.readouterr().err
        assert ("divisible" if how == "batch" else "CUDA devices") in err
    assert not (tmp_path / "results").exists()


def test_a_failing_rank_fails_the_command(cohort, tmp_path, capsys):
    """A rank that raises (here: a training lookup that does not exist)
    ends the data-parallel run with status 1 and the rank's error."""
    cfg = _config_file(tmp_path / "config.json", batch_size=2)
    rc = main(["train", "--config", cfg, "--device", "cpu", "--data_parallel",
               "2", "--train_lookup", str(tmp_path / "missing.csv")]
              + _tables(cohort))
    assert rc == 1
    assert "missing.csv" in capsys.readouterr().err


def test_infer_with_data_parallel_runs_the_plain_forward(cohort, tmp_path):
    """`infer --data_parallel 2` synthesizes in this process, as the JAX
    CLI's `infer` does with `--spatial_parallel 1`."""
    cfg = _config_file(tmp_path / "config.json")
    out = tmp_path / "synth"
    assert main(["infer", "--config", cfg, "--device", "cpu", "--input_lookup",
                 cohort["lookup"], "--data_parallel", "2", "--out_dir", str(out)]
                + _tables(cohort)) == 0
    assert len(list(out.glob("*_synth_tau.nii"))) == 8


_REFUSE = """
import importlib.abc, importlib.machinery, sys
BANNED = {"jax", "jaxlib", "flax", "optax", "orbax", "pandas", "matplotlib",
          "coma_unet_tpu"}
class Refuse(importlib.abc.MetaPathFinder, importlib.abc.Loader):
    # a banned module is found, as if installed, and fails when imported
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BANNED:
            return importlib.machinery.ModuleSpec(name, self)
        return None
    def create_module(self, spec):
        raise ImportError(f"refused: {spec.name}")
    def exec_module(self, module):
        raise ImportError(f"refused: {module.__name__}")
sys.meta_path.insert(0, Refuse())
import gc
from coma_unet_tpu_torch.cli import main
from coma_unet_tpu_torch.models.contra import ContraAttnUNet
rc = main(sys.argv[1:])
assert not {m.split(".")[0] for m in sys.modules} & BANNED, sorted(sys.modules)
gc.collect()  # nothing keeps the run's model alive, not the chart latch
assert not [o for o in gc.get_objects() if isinstance(o, ContraAttnUNet)]
print("rc", rc)
"""


def test_train_runs_without_jax_pandas_or_matplotlib(cohort, tmp_path):
    rows = read_csv(cohort["lookup"]).rows()
    write_rows(str(tmp_path / "train.csv"), rows[:2])
    cfg = _config_file(tmp_path / "config.json")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-c", _REFUSE, "train", "--config", cfg, "--device", "cpu",
         "--train_lookup", str(tmp_path / "train.csv"), "--test_lookup_file",
         str(tmp_path / "train.csv")] + _tables(cohort),
        cwd=str(tmp_path), env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0 and "rc 0" in proc.stdout, proc.stderr[-3000:]
    assert "no charts (PNGs) are written" in proc.stderr
    run = next((tmp_path / "results").iterdir())
    assert (run / "checkpoints" / "checkpoint_latest_epoch").exists()
    assert not list(run.glob("*.png"))
