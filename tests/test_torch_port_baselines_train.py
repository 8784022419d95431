"""Training, evaluation and the CLI with the registry's baselines, on the
CPU at f32.

One train step of UNET with batch norm and one of AttnUNET against the JAX
package's `make_train_step` (the generative-only loss of a model without
projection heads): loss, gradients, post-AdamW parameters and, for batch
norm, the new `batch_stats`. The eval step and the sliding window with a
plain-output model against the JAX package's. Through the CLI with
`--device cpu`: `train`, `validate` and `infer` with `-model_type UNET`,
and AttnUNET with batch norm (the config's `"norm": "batch"`) through a
resume that reproduces the uninterrupted run, its checkpoint carrying the
running statistics, `validate` reproducing the run's CSV; `--save_attention`
on a baseline raises before anything is written. Shapes and parameters as
`tests/test_torch_port_baselines.py`; tolerances those of
`tests/test_torch_port_train.py`: loss 1e-5, gradients rtol 2e-3 / atol
5e-6 of the largest, parameters after AdamW rtol 2e-3 / atol 2e-5 where
the gradient carries signal, batch statistics 1e-5.
"""

import json
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from coma_unet_tpu.config import LossConfig as JaxLossConfig  # noqa: E402
from coma_unet_tpu.infer import sliding_window as jax_sw  # noqa: E402
from coma_unet_tpu.metrics import roi_metrics as jax_roi_metrics  # noqa: E402
from coma_unet_tpu.metrics import voxel_metrics as jax_voxel_metrics  # noqa: E402
from coma_unet_tpu.train import (  # noqa: E402
    create_train_state,
    make_eval_step as jax_make_eval_step,
    make_optimizer as jax_make_optimizer,
    make_train_step as jax_make_train_step,
)
from coma_unet_tpu_torch import LossConfig  # noqa: E402
from coma_unet_tpu_torch.cli import main  # noqa: E402
from coma_unet_tpu_torch.convert import from_flax  # noqa: E402
from coma_unet_tpu_torch.data.synthetic import make_synthetic_cohort  # noqa: E402
from coma_unet_tpu_torch.data.table import read_csv, write_rows  # noqa: E402
from coma_unet_tpu_torch.infer import (  # noqa: E402
    make_infer_fn,
    sliding_window_inference,
)
from coma_unet_tpu_torch.io import load_nifti_vol  # noqa: E402
from coma_unet_tpu_torch.train import (  # noqa: E402
    make_eval_step,
    make_optimizer,
    make_train_step,
)
import coma_unet_tpu_torch.train.loop as ploop  # noqa: E402
from coma_unet_tpu_torch.train.checkpoint import load_checkpoint  # noqa: E402
from coma_unet_tpu_torch.train.recorder import MetricRecorder  # noqa: E402
from test_torch_port_baselines import ARGS, _setup  # noqa: E402

R = 5
ROI_W = np.full((R,), 225.0, np.float32)
LOSS_TOL = 1e-5
GRAD_TOL = dict(rtol=2e-3, atol=5e-6)
PARAM_TOL = dict(rtol=2e-3, atol=2e-5)
STATS_TOL = dict(rtol=1e-5, atol=1e-5)


def _close(got, want, tol=LOSS_TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.all(np.abs(got - want) <= tol * np.maximum(1.0, np.abs(want))), (
        got, want)


def _step_run(name, seed, norm="instance"):
    """One JAX train step and one port train step from the same
    parameters on the same batch (`valid_mask` [1, 1])."""
    jm, pm, batch, inputs, variables = _setup(name, seed, norm=norm)
    batch = dict(batch, valid_mask=np.ones(2, np.float32))
    state = create_train_state(jm, jax_make_optimizer(1e-3),
                               jax.random.PRNGKey(0), inputs, {"train": True},
                               variables=variables)
    step = jax_make_train_step(jm, JaxLossConfig(), donate=False,
                               return_grads=True)
    new_state, aux = step(state, {k: jnp.asarray(v) for k, v in batch.items()},
                          jnp.asarray(ROI_W), jax.random.PRNGKey(1))
    port_step = make_train_step(pm, LossConfig(),
                                make_optimizer(pm.parameters(), 1e-3))
    metrics = port_step({k: torch.from_numpy(v) for k, v in batch.items()},
                        torch.from_numpy(ROI_W))
    return dict(port=pm, metrics=metrics, aux=jax.device_get(aux),
                params=jax.device_get(new_state.params),
                stats=jax.device_get(new_state.batch_stats),
                old_stats=variables.get("batch_stats"))


@pytest.fixture(scope="module")
def unet_bn():
    return _step_run("UNET", 40, norm="batch")


@pytest.fixture(scope="module")
def attn_unet():
    return _step_run("AttnUNET", 41)


def _check_step(run):
    pm, metrics, aux = run["port"], run["metrics"], run["aux"]
    for name in ("loss", "gen_loss", "pred_space_loss", "tcds_loss"):
        _close(metrics[name].numpy(), aux[name])
    assert float(metrics["pred_space_loss"]) == float(metrics["tcds_loss"]) == 0.0
    _close(metrics["grad_norm"].numpy(), aux["grad_norm"], tol=1e-4)
    stats = run["stats"] or None
    grads = from_flax(aux["grads"], pm, stats)
    gscale = max(1.0, max(float(g.abs().max()) for g in grads.values()))
    n_signal = 0
    want = from_flax(run["params"], pm, stats)
    for name, p in pm.named_parameters():
        assert p.grad is not None and bool(torch.isfinite(p.grad).all()), name
        np.testing.assert_allclose(p.grad.numpy(), grads[name].numpy(),
                                   rtol=GRAD_TOL["rtol"],
                                   atol=GRAD_TOL["atol"] * gscale,
                                   err_msg=f"grad {name}")
        signal = (grads[name].abs() > 1e-4 * gscale).numpy()
        if signal.any():
            n_signal += 1
            np.testing.assert_allclose(p.detach().numpy()[signal],
                                       want[name].numpy()[signal],
                                       **PARAM_TOL, err_msg=f"param {name}")
    assert n_signal >= 10


def test_unet_batch_norm_step_matches_jax(unet_bn):
    """The generative-only loss, every gradient and the post-AdamW
    parameters of UNET with batch norm."""
    _check_step(unet_bn)


def test_unet_batch_norm_step_updates_batch_stats_as_jax(unet_bn):
    pm = unet_bn["port"]
    want = from_flax(unet_bn["params"], pm, unet_bn["stats"])
    old = from_flax(unet_bn["params"], pm, unet_bn["old_stats"])
    keys = [k for k in want if k.endswith((".bnorm.mean", ".bnorm.var"))]
    assert len(keys) == 2 * sum(k.endswith(".bnorm.scale") for k in want) > 20
    for key in keys:
        got = pm.state_dict()[key]
        np.testing.assert_allclose(got.numpy(), want[key].numpy(),
                                   err_msg=key, **STATS_TOL)
        assert not torch.equal(got, old[key]), key


def test_attn_unet_step_matches_jax(attn_unet):
    """AttnUNET (the flagship's backbone, CondConv and FiLM, no heads):
    loss, gradients and parameters after AdamW."""
    _check_step(attn_unet)


@pytest.mark.parametrize("norm", ["instance", "batch"])
def test_eval_step_with_a_plain_model_matches_jax(norm):
    """`make_eval_step` of UNET against the JAX eval step: pred and every
    metric; with batch norm the running statistics serve and stay as they
    are. The JAX eval step cannot run a batch-norm model (its `apply` with
    `mutable=[]` returns an (output, state) pair, which it takes for the
    output), so there the reference is `apply(train=False)` and the JAX
    metric functions, which are what its eval step computes."""
    jm, pm, batch, inputs, variables = _setup("UNET", 42, norm=norm)
    if norm == "instance":
        state = create_train_state(jm, jax_make_optimizer(1e-3),
                                   jax.random.PRNGKey(0), inputs,
                                   {"train": False}, variables=variables)
        jpred, jvox, jroi = jax.device_get(jax_make_eval_step(jm, R)(
            state, {k: jnp.asarray(v) for k, v in batch.items()}))
    else:
        jpred = jax.jit(lambda v: jm.apply(v, *inputs, train=False))(variables)
        tau = jnp.asarray(batch["tau"])
        jvox = jax.device_get(jax_voxel_metrics(jpred, tau))
        jroi = jax.device_get(jax_roi_metrics(
            jpred, tau, jnp.asarray(batch["roi_compact"]), R))
    before = {k: v.clone() for k, v in pm.state_dict().items()}
    pred, vox, roi = make_eval_step(pm, R)(batch)
    np.testing.assert_allclose(pred.numpy(), np.asarray(jpred), rtol=1e-4,
                               atol=1e-4)
    # the metrics against the JAX functions on the same pred at 1e-5, and
    # against the reference's own at 1e-4 (except `abs_rel_vol`, which a
    # 1e-6 difference of pred moves by more where |tau| is small)
    p, tau = jnp.asarray(pred.numpy()), jnp.asarray(batch["tau"])
    same = (jax_voxel_metrics(p, tau),
            jax_roi_metrics(p, tau, jnp.asarray(batch["roi_compact"]), R))
    for got, want, own in ((vox, same[0], jvox), (roi, same[1], jroi)):
        assert set(got) == set(want) == set(own)
        for key in want:
            np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                       rtol=1e-5, atol=1e-6, err_msg=key)
            if key != "abs_rel_vol":
                np.testing.assert_allclose(got[key].numpy(), own[key],
                                           rtol=1e-4, atol=1e-4, err_msg=key)
    for key, value in pm.state_dict().items():
        assert torch.equal(value, before[key]), key


def test_sliding_window_with_a_plain_model_matches_jax():
    jm, pm, _, _, variables = _setup("GenAttnUnet", 43)
    from test_torch_port_baselines import _batch

    vol = _batch(np.random.default_rng(44), 20, b=1)
    kw = dict(patch_size=(16, 16, 16), overlap=0.25, batch_size=4)
    infer = jax.jit(lambda v, *a: jm.apply(v, *a, train=False))
    want = jax_sw.sliding_window_inference(infer, variables,
                                           *(vol[k] for k in ARGS), **kw)
    got = sliding_window_inference(make_infer_fn(pm.eval()),
                                   *(vol[k] for k in ARGS), **kw)
    assert got.shape == (1, 1, 20, 20, 20)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


# --- through the CLI -------------------------------------------------------

TINY = {
    "model": {"channels": [4, 8], "strides": [2, 2], "latent_spaces": [16, 16],
              "prompt_shape": [16, 16, 16], "num_experts": 2,
              "compute_dtype": "float32"},
    "train": {"epochs": 1, "batch_size": 2, "val_iter": 1,
              "checkpoint_iter": 1, "adaptive_roi_weights": True},
    "data": {"volume_shape": [16, 16, 16]},
}


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    root = tmp_path_factory.mktemp("baselines_cli")
    c = make_synthetic_cohort(str(root / "cohort"))
    rows = read_csv(c["lookup"]).rows()
    splits = root / "splits"
    splits.mkdir()
    write_rows(str(splits / "training_lookup_1.csv"), rows[:4])
    write_rows(str(splits / "test_lookup_1.csv"), rows[4:6])
    c["splits"], c["test"] = str(splits), str(splits / "test_lookup_1.csv")
    return c


def _config(path, epochs=1, norm="instance", results="results"):
    raw = json.loads(json.dumps(TINY))
    raw["model"]["norm"] = norm
    raw["train"]["epochs"] = epochs
    raw["save_path"] = str(path.parent / results)
    path.write_text(json.dumps(raw))
    return str(path)


def _common(cohort, cfg, model_type):
    return ["--config", cfg, "--device", "cpu", "-model_type", model_type,
            "--covariate_csv", cohort["cov"], "--quartile_csv", cohort["quart"],
            "--predictions_json", cohort["preds"]]


def _validate_matches_csv(cohort, common, ckpt, run, epoch, out, capsys):
    capsys.readouterr()
    assert main(["validate", "--test_lookup", cohort["test"], "-checkpoint_path",
                 ckpt, "-save_path", str(out)] + common) == 0
    line = next(json.loads(s) for s in capsys.readouterr().out.splitlines()
                if s.startswith('{"validate"'))["validate"]
    assert line["num_samples"] == 2
    for key in ("mae", "mape", "avg_corr", "roi_maes", "roi_mapes"):
        want = read_csv(str(run / "validation_metric_results" / f"{key}.csv"))[
            f"epoch_{epoch}"]
        np.testing.assert_allclose(np.atleast_1d(line[key]), want, rtol=1e-12,
                                   atol=0, err_msg=key)


def test_unet_train_validate_infer_through_the_cli(cohort, tmp_path, capsys):
    cfg = _config(tmp_path / "unet.json")
    common = _common(cohort, cfg, "UNET")
    assert main(["train", "--splits_dir", cohort["splits"], "--fold", "1"]
                + common) == 0
    (run,) = (tmp_path / "results").iterdir()
    assert (run / "train_UNET.log").exists()
    assert json.loads((run / "config.json").read_text())["model_type"] == "UNET"
    ckpt = run / "checkpoints" / "checkpoint_latest_epoch"
    payload = load_checkpoint(str(ckpt))
    assert "head.conv0.kernel" in payload["model"] and payload["step"] == 2
    _validate_matches_csv(cohort, common, str(ckpt), run, 0, tmp_path / "val",
                          capsys)
    out_dir = tmp_path / "synth"
    assert main(["infer", "--input_lookup", cohort["lookup"], "-checkpoint_path",
                 str(ckpt), "--out_dir", str(out_dir)] + common) == 0
    outs = sorted(os.listdir(str(out_dir)))
    assert len(outs) == 8 and all(o.endswith("_synth_tau.nii") for o in outs)
    vol = load_nifti_vol(str(out_dir / outs[0]), resize=False)
    assert vol.shape == (1, 16, 16, 16) and np.isfinite(vol).all()
    attn_dir = tmp_path / "attn"
    with pytest.raises(ValueError, match="attention"):
        main(["infer", "--input_lookup", cohort["lookup"], "--out_dir",
              str(attn_dir), "--save_attention"] + common)
    assert not attn_dir.exists()


def test_attn_unet_batch_norm_resume_through_the_cli(cohort, tmp_path, capsys,
                                                     monkeypatch):
    """AttnUNET with batch norm: 2 epochs then a resumed third give the
    checkpoint of 3 uninterrupted epochs, parameters and running
    statistics bit for bit; the running statistics move and `validate`
    from the resumed run's checkpoint reproduces its CSV (charts off)."""
    monkeypatch.setattr(ploop, "loss_graph", lambda *a, **k: None)
    monkeypatch.setattr(MetricRecorder, "plot", lambda self: None)
    full_cfg = _config(tmp_path / "full.json", epochs=3, norm="batch",
                       results="full")
    assert main(["train", "--splits_dir", cohort["splits"], "--fold", "1"]
                + _common(cohort, full_cfg, "AttnUNET")) == 0
    (full_run,) = (tmp_path / "full").iterdir()
    full = load_checkpoint(str(full_run / "checkpoints" / "checkpoint_epoch_2"))

    cfg2 = _config(tmp_path / "two.json", epochs=2, norm="batch")
    cfg3 = _config(tmp_path / "three.json", epochs=3, norm="batch")
    assert main(["train", "--splits_dir", cohort["splits"], "--fold", "1"]
                + _common(cohort, cfg2, "AttnUNET")) == 0
    (run,) = (tmp_path / "results").iterdir()
    first = load_checkpoint(str(run / "checkpoints" / "checkpoint_epoch_0"))
    latest = str(run / "checkpoints" / "checkpoint_latest_epoch")
    assert main(["train", "--splits_dir", cohort["splits"], "--fold", "1",
                 "-resume_training", "-checkpoint_path", latest]
                + _common(cohort, cfg3, "AttnUNET")) == 0
    resumed = tmp_path / "results" / f"native_target_finetune_{run.name}"
    ckpt = resumed / "checkpoints" / "checkpoint_epoch_2"
    payload = load_checkpoint(str(ckpt))
    assert payload["epoch"] == 2 and payload["step"] == full["step"] == 6
    stats = [k for k in payload["model"] if k.endswith((".bnorm.mean",
                                                        ".bnorm.var"))]
    # 9 batch norms: head and down0 two each, up0, gate0's three, merge0
    assert len(stats) == 18
    assert not any("num_batches" in k for k in payload["model"])
    assert set(payload["model"]) == set(full["model"])
    for key, value in payload["model"].items():
        assert torch.equal(value, full["model"][key]), key
    for key in stats:  # the running statistics moved over the epochs
        assert not torch.equal(payload["model"][key], first["model"][key]), key
    _validate_matches_csv(cohort, _common(cohort, cfg3, "AttnUNET"), str(ckpt),
                          resumed, 2, tmp_path / "val", capsys)
