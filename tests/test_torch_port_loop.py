"""The port's training loop (`coma_unet_tpu_torch/train/loop.py`), its
checkpoints and its recorder against the JAX package's `train`, on the CPU
at f32.

Both loops train a `tiny_model_config`-sized ContraAttnUNet (channels
(4, 8, 16), 4 experts, 16^3) on the same synthetic cohort: 4 subjects in
2 shuffled batches an epoch, validation on 4 others every epoch, a
checkpoint every epoch. The port starts from the JAX loop's initial
parameters (the flax init, bridged by `from_flax`). The JAX loop runs 3
epochs; the port runs 2, then resumes from `checkpoint_latest_epoch` for the
third. Compared: every step's loss (rel 1e-5), each epoch's average loss,
every validation CSV, the adapted ROI weights and the ROI-mean matrices
(rel 1e-4; the correlations, which lie in [-1, 1], abs 1e-4), the
parameters of `checkpoint_epoch_1` and `_2` against the Orbax ones (rtol
2e-3 / atol 2e-5, as `test_torch_port_train.py`, and each leaf within 15 %
of its movement since the start), the epoch, step and scheduler state.
Gradient accumulation (`grad_acc` = 2) is held to `optax.MultiSteps` over
4 micro-batches.

The learning rate is 1e-5. AdamW moves each element by about lr along the
sign of its gradient, and where a gradient sits at f32 noise the two sides
take opposite signs: at the default 1e-3 that noise alone moves the
validation MAPE by 1.4e-2 after two epochs. At 1e-5 it moves the parameters
100x less, while one AdamW step still moves a step's loss by about 1e-4
relative, 100x the gap between the two loops, so a step left out or taken
twice shows. The charts are not compared, and are switched off on both
sides to keep the file's time down.
"""

import dataclasses
import math
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import coma_unet_tpu.config as jconfig  # noqa: E402
import coma_unet_tpu.train.loop as jloop  # noqa: E402
from coma_unet_tpu import data as jdata  # noqa: E402
from coma_unet_tpu.losses import roi_losses as j_roi_losses  # noqa: E402
from coma_unet_tpu.losses.roi_losses import update_roi_weights as j_update  # noqa: E402
from coma_unet_tpu.models import ContraAttnUNet as FlaxContra  # noqa: E402
from coma_unet_tpu.train import make_optimizer as j_make_optimizer  # noqa: E402
from coma_unet_tpu.train import make_eval_step as j_make_eval_step  # noqa: E402
from coma_unet_tpu.train import make_train_step as j_make_train_step  # noqa: E402
from coma_unet_tpu.train.checkpoint import CheckpointManager as JCheckpoints  # noqa: E402
from coma_unet_tpu.train.optim import ReduceLROnPlateau as JPlateau  # noqa: E402
from coma_unet_tpu.train.recorder import MetricRecorder as JRecorder  # noqa: E402
from coma_unet_tpu.train.state import create_train_state as j_create_state  # noqa: E402

import coma_unet_tpu_torch.config as pconfig  # noqa: E402
from coma_unet_tpu_torch import losses as p_losses  # noqa: E402
import coma_unet_tpu_torch.train.loop as ploop  # noqa: E402
from coma_unet_tpu_torch import ContraAttnUNet  # noqa: E402
from coma_unet_tpu_torch import data as pdata  # noqa: E402
from coma_unet_tpu_torch.convert import from_flax  # noqa: E402
from coma_unet_tpu_torch.data.synthetic import make_synthetic_cohort  # noqa: E402
from coma_unet_tpu_torch.data.table import read_csv, write_rows  # noqa: E402
from coma_unet_tpu_torch.train import (  # noqa: E402
    MultiSteps,
    create_train_state,
    make_train_step,
)
from coma_unet_tpu_torch.train.checkpoint import (  # noqa: E402
    CheckpointManager,
    load_checkpoint,
)
from coma_unet_tpu_torch.train.recorder import MetricRecorder as PRecorder  # noqa: E402
from jax_fast import fast  # noqa: E402

S = 16
MODEL = dict(channels=(4, 8, 16), strides=(2, 2, 2), latent_spaces=(32,) * 3,
             prompt_shape=(S, S, S), num_experts=4, compute_dtype="float32",
             pallas_convs=False, packed_level=False, remat=False)
ARGS = ("mri", "covars", "roi_loc", "roi_std", "roi_compact")
R = len(jconfig.ROI_INDICES)
LR = 1e-5
STEP_TOL, LOSS_TOL, CSV_TOL, CORR_ATOL = 1e-5, 1e-4, 1e-4, 1e-4
PARAM_TOL = dict(rtol=2e-3, atol=2e-5)
MOVE_TOL = 0.15


def _config(mod, epochs, grad_acc=1):
    return mod.ExperimentConfig(
        model=mod.ModelConfig(**MODEL),
        loss=mod.LossConfig(cds_weights=(0.0, 1.0, 4.0)),
        train=mod.TrainConfig(epochs=epochs, val_iter=1, checkpoint_iter=1,
                              grad_acc=grad_acc, lr=LR),
        data=mod.DataConfig(volume_shape=(S, S, S)))


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    root = tmp_path_factory.mktemp("loop")
    c = make_synthetic_cohort(str(root / "cohort"))
    rows = read_csv(c["lookup"]).rows()
    c["train"], c["test"] = str(root / "train.csv"), str(root / "test.csv")
    write_rows(c["train"], rows[:4])
    write_rows(c["test"], rows[4:])
    c["out"] = str(root)
    return c


def _loaders(cohort, port, train_csv=None, shuffle=True):
    d = pdata if port else jdata
    if port:
        cov = d.CovariateTable(cohort["cov"])
        quart, preds = d.QuartileTable(cohort["quart"]), d.PredictionTable(cohort["preds"])
    else:
        from coma_unet_tpu.data.covariates import QuartileTable

        cov, quart = d.CovariateTable(cohort["cov"]), QuartileTable(cohort["quart"])
        preds = d.PredictionTable(cohort["preds"])

    def loader(csv, shuffle):
        ds = d.PredictedMetaTauDataset(csv, cov, quart, meta_tau_table=preds,
                                       pad_dims=(S, S, S))
        return d.DataLoader(ds, 2, predictions=preds, shuffle=shuffle,
                            num_workers=2)

    return loader(train_csv or cohort["train"], shuffle), loader(cohort["test"], False)


@pytest.fixture(scope="module")
def variables():
    """The JAX loop's initial variables: the flax init at PRNGKey(seed) on
    batch-shaped inputs (jitted: the eager init takes minutes)."""
    example = (np.zeros((2, 1, S, S, S), np.float32), np.zeros((2, 6), np.float32),
               np.zeros((2, R), np.float32), np.zeros((2, R), np.float32),
               np.zeros((2, S, S, S), np.int32))
    model = FlaxContra(jconfig.ModelConfig(**MODEL))
    init = fast(jax.jit(lambda key, *a: model.init(key, *a, train=True)))
    return jax.device_get(init(jax.random.PRNGKey(0), *example))


def _no_charts(mp):
    noop = lambda *a, **k: None  # noqa: E731
    for mod, rec in ((jloop, JRecorder), (ploop, PRecorder)):
        mp.setattr(mod, "loss_graph", noop)
        mp.setattr(rec, "plot", noop)


@pytest.fixture(scope="module")
def jax_run(cohort, variables):
    """Three epochs of the JAX loop; the loss of every step."""
    model = FlaxContra(jconfig.ModelConfig(**MODEL))
    cfg = _config(jconfig, epochs=3)
    losses = []
    base = fast(j_make_train_step(model, cfg.loss, donate=True))

    def step(state, batch, roi_w, rng, *rest):
        state, aux = base(state, batch, roi_w, rng, *rest)
        losses.append(float(aux["loss"]))
        return state, aux

    def create_state(model, tx, rng, example, kwargs=None, variables=None):
        return j_create_state(model, tx, rng, example, kwargs,
                              variables=VARIABLES[0])

    VARIABLES = [variables]
    save = os.path.join(cohort["out"], "jax")
    train_loader, val_loader = _loaders(cohort, port=False)
    with pytest.MonkeyPatch.context() as mp:
        _no_charts(mp)
        mp.setattr(jloop, "create_train_state", create_state)
        jloop.train(model, cfg, train_loader, val_loader=val_loader,
                    save_path=save, train_step=step,
                    eval_step=fast(j_make_eval_step(model, R)))
    template = j_create_state(model, j_make_optimizer(cfg.train.lr),
                              jax.random.PRNGKey(0), None, variables=variables)
    ckpts = {}
    for e in range(3):
        sched = JPlateau()
        state, epoch, loss = JCheckpoints(save).restore(
            template, os.path.join(save, "checkpoints", f"checkpoint_epoch_{e}"),
            sched)
        ckpts[e] = dict(params=jax.device_get(state.params), epoch=epoch,
                        loss=loss, step=int(state.step), scheduler=sched.state_dict())
    return dict(save=save, losses=losses, ckpts=ckpts)


@pytest.fixture(scope="module")
def port_run(cohort, variables):
    """Two epochs of the port's loop, then a resume for the third."""
    cfg2, cfg3 = _config(pconfig, epochs=2), _config(pconfig, epochs=3)
    first = os.path.join(cohort["out"], "port")
    resumed = os.path.join(cohort["out"], "port_resumed")
    with pytest.MonkeyPatch.context() as mp:
        _no_charts(mp)
        model = ContraAttnUNet(cfg2.model, device="cpu")
        model.load_state_dict(from_flax(variables["params"], model))
        train_loader, val_loader = _loaders(cohort, port=True)
        state = ploop.train(model, cfg2, train_loader, val_loader=val_loader,
                            save_path=first, device="cpu")
        run1 = dict(ploop.LAST_RUN)
        latest = os.path.join(first, "checkpoints", "checkpoint_latest_epoch")
        fresh = ContraAttnUNet(cfg3.model, device="cpu",
                               generator=torch.Generator().manual_seed(7))
        train_loader, val_loader = _loaders(cohort, port=True)
        resumed_state = ploop.train(fresh, cfg3, train_loader, val_loader=val_loader,
                                    save_path=resumed, resume_from=latest,
                                    device="cpu")
        run2 = dict(ploop.LAST_RUN)
    return dict(first=first, resumed=resumed, run1=run1, run2=run2,
                steps=(state.step, resumed_state.step))


def _rel_close(got, want, tol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    assert (np.isnan(got) == np.isnan(want)).all(), (what, got, want)
    ok = ~np.isnan(want)
    err = np.abs(got[ok] - want[ok])
    assert (err <= tol * np.maximum(np.abs(want[ok]), 1e-6)).all(), (
        what, float((err / np.maximum(np.abs(want[ok]), 1e-6)).max()))


def test_step_losses_match_jax(jax_run, port_run):
    got = [l for e in port_run["run1"]["epochs"] + port_run["run2"]["epochs"]
           for l in e["losses"]]
    assert len(got) == len(jax_run["losses"]) == 6
    _rel_close(got, jax_run["losses"], STEP_TOL, "step losses")


@pytest.mark.parametrize("epoch", [0, 1, 2])
def test_epoch_losses_match_jax(jax_run, port_run, epoch):
    run = port_run["first" if epoch < 2 else "resumed"]
    payload = load_checkpoint(os.path.join(run, "checkpoints",
                                           f"checkpoint_epoch_{epoch}"))
    want = jax_run["ckpts"][epoch]
    _rel_close(payload["loss"], want["loss"], LOSS_TOL, f"epoch {epoch}")
    assert payload["epoch"] == want["epoch"] == epoch
    assert payload["step"] == want["step"] == 2 * (epoch + 1)
    records = port_run["run1"]["epochs"] + port_run["run2"]["epochs"]
    assert records[epoch]["epoch"] == epoch
    assert records[epoch]["loss"] == payload["loss"]


def _csvs(root):
    out = {}
    for sub in ("", "pos_metrics", "neg_metrics"):
        d = os.path.join(root, sub, "validation_metric_results")
        for name in sorted(os.listdir(d)):
            out[os.path.join(sub, name)] = read_csv(os.path.join(d, name))
    return out


def test_validation_csvs_match_jax(jax_run, port_run):
    want, got, resumed = (_csvs(jax_run["save"]), _csvs(port_run["first"]),
                          _csvs(port_run["resumed"]))
    assert set(got) == set(want) == set(resumed) and len(want) == 24
    for name, table in want.items():
        assert table.columns == ["epoch_0", "epoch_1", "epoch_2"], name
        assert got[name].columns == ["epoch_0", "epoch_1"], name
        assert resumed[name].columns == ["epoch_2"], name
        for col in table.columns:
            mine = (resumed if col == "epoch_2" else got)[name][col]
            if "corr" in name:
                np.testing.assert_allclose(mine, table[col], rtol=0,
                                           atol=CORR_ATOL, err_msg=name)
            else:
                _rel_close(mine, table[col], CSV_TOL, f"{name} {col}")


def test_adapted_roi_weights_match_jax(jax_run, port_run):
    """The JAX loop's weights, rebuilt from its roi_mapes.csv with its own
    `update_roi_weights`, against the ones the port's checkpoints carry."""
    mapes = read_csv(os.path.join(jax_run["save"], "validation_metric_results",
                                  "roi_mapes.csv"))
    want = jnp.full((R,), 225.0, jnp.float32)
    for epoch in range(3):
        errors = jnp.asarray(np.asarray(mapes[f"epoch_{epoch}"]) / 100.0,
                             jnp.float32)
        want = j_update(want, errors, 360.0)
        run = port_run["first" if epoch < 2 else "resumed"]
        got = load_checkpoint(os.path.join(run, "checkpoints",
                                           f"checkpoint_epoch_{epoch}"))["roi_weights"]
        _rel_close(got.numpy(), np.asarray(want), LOSS_TOL, f"weights {epoch}")
    assert float(np.asarray(want).std()) > 0.0


def test_roi_mean_matrices_and_samples_match_jax(jax_run, port_run):
    for epoch in (0, 1, 2):
        sub = f"{epoch}_output_samples"
        jdir = os.path.join(jax_run["save"], sub)
        pdir = os.path.join(port_run["first" if epoch < 2 else "resumed"], sub)
        names = sorted(os.listdir(jdir))
        assert names == sorted(os.listdir(pdir))
        assert sum(n.endswith("_pred.nii") for n in names) == 2
        for name in names:
            if name.endswith(".csv"):
                want, got = read_csv(os.path.join(jdir, name)), read_csv(os.path.join(pdir, name))
                assert got.columns == want.columns, name
                for col in want.columns:
                    _rel_close(got[col], want[col], CSV_TOL, f"{sub}/{name}")
            else:
                from coma_unet_tpu_torch.io import read_nifti

                a, b = read_nifti(os.path.join(pdir, name)), read_nifti(os.path.join(jdir, name))
                tol = 0 if name.endswith("_gt.nii") else CSV_TOL
                np.testing.assert_allclose(a.data, b.data, rtol=tol,
                                           atol=tol * float(np.abs(b.data).max()))


def _zero_gradient(model):
    """Parameters whose true gradient is 0 here: the conv biases that feed
    an instance norm (the norm removes any shift), and the projection heads,
    which only RnC reads and RnC is identically 0 at b=2. AdamW moves the
    first by the sign of f32 noise on each side; optax decays the heads
    with no gradient, torch leaves them."""
    from coma_unet_tpu_torch.models.blocks import CondConvolution, Convolution

    biases = {f"{name}.bias" for name, m in model.named_modules()
              if isinstance(m, (Convolution, CondConvolution)) and not m.conv_only
              and m.norm.kind == "instance" and m.bias is not None}
    heads = {name for name, _ in model.named_parameters()
             if name.startswith(("proj", "final_proj"))}
    return biases | heads


def _check_params(got, want, init, model):
    skip = _zero_gradient(model)
    assert set(got) == set(want) and skip
    for name, value in got.items():
        if name in skip:
            continue
        a, b = value.numpy(), want[name].numpy()
        np.testing.assert_allclose(a, b, **PARAM_TOL, err_msg=name)
        moved = np.linalg.norm(b - init[name].numpy())
        assert np.linalg.norm(a - b) <= MOVE_TOL * moved, name


@pytest.mark.parametrize("epoch", [1, 2])
def test_checkpoint_params_match_jax(jax_run, port_run, variables, epoch):
    run = port_run["first" if epoch < 2 else "resumed"]
    payload = load_checkpoint(os.path.join(run, "checkpoints",
                                           f"checkpoint_epoch_{epoch}"))
    want = jax_run["ckpts"][epoch]
    model = ContraAttnUNet(pconfig.ModelConfig(**MODEL), device="cpu")
    _check_params(payload["model"], from_flax(want["params"], model),
                  from_flax(variables["params"], model), model)
    sched = payload["scheduler"]
    assert set(sched) == set(want["scheduler"])
    for k, v in want["scheduler"].items():
        tol = LOSS_TOL if k == "best" else 0.0
        assert math.isclose(sched[k], v, rel_tol=tol), (k, sched[k], v)
    assert payload["step"] == want["step"] == 2 * (epoch + 1)


def test_resume_restores_the_checkpoint(port_run):
    """The resumed run started at epoch 2 from the saved state: its restore
    gives parameters bit-identical to the checkpoint's, and the step count
    goes on 4 -> 6."""
    assert port_run["steps"] == (4, 6)
    assert [e["epoch"] for e in port_run["run2"]["epochs"]] == [2]
    assert port_run["run2"]["restore_s"] > 0.0
    path = os.path.join(port_run["first"], "checkpoints", "checkpoint_latest_epoch")
    payload = load_checkpoint(path)
    model = ContraAttnUNet(pconfig.ModelConfig(**MODEL), device="cpu",
                           generator=torch.Generator().manual_seed(3))
    state = create_train_state(model, 1e-3)
    state, epoch, loss = CheckpointManager(port_run["first"]).restore(state, path)
    assert epoch == 1 and loss == payload["loss"] and state.step == 4
    for name, value in model.state_dict().items():
        assert torch.equal(value, payload["model"][name]), name
    optim = state.optimizer.state_dict()
    for key, saved in payload["optimizer"]["state"].items():
        for k, v in saved.items():
            assert torch.equal(optim["state"][key][k], v)


def _batches(cohort):
    loader, _ = _loaders(cohort, port=False, train_csv=cohort["lookup"],
                         shuffle=False)
    return [{k: np.asarray(b[k]) for k in ARGS + ("tau",)} for b in loader]


def test_grad_acc_matches_optax_multisteps(cohort, variables):
    """grad_acc = 2 over 4 micro-batches: the JAX step with
    `optax.MultiSteps` and the port's with `MultiSteps` give the same
    parameters; both count 4 steps (flax's count), and the port's AdamW has
    stepped twice."""
    batches = _batches(cohort)
    assert len(batches) == 4
    cfg = _config(jconfig, epochs=1, grad_acc=2)
    model = FlaxContra(cfg.model)
    state = j_create_state(model, j_make_optimizer(LR, grad_acc=2),
                           jax.random.PRNGKey(0), None, variables=variables)
    step = fast(j_make_train_step(model, cfg.loss, donate=False))
    roi_w = jnp.full((R,), 225.0, jnp.float32)
    for b in batches:
        state, _ = step(state, {k: jnp.asarray(v) for k, v in b.items()}, roi_w,
                        jax.random.PRNGKey(1))
    assert int(state.step) == 4

    port = ContraAttnUNet(pconfig.ModelConfig(**MODEL), device="cpu")
    port.load_state_dict(from_flax(variables["params"], port))
    pstate = create_train_state(port, LR, grad_acc=2)
    assert isinstance(pstate.optimizer, MultiSteps)
    pstep = make_train_step(port, pconfig.LossConfig(cds_weights=(0.0, 1.0, 4.0)),
                            pstate.optimizer)
    for i, b in enumerate(batches):
        pstep({k: torch.from_numpy(v) for k, v in b.items()}, torch.full((R,), 225.0))
        assert pstate.step == i + 1
    assert pstate.optimizer.mini_step == 0
    assert max(int(s["step"]) for s in pstate.optimizer.state.values()) == 2
    _check_params(port.state_dict(), from_flax(jax.device_get(state.params), port),
                  from_flax(variables["params"], port), port)


def test_multisteps_matches_optax_over_sgd():
    """`MultiSteps` over plain SGD against `optax.MultiSteps(optax.sgd)`:
    the running mean of k micro-batch gradients (a missing gradient read as
    0), one inner step every k-th call, nothing in between."""
    import optax

    rng = np.random.default_rng(8)
    w0 = rng.normal(size=(3, 4)).astype(np.float32)
    grads = [rng.normal(size=(3, 4)).astype(np.float32) for _ in range(7)]
    tx = optax.MultiSteps(optax.sgd(0.5), every_k_schedule=3)
    params = jnp.asarray(w0)
    opt_state = tx.init(params)
    p = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    opt = MultiSteps(torch.optim.SGD([p], lr=0.5), 3)
    for i, g in enumerate(grads):
        missing = i == 4
        updates, opt_state = tx.update(jnp.zeros_like(params) if missing
                                       else jnp.asarray(g), opt_state, params)
        params = optax.apply_updates(params, updates)
        p.grad = None if missing else torch.from_numpy(g.copy())
        opt.step()
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(params),
                                   rtol=1e-6, atol=1e-7, err_msg=f"call {i}")
        assert opt.mini_step == int(opt_state.mini_step)
    assert not np.allclose(np.asarray(params), w0)


def test_multisteps_state_round_trips_mid_accumulation(tmp_path):
    """A checkpoint taken between micro-batches carries the accumulated
    mean and the mini-step: resuming from it gives the uninterrupted
    parameters bit for bit, and the flax step count."""
    def run(stop=None, resume=None):
        torch.manual_seed(0)
        model = torch.nn.Sequential(torch.nn.Linear(3, 4), torch.nn.Linear(4, 1))
        state = create_train_state(model, 1e-2, grad_acc=3)
        if resume:
            state.optimizer.load_state_dict(resume["optimizer"])
            model.load_state_dict(resume["model"])
        xs = torch.randn(7, 5, 3, generator=torch.Generator().manual_seed(1))
        start = 0 if resume is None else resume["step"]
        for i in range(start, 7):
            state.optimizer.zero_grad(set_to_none=True)
            # the second layer gets no gradient on odd micro-batches
            out = model(xs[i]) if i % 2 == 0 else model[0](xs[i])
            out.square().mean().backward()
            state.optimizer.step()
            if stop is not None and i + 1 == stop:
                mgr = CheckpointManager(str(tmp_path))
                return load_checkpoint(mgr.save(state, 0, 0.0, tag="mid"))
        return model, state

    full_model, full_state = run()
    assert full_state.step == 7 and full_state.optimizer.mini_step == 1
    mid = run(stop=4)
    assert mid["step"] == 4 and mid["optimizer"]["mini_step"] == 1
    model, state = run(resume=mid)
    assert state.step == 7
    for a, b in zip(model.parameters(), full_model.parameters()):
        assert torch.equal(a, b)


def test_loop_refuses_paths_not_ported(cohort):
    """The loop refuses a data-parallel config without its process group
    and a model on another device. With `spatial_parallel` 2 beside
    `data_parallel` 2 it asks for a group of 2 ranks, not 4: the reference's
    spatial axis only replicates each data shard's step."""
    model = ContraAttnUNet(pconfig.ModelConfig(**MODEL), device="cpu")
    loader, _ = _loaders(cohort, port=True)
    base = _config(pconfig, epochs=1)
    for train_cfg, error, what in (
        (dict(spatial_parallel=2, data_parallel=2), ValueError,
         "process group of 2 ranks"),
        (dict(data_parallel=2), ValueError, "process group of 2"),
    ):
        cfg = dataclasses.replace(base, train=dataclasses.replace(base.train,
                                                                  **train_cfg))
        with pytest.raises(error, match=what):
            ploop.train(model, cfg, loader, device="cpu")
    with pytest.raises(ValueError, match="model is on cpu"):
        ploop.train(model, base, loader, device="meta")


@pytest.mark.parametrize("reduction", ["mean", "sum"])
def test_roi_losses_and_weight_updates_match_jax(reduction):
    """`roi_rse`, `roi_rrmse` and the adaptive ROI and voxel weight updates
    against the JAX package's, at f32."""
    rng = np.random.default_rng(12)
    pred = rng.uniform(size=(2, 1, 5, 6, 7)).astype(np.float32)
    gt = rng.uniform(0.1, 2.0, size=pred.shape).astype(np.float32)
    compact = rng.integers(0, 5, size=(2, 5, 6, 7)).astype(np.int32)
    w = rng.uniform(1, 3, size=(4,)).astype(np.float32)
    t = torch.from_numpy
    for name in ("roi_rse", "roi_rrmse"):
        got = getattr(p_losses, name)(t(pred), t(gt), t(compact), t(w), reduction)
        want = getattr(j_roi_losses, name)(pred, gt, compact, w, reduction)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   err_msg=name)
    errors = rng.uniform(0, 3, size=(4,)).astype(np.float32)
    np.testing.assert_allclose(
        p_losses.update_roi_weights(t(w), t(errors), 360.0).numpy(),
        np.asarray(j_roi_losses.update_roi_weights(w, errors, 360.0)), rtol=1e-6)
    grid = p_losses.make_voxel_weights(t(compact[0]), t(w))
    errs = rng.uniform(0, 2, size=grid.shape).astype(np.float32)
    np.testing.assert_allclose(
        p_losses.update_voxel_weights(grid, t(errs)).numpy(),
        np.asarray(j_roi_losses.update_voxel_weights(grid.numpy(), errs)),
        rtol=1e-6)
