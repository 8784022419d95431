"""The PyTorch port's train step (`coma_unet_tpu_torch.train`) against the
JAX package's `make_train_step`, on the CPU at f32.

Both sides take the same parameters (the flax init with seeded numpy noise
on every leaf, bridged by `from_flax`), the same batch and AdamW(1e-3). The
tolerances are those of the end-to-end parity test
(`tests/test_e2e_torch_parity.py`): loss within 1e-5, gradients within
rtol 2e-3 / atol 5e-6, parameters after the AdamW step within rtol 2e-3 /
atol 2e-5 where the gradient carries signal, on at least 20 leaves. That
test's loss is O(1); the RoiMSE here is weighted by 225 and its gradients
run to O(100), so every absolute gradient threshold is scaled by the
largest gradient (`_gscale`). Also
pinned: the partial-batch mask, the tCDS path, the RnC guard at one
sample, the losses one by one, and the plateau controller.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from coma_unet_tpu.config import LossConfig, ModelConfig  # noqa: E402
from coma_unet_tpu.losses import composite as jax_composite  # noqa: E402
from coma_unet_tpu.losses import contrastive as jax_contrastive  # noqa: E402
from coma_unet_tpu.losses import roi_losses as jax_roi_losses  # noqa: E402
from coma_unet_tpu.models import ContraAttnUNet as FlaxContra  # noqa: E402
from coma_unet_tpu.ops import roi as jax_roi  # noqa: E402
from coma_unet_tpu.train import (  # noqa: E402
    create_train_state,
    make_optimizer as jax_make_optimizer,
    make_train_step as jax_make_train_step,
)
from coma_unet_tpu.train.optim import ReduceLROnPlateau as JaxPlateau  # noqa: E402
from coma_unet_tpu_torch import ContraAttnUNet, ops  # noqa: E402
from coma_unet_tpu_torch import losses as port_losses  # noqa: E402
from coma_unet_tpu_torch.convert import from_flax  # noqa: E402
from coma_unet_tpu_torch.train import (  # noqa: E402
    MultiSteps,
    ReduceLROnPlateau,
    create_train_state as port_create_train_state,
    get_lr,
    make_optimizer,
    make_train_step,
    set_lr,
)

B, S, R = 2, 16, 5
CFG = ModelConfig(
    channels=(4, 8, 16),
    strides=(2, 2, 2),
    latent_spaces=(32,) * 3,
    prompt_shape=(S, S, S),
    num_experts=4,
    compute_dtype="float32",
    pallas_convs=False,
    packed_level=False,
    remat=False,
)
ARGS = ("mri", "covars", "roi_loc", "roi_std", "roi_compact")
ROI_W = np.full((R,), 225.0, np.float32)
LOSS_TOL = 1e-5
GRAD_TOL = dict(rtol=2e-3, atol=5e-6)
PARAM_TOL = dict(rtol=2e-3, atol=2e-5)


def _batch(rng, b=B, triplet=False):
    def vol():
        v = rng.uniform(0.0, 1.0, size=(b, 1, S, S, S)).astype(np.float32)
        v[v < 0.2] = 0.0  # exercise the modulator's brain mask
        return v

    def covars():
        c = rng.normal(size=(b, CFG.num_covars)).astype(np.float32)
        c[:, 0] = np.resize([1.0, 0.0], b)  # abeta+ and abeta- prompts
        return c

    batch = {
        "mri": vol(), "covars": covars(),
        "roi_loc": rng.uniform(0.5, 2.0, size=(b, R)).astype(np.float32),
        "roi_std": rng.uniform(0.0, 0.5, size=(b, R)).astype(np.float32),
        "roi_compact": rng.integers(0, R + 1, size=(b, S, S, S)).astype(np.int32),
        "tau": rng.uniform(0.0, 2.0, size=(b, 1, S, S, S)).astype(np.float32),
    }
    if triplet:
        for p in ("pos_", "neg_"):
            batch[p + "mri"] = vol()
            batch[p + "covars"] = covars()
            for k in ("roi_loc", "roi_std", "roi_compact"):
                batch[p + k] = batch[k]
    return batch


def _torch_batch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _jax_step(params, batch, loss_config):
    model = FlaxContra(CFG)
    state = create_train_state(
        model, jax_make_optimizer(1e-3), jax.random.PRNGKey(0),
        tuple(jnp.asarray(batch[k]) for k in ARGS), {"train": True},
        variables={"params": params})
    step = jax_make_train_step(model, loss_config, donate=False,
                               return_grads=True)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    new_state, aux = step(state, jbatch, jnp.asarray(ROI_W),
                          jax.random.PRNGKey(1))
    return jax.device_get(new_state.params), jax.device_get(aux)


def _port(params):
    port = ContraAttnUNet(CFG, device="cpu")
    port.load_state_dict(from_flax(params, port))
    return port


def _port_step(params, batch, loss_config):
    port = _port(params)
    step = make_train_step(port, loss_config,
                           make_optimizer(port.parameters(), 1e-3))
    metrics = step(_torch_batch(batch), torch.from_numpy(ROI_W))
    return port, metrics


@pytest.fixture(scope="module")
def params():
    rng = np.random.default_rng(0)
    batch = _batch(rng)
    variables = jax.jit(lambda key: FlaxContra(CFG).init(
        key, *(jnp.asarray(batch[k]) for k in ARGS), train=False))(
        jax.random.PRNGKey(0))
    return jax.tree.map(
        lambda a: (np.asarray(a) + 0.05 * rng.normal(size=a.shape)).astype(
            np.float32), variables["params"])


@pytest.fixture(scope="module")
def rnc_run(params):
    # three samples: at two, each anchor has one ranking candidate and RnC
    # is identically 0, so its gradient path would go unchecked
    batch = _batch(np.random.default_rng(1), b=3)
    new_params, aux = _jax_step(params, batch, LossConfig())
    port, metrics = _port_step(params, batch, LossConfig())
    return dict(new_params=new_params, aux=aux, port=port, metrics=metrics)


def _close(got, want, tol=LOSS_TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.all(np.abs(got - want) <= tol * np.maximum(1.0, np.abs(want))), (
        got, want)


def test_train_step_metrics_match_jax(rnc_run):
    aux, metrics = rnc_run["aux"], rnc_run["metrics"]
    for name in ("loss", "gen_loss", "pred_space_loss", "tcds_loss"):
        _close(metrics[name].numpy(), aux[name])
    assert abs(float(aux["tcds_loss"])) > 1e-3  # RnC is live at b=3
    _close(metrics["grad_norm"].numpy(), aux["grad_norm"], tol=1e-4)


def _gscale(grads) -> float:
    return max(1.0, max(float(g.abs().max()) for g in grads.values()))


def _check_grads(port, grads):
    """Port gradients against the JAX ones (a missing gradient reads 0).
    Conv biases that feed an instance norm have a true gradient of 0 and
    show only f32 noise on both sides, bounded by the scaled atol too."""
    want = from_flax(grads, port)
    atol = GRAD_TOL["atol"] * _gscale(want)
    for name, p in port.named_parameters():
        got = (p.grad if p.grad is not None else torch.zeros_like(p)).numpy()
        np.testing.assert_allclose(got, want[name].numpy(),
                                   rtol=GRAD_TOL["rtol"], atol=atol,
                                   err_msg=f"grad {name}")


def test_train_step_grads_match_jax(rnc_run):
    _check_grads(rnc_run["port"], rnc_run["aux"]["grads"])


def test_train_step_params_after_adamw_match_jax(rnc_run):
    """AdamW's first step moves each element by about lr * sign(g), so the
    parameters are comparable where the gradient is well above the f32
    noise floor (1e-4 of the largest gradient)."""
    port = rnc_run["port"]
    want = from_flax(rnc_run["new_params"], port)
    grads = from_flax(rnc_run["aux"]["grads"], port)
    floor = 1e-4 * _gscale(grads)
    n_signal = 0
    for name, p in port.named_parameters():
        signal = (grads[name].abs() > floor).numpy()
        if not signal.any():
            continue
        n_signal += 1
        np.testing.assert_allclose(p.detach().numpy()[signal],
                                   want[name].numpy()[signal],
                                   **PARAM_TOL, err_msg=f"param {name}")
    assert n_signal >= 20


def test_every_parameter_gets_its_gradient(rnc_run):
    """Every parameter that the JAX step gives a nonzero gradient receives a
    finite gradient through the port's kernel Functions (the conv biases,
    the CondConv experts and routes, FiLM and the PReLU slopes included);
    only the heads the RnC loss does not read get none."""
    port = rnc_run["port"]
    want = from_flax(rnc_run["aux"]["grads"], port)
    unused = set()
    for name, p in port.named_parameters():
        if p.grad is None:
            unused.add(name.split(".")[0])
            assert float(want[name].abs().max()) == 0.0, name
        else:
            assert bool(torch.isfinite(p.grad).all()), name
    assert unused == {"proj0", "proj1", "final_proj"}


def test_train_step_runs_every_wrapper(params):
    """The train step reaches all seven kernel families' wrappers (here
    their plain versions)."""
    port = _port(params)
    step = make_train_step(port, LossConfig(),
                           make_optimizer(port.parameters(), 1e-3))
    ops.reset_counts()
    step(_torch_batch(_batch(np.random.default_rng(2))), torch.from_numpy(ROI_W))
    assert all(ops.PLAIN_ON_CPU[f] > 0 for f in ops.PATH_FAMILIES), dict(ops.PLAIN_ON_CPU)
    assert not ops.LAUNCHES and not ops.PLAIN_ON_CUDA


def test_partial_batch_matches_true_partial(params):
    """A wrap-padded batch (valid_mask [1, 0]) gives the loss and gradient
    of the true one-sample batch, and the padded row's content does not
    matter (as `test_train_step_padded_batch_grads_match_partial`)."""
    true = _batch(np.random.default_rng(3), b=1)
    padded = {k: np.concatenate([v, v], axis=0) for k, v in true.items()}
    padded["valid_mask"] = np.asarray([1.0, 0.0], np.float32)
    garbage = {k: v.copy() for k, v in padded.items()}
    garbage["mri"][1] = np.random.default_rng(4).uniform(size=garbage["mri"][1].shape)
    garbage["tau"][1] = 7.0
    garbage["covars"][1] = 3.0

    runs = [_port_step(params, b, LossConfig()) for b in (true, padded, garbage)]
    (p_true, m_true), (p_pad, m_pad), (p_garb, m_garb) = runs
    _close(m_pad["loss"].numpy(), m_true["loss"].numpy())
    _close(m_garb["loss"].numpy(), m_pad["loss"].numpy(), tol=1e-6)
    grads = [{n: (p.grad if p.grad is not None else torch.zeros_like(p)).numpy()
              for n, p in port.named_parameters()}
             for port in (p_true, p_pad, p_garb)]
    for name, g_true in grads[0].items():
        g_pad, g_garb = grads[1][name], grads[2][name]
        np.testing.assert_allclose(
            g_pad, g_true, rtol=1e-3, atol=1e-4 * (1.0 + np.abs(g_true).max()),
            err_msg=name)
        np.testing.assert_allclose(g_garb, g_pad, rtol=1e-6, atol=1e-8,
                                   err_msg=name)


def test_tcds_path_matches_jax(params):
    """rnc=False: three forwards (anchor, pos_, neg_), the tCDS triplet
    terms and the pred-space term."""
    cfg = LossConfig(rnc=False, reg_weight=0.1, cds_weights=(0.0, 1.0, 4.0))
    batch = _batch(np.random.default_rng(5), triplet=True)
    _, aux = _jax_step(params, batch, cfg)
    port, metrics = _port_step(params, batch, cfg)
    for name in ("loss", "gen_loss", "pred_space_loss", "tcds_loss"):
        _close(metrics[name].numpy(), aux[name])
    _close(metrics["grad_norm"].numpy(), aux["grad_norm"], tol=1e-4)
    # Per leaf in L2, not per element: with three forwards, a few voxels of
    # the prompt gradients sit at an activation's kink, where a 1e-6
    # relative change of the parameters moves the port's own gradient there
    # by 1e-3 (of 0.17); both sides are f32.
    want = from_flax(aux["grads"], port)
    for name, p in port.named_parameters():
        got = p.grad if p.grad is not None else torch.zeros_like(p)
        norm = float(torch.linalg.vector_norm(want[name]))
        err = float(torch.linalg.vector_norm(got - want[name]))
        assert err <= GRAD_TOL["rtol"] * norm + GRAD_TOL["atol"] * _gscale(want), name


def test_rnc_guard_at_one_sample(params):
    """At b=1 RnC has no pairs: 0 with no gradient, and the step stays
    finite (the 216^3 template-space batch size)."""
    batch = _batch(np.random.default_rng(6), b=1)
    port, metrics = _port_step(params, batch, LossConfig())
    assert float(metrics["tcds_loss"]) == 0.0
    assert np.isfinite(float(metrics["loss"]))
    feats = torch.randn(1, 8, requires_grad=True)
    loss = port_losses.rnc_loss(feats, torch.randn(1, 6))
    assert float(loss) == 0.0 and not loss.requires_grad


@pytest.mark.parametrize("n,masked", [(2, False), (4, False), (5, True)])
def test_rnc_loss_matches_jax(n, masked):
    rng = np.random.default_rng(7 + n)
    feats = rng.normal(size=(n, 8)).astype(np.float32)
    labels = rng.uniform(size=(n, 6)).astype(np.float32)
    valid = np.asarray([1, 1, 0, 1, 0][:n], np.float32) if masked else None

    def port(f):
        return port_losses.rnc_loss(f, torch.from_numpy(labels), 2.0,
                                    None if valid is None else torch.from_numpy(valid))

    def ref(f):
        return jax_contrastive.rnc_loss(f, jnp.asarray(labels), 2.0,
                                        None if valid is None else jnp.asarray(valid))

    f = torch.from_numpy(feats).requires_grad_()
    loss = port(f)
    loss.backward()
    want, want_grad = jax.value_and_grad(ref)(jnp.asarray(feats))
    _close(loss.detach().numpy(), want)
    np.testing.assert_allclose(f.grad.numpy(), np.asarray(want_grad),
                               rtol=1e-5, atol=1e-6)


def test_triplet_and_roi_losses_match_jax():
    rng = np.random.default_rng(9)
    a, p, n = (rng.normal(size=(3, 10)).astype(np.float32) for _ in range(3))
    valid = np.asarray([1, 0, 1], np.float32)
    t = torch.from_numpy
    _close(port_losses.triplet_loss(t(a), t(p), t(n), 1.0, t(valid)).numpy(),
           jax_contrastive.triplet_loss(a, p, n, 1.0, valid))
    projs = [[rng.normal(size=(3, w)).astype(np.float32) for w in (4, 6)]
             for _ in range(3)]
    _close(port_losses.truncated_cds(*[[t(x) for x in ps] for ps in projs],
                                     (0.5, 2.0), 1.0).numpy(),
           jax_contrastive.truncated_cds(*projs, (0.5, 2.0), 1.0))
    pred = rng.uniform(size=(2, 1, 4, 5, 6)).astype(np.float32)
    gt = rng.uniform(size=pred.shape).astype(np.float32)
    compact = rng.integers(0, R + 3, size=(2, 4, 5, 6)).astype(np.int32)
    w = rng.uniform(1, 3, size=(R,)).astype(np.float32)
    for red in ("mean", None):
        _close(port_losses.roi_mse(t(pred), t(gt), t(compact), t(w),
                                   reduction=red).numpy(),
               jax_roi_losses.roi_mse(pred, gt, compact, w, reduction=red))
    vw = port_losses.make_voxel_weights(t(compact[0]), t(w))
    _close(vw.numpy(), jax_roi_losses.make_voxel_weights(compact[0], w))
    _close(port_losses.roi_mse(t(pred), t(gt), t(compact), t(w),
                               voxel_weights=vw).numpy(),
           jax_roi_losses.roi_mse(pred, gt, compact, w,
                                  voxel_weights=np.asarray(vw)))
    np.testing.assert_array_equal(
        ops.roi_weight_mask(t(compact), t(w), 0.5).numpy(),
        np.asarray(jax_roi.roi_weight_mask(compact, w, 0.5)))


def test_composite_loss_outputs_match_jax():
    rng = np.random.default_rng(10)
    pred = rng.uniform(size=(3, 1, 4, 4, 4)).astype(np.float32)
    tau = rng.uniform(size=pred.shape).astype(np.float32)
    compact = rng.integers(0, R + 1, size=(3, 4, 4, 4)).astype(np.int32)
    feats = rng.normal(size=(3, 8)).astype(np.float32)
    covars = rng.uniform(size=(3, 6)).astype(np.float32)
    valid = np.asarray([1, 1, 0], np.float32)
    t = torch.from_numpy
    got = port_losses.GenerativeContrastiveLoss(LossConfig())(
        t(pred), t(tau), t(compact), t(ROI_W), rnc_features=t(feats),
        rnc_labels=t(covars), valid=t(valid))
    want = jax_composite.GenerativeContrastiveLoss(LossConfig())(
        pred, tau, compact, ROI_W, rnc_features=feats, rnc_labels=covars,
        valid=valid)
    for field in dataclasses.fields(got):
        _close(getattr(got, field.name).numpy(), getattr(want, field.name))


def test_plateau_scheduler_matches_jax():
    metrics = [10.0, 9.0, 9.0, 9.5, 8.9995, 9.0, 9.0, 9.0, 9.1, 5.0, 5.0,
               5.0, 5.0]
    ours, theirs = ReduceLROnPlateau(patience=2, factor=0.5), \
        JaxPlateau(patience=2, factor=0.5)
    lr_ours = lr_theirs = 1.0
    for m in metrics:
        lr_ours, lr_theirs = ours.step(m, lr_ours), theirs.step(m, lr_theirs)
        assert lr_ours == lr_theirs
        assert ours.state_dict() == theirs.state_dict()
    assert lr_ours < 1.0


def test_optimizer_and_state():
    model = torch.nn.Linear(3, 2)
    state = port_create_train_state(model, 1e-3)
    assert state.step == 0 and get_lr(state.optimizer) == 1e-3
    group = state.optimizer.param_groups[0]
    assert group["weight_decay"] == 0.01 and group["betas"] == (0.9, 0.999)
    assert group["eps"] == 1e-8
    set_lr(state.optimizer, 5e-4)
    assert get_lr(state.optimizer) == 5e-4
    for n in (1, 2):
        model(torch.ones(4, 3)).sum().backward()
        state.optimizer.step()
        assert state.step == n
    # gradient accumulation: optax.MultiSteps semantics, lr on the inner AdamW
    acc = make_optimizer(model.parameters(), 1e-3, grad_acc=2)
    assert isinstance(acc, MultiSteps) and isinstance(acc.inner, torch.optim.AdamW)
    set_lr(acc, 2e-4)
    assert get_lr(acc) == 2e-4 == acc.inner.param_groups[0]["lr"]


def test_models_without_projections_raise():
    """A model without projection heads (a registry baseline returns the
    volume alone) no longer raises: it trains on the generative loss only,
    gen_weight x the sum over valid rows of the per-sample RoiMSE, as the
    JAX step's baseline branch does, with pred_space_loss and tcds_loss 0
    and the gradient reaching its parameter."""
    class Plain(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.gain = torch.nn.Parameter(torch.ones(()))

        def forward(self, x, *args, with_projections=True):
            return x * self.gain

    model = Plain()
    loss_config = LossConfig(gen_weight=0.5)
    step = make_train_step(model, loss_config,
                           make_optimizer(model.parameters(), 1e-3))
    batch = _torch_batch(_batch(np.random.default_rng(11)))
    batch["valid_mask"] = torch.tensor([1.0, 0.0])
    metrics = step(batch, torch.from_numpy(ROI_W))
    gen = jax_roi_losses.roi_mse(
        jnp.asarray(batch["mri"].numpy()), jnp.asarray(batch["tau"].numpy()),
        jnp.asarray(batch["roi_compact"].numpy()), jnp.asarray(ROI_W),
        reduction=None)
    _close(metrics["gen_loss"].numpy(), gen)
    _close(metrics["loss"].numpy(), 0.5 * float(gen[0]))
    assert float(metrics["pred_space_loss"]) == float(metrics["tcds_loss"]) == 0.0
    assert model.gain.grad is not None and float(model.gain.grad) != 0.0