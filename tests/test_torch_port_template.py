"""The template-space (216^3) path of the PyTorch port against the JAX
package, on the CPU at f32.

- The port's own configuration copy: the same fields and defaults as the
  JAX package's, and the same `ExperimentConfig.normalized()` geometry
  (template space pads to 216^3; the prompts follow the volume).
- One template-space train step at the odd size 18^3 (18 -> 9 -> 5, the up
  5 -> 10 cropped to 9), b=1, `roi_weight=1.0`, the 8 template ROIs, against
  the JAX `make_train_step`, at the tolerances of the end-to-end parity test:
  loss within 1e-5, gradients within rtol 2e-3 / atol 5e-6 of the largest
  gradient, parameters after AdamW within rtol 2e-3 where the gradient
  carries signal. At b=1 RnC takes its n<2 guard.
- The plain versions of K1 and KB1 against `_pallas_conv3d_fwd` and
  `_pallas_conv3d_dw` at H = 136, which routes them to the H-tiled TPU
  kernels (rows #3 and #5 of the kernel table), at the shapes of the JAX
  package's own tests; and `instance_norm`, `conv3d_w64` and `hsplit`
  against `pallas_instance_norm`, `pallas_conv3d_w64` and `pallas_hsplit`
  in interpret mode: max|port - jax| / max|jax| < 1e-5, `hsplit` exactly.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import coma_unet_tpu.config as jax_config  # noqa: E402
from coma_unet_tpu.models import ContraAttnUNet as FlaxContra  # noqa: E402
from coma_unet_tpu.ops.pallas.conv3d import (  # noqa: E402
    _pallas_conv3d_dw,
    _pallas_conv3d_fwd,
)
from coma_unet_tpu.ops.pallas.conv3d_packed import pallas_conv3d_w64  # noqa: E402
from coma_unet_tpu.ops.pallas.instance_norm import pallas_instance_norm  # noqa: E402
from coma_unet_tpu.ops.pallas.phase_split import pallas_hsplit  # noqa: E402
from coma_unet_tpu.train import (  # noqa: E402
    create_train_state,
    make_optimizer as jax_make_optimizer,
    make_train_step as jax_make_train_step,
)
import coma_unet_tpu_torch.config as port_config  # noqa: E402
from coma_unet_tpu_torch import ContraAttnUNet, ops  # noqa: E402
from coma_unet_tpu_torch.convert import from_flax  # noqa: E402
from coma_unet_tpu_torch.train import make_optimizer, make_train_step  # noqa: E402

TOL = 1e-5
LOSS_TOL = 1e-5
GRAD_TOL = dict(rtol=2e-3, atol=5e-6)
PARAM_TOL = dict(rtol=2e-3, atol=2e-5)
S = 18
ARGS = ("mri", "covars", "roi_loc", "roi_std", "roi_compact")
CONFIGS = ("ModelConfig", "LossConfig", "TrainConfig", "DataConfig",
           "ExperimentConfig")


def _rel(got, want) -> float:
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / np.abs(want).max())


# ------------------------------------------------------------ config copy
@pytest.mark.parametrize("name", CONFIGS)
def test_config_copy_matches_jax(name):
    ours, theirs = getattr(port_config, name), getattr(jax_config, name)
    assert ([(f.name, f.type) for f in dataclasses.fields(ours)]
            == [(f.name, f.type) for f in dataclasses.fields(theirs)])
    assert dataclasses.asdict(ours()) == dataclasses.asdict(theirs())
    if name == "ModelConfig":
        assert ours().depth == theirs().depth


def test_roi_indices_match_jax():
    assert port_config.ROI_INDICES == jax_config.ROI_INDICES
    assert port_config.TEMPLATE_ROI_INDICES == jax_config.TEMPLATE_ROI_INDICES
    assert len(port_config.TEMPLATE_ROI_INDICES) == 8


@pytest.mark.parametrize("data,model", [
    (dict(template_space=True), {}),
    (dict(template_space=True, volume_shape=(18, 18, 18)), {}),
    (dict(template_space=False), {}),
    (dict(volume_shape=(96, 96, 96)), dict(prompt_shape=(64, 64, 64))),
    (dict(template_space=True), dict(prompt_shape=(216, 216, 216))),
])
def test_normalized_matches_jax(data, model):
    def run(mod):
        cfg = mod.ExperimentConfig(model=mod.ModelConfig(**model),
                                   data=mod.DataConfig(**data))
        out = cfg.normalized()
        return dataclasses.asdict(out), out is cfg, out.normalized() is out

    ours, theirs = run(port_config), run(jax_config)
    assert ours == theirs
    if data.get("template_space") and "volume_shape" not in data:
        assert ours[0]["data"]["volume_shape"] == (216, 216, 216)
        assert ours[0]["model"]["prompt_shape"] == (216, 216, 216)


# ------------------------------------------------ template-space train step
def _experiment(mod):
    model = mod.ModelConfig(channels=(4, 8, 16), strides=(2, 2, 2),
                            latent_spaces=(32,) * 3, num_experts=4,
                            compute_dtype="float32", pallas_convs=False,
                            packed_level=False, remat=False)
    return mod.ExperimentConfig(
        model=model, loss=mod.LossConfig(roi_weight=1.0),
        data=mod.DataConfig(template_space=True, volume_shape=(S, S, S)),
    ).normalized()


def _batch(rng, r):
    mri = rng.uniform(0.0, 1.0, size=(1, 1, S, S, S)).astype(np.float32)
    mri[mri < 0.2] = 0.0
    covars = rng.normal(size=(1, 6)).astype(np.float32)
    covars[:, 0] = 1.0
    return {
        "mri": mri, "covars": covars,
        "roi_loc": rng.uniform(0.5, 2.0, size=(1, r)).astype(np.float32),
        "roi_std": rng.uniform(0.0, 0.5, size=(1, r)).astype(np.float32),
        "roi_compact": rng.integers(0, r + 1, size=(1, S, S, S)).astype(np.int32),
        "tau": rng.uniform(0.0, 2.0, size=(1, 1, S, S, S)).astype(np.float32),
    }


@pytest.fixture(scope="module")
def template_run():
    jcfg, pcfg = _experiment(jax_config), _experiment(port_config)
    assert pcfg.model.prompt_shape == jcfg.model.prompt_shape == (S, S, S)
    r = len(port_config.TEMPLATE_ROI_INDICES)
    rng = np.random.default_rng(0)
    batch = _batch(rng, r)
    roi_w = np.full((r,), pcfg.loss.roi_weight, np.float32)
    model = FlaxContra(jcfg.model)
    inputs = tuple(jnp.asarray(batch[k]) for k in ARGS)
    variables = jax.jit(lambda key: model.init(key, *inputs, train=False))(
        jax.random.PRNGKey(0))
    params = jax.tree.map(
        lambda a: (np.asarray(a) + 0.05 * rng.normal(size=a.shape)).astype(
            np.float32), variables["params"])
    state = create_train_state(model, jax_make_optimizer(1e-3),
                               jax.random.PRNGKey(0), inputs, {"train": True},
                               variables={"params": params})
    step = jax_make_train_step(model, jcfg.loss, donate=False,
                               return_grads=True)
    new_state, aux = step(state, {k: jnp.asarray(v) for k, v in batch.items()},
                          jnp.asarray(roi_w), jax.random.PRNGKey(1))
    port = ContraAttnUNet(pcfg.model, device="cpu")
    port.load_state_dict(from_flax(params, port))
    ops.reset_counts()
    metrics = make_train_step(port, pcfg.loss,
                              make_optimizer(port.parameters(), 1e-3))(batch, roi_w)
    return dict(port=port, metrics=metrics, plain=dict(ops.PLAIN_ON_CPU),
                aux=jax.device_get(aux),
                new_params=jax.device_get(new_state.params))


def _gscale(grads) -> float:
    return max(1.0, max(float(g.abs().max()) for g in grads.values()))


def test_template_train_step_loss_matches_jax(template_run):
    aux, metrics = template_run["aux"], template_run["metrics"]
    for name in ("loss", "gen_loss", "pred_space_loss", "tcds_loss"):
        got, want = np.asarray(metrics[name]), np.asarray(aux[name])
        assert np.all(np.abs(got - want) <= LOSS_TOL * np.maximum(1.0, np.abs(want))), name
    assert float(metrics["tcds_loss"]) == 0.0   # RnC's n<2 guard
    assert abs(float(metrics["grad_norm"]) - float(aux["grad_norm"])) <= (
        1e-4 * max(1.0, abs(float(aux["grad_norm"]))))


def test_template_train_step_grads_match_jax(template_run):
    """Every gradient within tolerance; every parameter the JAX step gives
    a nonzero gradient gets a finite one; the train step reaches every
    kernel family of the path."""
    port = template_run["port"]
    want = from_flax(template_run["aux"]["grads"], port)
    atol = GRAD_TOL["atol"] * _gscale(want)
    for name, p in port.named_parameters():
        if p.grad is None:
            assert float(want[name].abs().max()) == 0.0, name
            continue
        assert bool(torch.isfinite(p.grad).all()), name
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   rtol=GRAD_TOL["rtol"], atol=atol,
                                   err_msg=f"grad {name}")
    plain = template_run["plain"]
    assert all(plain.get(f, 0) > 0 for f in ops.PATH_FAMILIES), plain


def test_template_train_step_params_match_jax(template_run):
    port = template_run["port"]
    want = from_flax(template_run["new_params"], port)
    grads = from_flax(template_run["aux"]["grads"], port)
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


# ------------------------------------------- kernel rows #3, #5, #8, #13, #20
def _data(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) for s in shapes]


@pytest.mark.parametrize("xshape,wshape", [
    ((1, 4, 3, 136, 128), (5, 4, 3, 3, 3)),
    ((2, 4, 3, 136, 128), (2, 5, 4, 3, 3, 3)),   # per sample
])
def test_conv3d_s1_matches_htiled_pallas(xshape, wshape):
    x, w = _data(11, xshape, wshape)
    w *= 0.1
    want = _pallas_conv3d_fwd(jnp.asarray(x), jnp.asarray(w), 3, interpret=True)
    got = ops.conv3d_s1(torch.from_numpy(x), torch.from_numpy(w))
    assert _rel(got.numpy(), want) < TOL


@pytest.mark.parametrize("per_sample", [False, True])
def test_conv3d_s1_dw_matches_htiled_pallas(per_sample):
    x, g = _data(12, (2, 3, 3, 136, 128), (2, 5, 3, 136, 128))
    want = _pallas_conv3d_dw(jnp.asarray(x), jnp.asarray(g), 3,
                             batched=per_sample, interpret=True)
    got = ops.conv3d_s1_dw(torch.from_numpy(x), torch.from_numpy(g), 3,
                           per_sample)
    assert _rel(got.numpy(), want) < TOL


@pytest.mark.parametrize("act,slope", [
    (None, 0.01), ("relu", 0.01), ("leakyrelu", 0.01), ("leakyrelu", 0.2)])
def test_instance_norm_matches_pallas(act, slope):
    """The Pallas kernel's variance is E[x^2] - mean^2 and K4's plain
    version takes the two-pass form, so they agree to rounding: 1e-5 of
    max|jax| on data whose mean is about a third of its spread."""
    (x,) = _data(4, (2, 4, 6, 8, 128))
    x = 3.0 * x + 1.0
    want = pallas_instance_norm(jnp.asarray(x), act=act, negative_slope=slope,
                                interpret=True)
    got = ops.instance_norm(torch.from_numpy(x), act=act, negative_slope=slope)
    assert _rel(got.numpy(), want) < TOL
    with pytest.raises(ValueError, match="activation"):
        ops.instance_norm(torch.from_numpy(x), act="prelu")


def test_conv3d_w64_matches_pallas():
    x, w = _data(3, (2, 4, 6, 8, 64), (5, 4, 3, 3, 3))
    w *= 0.1
    want = pallas_conv3d_w64(jnp.asarray(x), jnp.asarray(w), interpret=True)
    got = ops.conv3d_w64(torch.from_numpy(x), torch.from_numpy(w))
    assert _rel(got.numpy(), want) < TOL
    with pytest.raises(ValueError, match="conv3d_w64"):
        ops.conv3d_w64(torch.from_numpy(x[:, :, :5]), torch.from_numpy(w))


@pytest.mark.parametrize("shape", [(2, 3, 4, 8, 128), (1, 2, 3, 6, 20)])
def test_hsplit_matches_pallas(shape):
    (x,) = _data(5, shape)
    want = pallas_hsplit(jnp.asarray(x), interpret=True)
    ops.reset_counts()
    got = ops.hsplit(torch.from_numpy(x))
    assert ops.PLAIN_ON_CPU["phase_split"] == 1 and not ops.LAUNCHES
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert a.is_contiguous()
    with pytest.raises(ValueError, match="H even"):
        ops.hsplit(torch.from_numpy(x[:, :, :, :5]))
