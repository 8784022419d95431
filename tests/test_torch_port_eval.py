"""The PyTorch port's eval step and metric suite against the JAX package's,
on the CPU at f32.

`ssim3d`, `roi_reduce` / `roi_sums` / `roi_counts`, `voxel_metrics` and
`roi_metrics` take the same numpy inputs on both sides and agree within
rtol 1e-5 (atol 1e-6 for values near 0). `make_eval_step` runs the flagship
forward of the end-to-end parity shapes (B=2, 16^3, channels (4, 8, 16),
4 experts) and the odd-level 18^3 case (18 -> 9 -> 5; the up 5 -> 10 is
cropped to 9), with the same parameters on both sides (flax init plus
seeded noise, bridged by `from_flax`): `pred` within 1e-4, as the forward
parity tests hold it, and every metric within 1e-5 of the JAX metric
functions on the same `pred`. The host accumulators of the two packages
then agree on the aggregated `MetricResults` of the same metrics.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from coma_unet_tpu.config import ModelConfig  # noqa: E402
from coma_unet_tpu.metrics import MetricAccumulator as JaxAccumulator  # noqa: E402
from coma_unet_tpu.metrics import roi_metrics as jax_roi_metrics  # noqa: E402
from coma_unet_tpu.metrics import voxel_metrics as jax_voxel_metrics  # noqa: E402
from coma_unet_tpu.models import ContraAttnUNet as FlaxContra  # noqa: E402
from coma_unet_tpu.ops import roi as jax_roi  # noqa: E402
from coma_unet_tpu.ops.ssim import ssim3d as jax_ssim3d  # noqa: E402
from coma_unet_tpu.train import create_train_state  # noqa: E402
from coma_unet_tpu.train import make_eval_step as jax_make_eval_step  # noqa: E402
from coma_unet_tpu.train import make_optimizer as jax_make_optimizer  # noqa: E402
from coma_unet_tpu_torch import ContraAttnUNet, ops  # noqa: E402
from coma_unet_tpu_torch.convert import from_flax  # noqa: E402
from coma_unet_tpu_torch.metrics import (  # noqa: E402
    MetricAccumulator,
    roi_metrics,
    voxel_metrics,
)
from coma_unet_tpu_torch.train import make_eval_step  # noqa: E402

METRIC_TOL = dict(rtol=1e-5, atol=1e-6)
FWD_TOL = dict(rtol=1e-4, atol=1e-4)
R = 5
ARGS = ("mri", "covars", "roi_loc", "roi_std", "roi_compact")


def _cfg(s):
    return ModelConfig(channels=(4, 8, 16), strides=(2, 2, 2),
                       latent_spaces=(32,) * 3, prompt_shape=(s, s, s),
                       num_experts=4, compute_dtype="float32",
                       pallas_convs=False, packed_level=False, remat=False)


def _volumes(seed, shape):
    rng = np.random.default_rng(seed)
    pred = rng.uniform(0.0, 2.0, size=shape).astype(np.float32)
    gt = (pred + rng.normal(0.0, 0.3, size=shape)).astype(np.float32)
    gt[rng.uniform(size=shape) < 0.1] = 0.0   # MAPE's invalid voxels
    return pred, gt


def _close(got, want, tol=METRIC_TOL, msg=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), **tol,
                               err_msg=msg)


@pytest.mark.parametrize("kernel", ["uniform", "gaussian"])
@pytest.mark.parametrize("reduce", ["mean", "none"])
def test_ssim3d_matches_jax(kernel, reduce):
    pred, gt = _volumes(0, (2, 1, 12, 11, 10))
    want = jax_ssim3d(jnp.asarray(pred), jnp.asarray(gt), kernel=kernel,
                      reduce=reduce)
    got = ops.ssim3d(torch.from_numpy(pred), torch.from_numpy(gt),
                     kernel=kernel, reduce=reduce)
    assert tuple(got.shape) == tuple(np.shape(want))
    _close(got, want)
    # [B, D, H, W] inputs take a channel axis
    got4 = ops.ssim3d(torch.from_numpy(pred[:, 0]), torch.from_numpy(gt[:, 0]),
                      kernel=kernel, reduce=reduce)
    _close(got4, want)


@pytest.mark.parametrize("num_rois", [36, 8])
def test_roi_reduce_matches_jax(num_rois):
    rng = np.random.default_rng(num_rois)
    shape = (2, 9, 10, 11)
    values = rng.normal(size=shape).astype(np.float32)
    compact = rng.integers(0, num_rois + 1, size=shape).astype(np.int32)
    compact[0, 0, 0, :3] = num_rois + 4   # outside [0, R]: counts nowhere
    t = torch.from_numpy
    _close(ops.roi_reduce(t(values), t(compact), num_rois),
           jax_roi.roi_reduce(values, compact, num_rois))
    _close(ops.roi_sums(t(values), t(compact), num_rois),
           jax_roi.roi_sums(values, compact, num_rois))
    np.testing.assert_array_equal(
        ops.roi_counts(t(compact), num_rois).numpy(),
        np.asarray(jax_roi.roi_counts(compact, num_rois)))


def test_roi_reduce_sums_past_one_chunk():
    """A volume of several ROI_CHUNK partials sums as one f64 reduction."""
    from coma_unet_tpu_torch.ops.roi import ROI_CHUNK

    rng = np.random.default_rng(3)
    n = 3 * ROI_CHUNK + 17
    values = rng.uniform(size=(2, n))
    compact = rng.integers(0, 4, size=(2, n))
    got = ops.roi_reduce(torch.from_numpy(values), torch.from_numpy(compact), 3)
    want = [[values[b][compact[b] == r].sum() for r in range(4)] for b in range(2)]
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12)


@pytest.mark.parametrize("shape", [(2, 1, 12, 12, 12), (3, 10, 9, 11)])
def test_voxel_metrics_match_jax(shape):
    pred, gt = _volumes(1, shape)
    want = jax_voxel_metrics(jnp.asarray(pred), jnp.asarray(gt))
    got = voxel_metrics(torch.from_numpy(pred), torch.from_numpy(gt))
    assert set(got) == set(want)
    for key in want:
        _close(got[key], want[key], msg=key)


def test_roi_metrics_match_jax():
    pred, gt = _volumes(2, (2, 1, 10, 12, 9))
    rng = np.random.default_rng(2)
    compact = rng.integers(0, 9, size=(2, 10, 12, 9)).astype(np.int32)
    compact[1][compact[1] == 3] = 0   # an empty ROI
    want = jax_roi_metrics(jnp.asarray(pred), jnp.asarray(gt),
                           jnp.asarray(compact), 8)
    got = roi_metrics(torch.from_numpy(pred), torch.from_numpy(gt),
                      torch.from_numpy(compact), 8)
    assert set(got) == set(want)
    for key in want:
        _close(got[key], want[key], msg=key)


def _batch(rng, b, s):
    mri = rng.uniform(0.0, 1.0, size=(b, 1, s, s, s)).astype(np.float32)
    mri[mri < 0.2] = 0.0
    covars = rng.normal(size=(b, 6)).astype(np.float32)
    covars[:, 0] = np.resize([1.0, 0.0], b)
    return {
        "mri": mri, "covars": covars,
        "roi_loc": rng.uniform(0.5, 2.0, size=(b, R)).astype(np.float32),
        "roi_std": rng.uniform(0.0, 0.5, size=(b, R)).astype(np.float32),
        "roi_compact": rng.integers(0, R + 1, size=(b, s, s, s)).astype(np.int32),
        "tau": rng.uniform(0.0, 2.0, size=(b, 1, s, s, s)).astype(np.float32),
        "abeta": covars[:, 0].copy(),
    }


@pytest.fixture(scope="module", params=[16, 18], ids=["16^3", "18^3"])
def eval_run(request):
    s = request.param
    cfg = _cfg(s)
    rng = np.random.default_rng(s)
    batch = _batch(rng, 2, s)
    model = FlaxContra(cfg)
    variables = jax.jit(lambda key: model.init(
        key, *(jnp.asarray(batch[k]) for k in ARGS), train=False))(
        jax.random.PRNGKey(0))
    params = jax.tree.map(
        lambda a: (np.asarray(a) + 0.05 * rng.normal(size=a.shape)).astype(
            np.float32), variables["params"])
    state = create_train_state(
        model, jax_make_optimizer(1e-3), jax.random.PRNGKey(0),
        tuple(jnp.asarray(batch[k]) for k in ARGS), {"train": False},
        variables={"params": params})
    want = jax.device_get(jax_make_eval_step(model, R)(
        state, {k: jnp.asarray(v) for k, v in batch.items()}))
    port = ContraAttnUNet(cfg, device="cpu")
    port.load_state_dict(from_flax(params, port))
    port.train()   # the eval step puts the model in eval mode itself
    got = make_eval_step(port, R)(batch)
    return dict(s=s, batch=batch, want=want, got=got, port=port)


def test_eval_step_matches_jax(eval_run):
    """`pred` against the JAX eval step's at 1e-4; the metrics against the
    JAX package's metric functions on the same `pred` at 1e-5 (a 1e-6
    difference of `pred` where |tau| is small moves `abs_rel_vol` by more),
    and the per-sample scalars against the JAX eval step's own at 1e-4."""
    (pred, vox, roi), (jpred, jvox, jroi) = eval_run["got"], eval_run["want"]
    s, batch = eval_run["s"], eval_run["batch"]
    assert tuple(pred.shape) == (2, 1, s, s, s)
    assert not pred.requires_grad and not eval_run["port"].training
    _close(pred, jpred, FWD_TOL)
    p, tau = jnp.asarray(pred.numpy()), jnp.asarray(batch["tau"])
    same = (jax_voxel_metrics(p, tau),
            jax_roi_metrics(p, tau, jnp.asarray(batch["roi_compact"]), R))
    for got, want, own in ((vox, same[0], jvox), (roi, same[1], jroi)):
        assert set(got) == set(want) == set(own)
        for key in want:
            _close(got[key], want[key], msg=key)
            if key != "abs_rel_vol":
                _close(got[key], own[key], FWD_TOL, msg=key)


def test_eval_step_reaches_the_forward_wrappers(eval_run):
    ops.reset_counts()
    make_eval_step(eval_run["port"], R)(eval_run["batch"])
    assert all(ops.PLAIN_ON_CPU[f] > 0 for f in ops.FWD_FAMILIES), dict(ops.PLAIN_ON_CPU)
    assert not any(ops.PLAIN_ON_CPU[f] for f in ops.BWD_FAMILIES)
    assert not ops.LAUNCHES and not ops.PLAIN_ON_CUDA


def test_metric_results_match_jax(eval_run):
    """Both accumulators over the same two batches of the port's metrics
    (as tensors for the port's, as arrays for the JAX package's), with one
    wrap-padded row."""
    _, vox, roi = eval_run["got"]
    jvox = {k: v.numpy() for k, v in vox.items()}
    jroi = {k: v.numpy() for k, v in roi.items()}
    abeta = eval_run["batch"]["abeta"]
    ours, theirs = MetricAccumulator(R), JaxAccumulator(R)
    for valid in (None, np.asarray([1.0, 0.0], np.float32)):
        ours.update(vox, roi, torch.from_numpy(abeta), valid=valid)
        theirs.update(jvox, jroi, abeta, valid=valid)
    for got, want in zip(ours.results(), theirs.results()):
        assert got.num_samples == want.num_samples
        for field in dataclasses.fields(want):
            a, b = getattr(got, field.name), getattr(want, field.name)
            _close(np.asarray(a), np.asarray(b), msg=field.name)
    assert ours.results()[0].num_samples == 3
    _close(ours.voxel_mape_grid(), theirs.voxel_mape_grid())
