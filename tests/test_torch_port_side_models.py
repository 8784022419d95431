"""The port's side models and losses against the JAX package's, on the CPU:
the ROI-vector pipeline (`ConvAttn`, `train_convattn`, `ImageDataset`, the
weighted losses), the UQ heads (`MLP`, `AleatoricUncertaintyNet`), the
N-pair, cluster N-pair and heteroscedastic losses, and the quartile
templates' loading and selection.

Inputs are seeded numpy arrays; the port's parameters are the flax init's,
carried across by `convert.from_flax`. Tolerances: the `ConvAttn` forward
1e-5; two epochs of `train_convattn` from the same initial weights and the
same batch order, each epoch's summed loss 1e-4 relative (Adam's update
rounds differently in torch and optax); the losses and the UQ heads 1e-6;
`ImageDataset`'s items and the templates exactly.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import pandas as pd  # noqa: E402
import torch  # noqa: E402

from coma_unet_tpu.data.image_dataset import ImageDataset as JaxImageDataset  # noqa: E402
from coma_unet_tpu.losses import contrastive as jax_contrastive  # noqa: E402
from coma_unet_tpu.losses import weighted as jax_weighted  # noqa: E402
from coma_unet_tpu.losses.templates import (  # noqa: E402
    load_quartile_templates as jax_load_templates,
    select_npair_templates as jax_select_templates,
)
from coma_unet_tpu.models.convattn import (  # noqa: E402
    ConvAttn as FlaxConvAttn,
    train_convattn as jax_train_convattn,
)
from coma_unet_tpu.models.uq import (  # noqa: E402
    AleatoricUncertaintyNet as FlaxAleatoric,
    MLP as FlaxMLP,
)
from coma_unet_tpu_torch import losses as port_losses  # noqa: E402
from coma_unet_tpu_torch.convert import from_flax  # noqa: E402
from coma_unet_tpu_torch.data.image_dataset import ImageDataset  # noqa: E402
from coma_unet_tpu_torch.losses import weighted as port_weighted  # noqa: E402
from coma_unet_tpu_torch.losses.templates import (  # noqa: E402
    load_quartile_templates,
    select_npair_templates,
)
from coma_unet_tpu_torch.models.convattn import ConvAttn, train_convattn  # noqa: E402
from coma_unet_tpu_torch.models.uq import MLP, AleatoricUncertaintyNet  # noqa: E402
from jax_fast import fast  # noqa: E402
from test_templates_and_cv import template_files  # noqa: E402,F401

ROIS, OUT = 8, 8
LOSS_TOL = 1e-6
FWD_TOL = 1e-5
TRAIN_RTOL = 1e-4


def _jit(fn):
    return fast(jax.jit(fn))


def _params(flax_module, *args):
    """The flax init's params at PRNGKey(0) on `args`, as numpy."""
    return jax.device_get(_jit(flax_module.init)(jax.random.PRNGKey(0), *args))["params"]


def _port(module, params):
    module.load_state_dict(from_flax(params, module))
    return module


@pytest.fixture(scope="module")
def table(tmp_path_factory):
    """A CSV of 24 scans: 8 ROI columns and an int column."""
    rng = np.random.default_rng(0)
    path = tmp_path_factory.mktemp("roi") / "rois.csv"
    cols = {f"roi_{i}": rng.uniform(0.5, 2.5, size=24) for i in range(ROIS)}
    cols["age"] = rng.integers(60, 90, size=24)
    pd.DataFrame(cols).to_csv(path, index=False)
    return str(path)


def test_image_dataset_items_match_jax(table):
    """Every item, before and after `set_mean_std` and `set_col_list`, and
    `get_mris` / `get_targets`, exactly."""
    port, ref = ImageDataset(table), JaxImageDataset(pd.read_csv(table))
    assert port.col_list == ref.col_list and "age" in port.col_list
    assert len(port) == len(ref) == 24

    def same():
        for i in range(len(ref)):
            for got, want in zip(port[i], ref[i]):
                assert got.dtype == want.dtype and np.array_equal(got, want), i
        assert np.array_equal(port.get_mris(), ref.get_mris())
        assert np.array_equal(port.get_targets(), ref.get_targets())

    same()
    for ds in (port, ref):
        ds.set_mean_std(ds.get_mris().mean(0), ds.get_mris().std(0))
    same()
    for ds in (port, ref):
        ds.set_col_list(["roi_0", "roi_3", "age"])
    same()
    cols = [f"roi_{i}" for i in range(ROIS)]
    port, ref = (cls(src, col_list=cols[:4], target_cols=cols[4:])
                 for cls, src in ((ImageDataset, table),
                                  (JaxImageDataset, pd.read_csv(table))))
    same()


@pytest.fixture(scope="module")
def convattn_init():
    """JAX's `ConvAttn(output_size=OUT)` and its init at PRNGKey(0) on a
    row of ROIS, run eagerly as `train_convattn` runs it (its trainer then
    finds the primitives compiled): the same params as the trainer's own
    start, which depends on the input's shape alone."""
    model = FlaxConvAttn(output_size=OUT)
    x = jnp.zeros((1, ROIS), jnp.float32)
    return model, jax.device_get(model.init(jax.random.PRNGKey(0), x))["params"]


def test_convattn_forward_matches_jax(convattn_init):
    rng = np.random.default_rng(1)
    x = rng.uniform(0.5, 2.5, size=(5, ROIS)).astype(np.float32)
    flax_model, params = convattn_init
    want = np.asarray(_jit(flax_model.apply)({"params": params}, jnp.asarray(x)))
    port = _port(ConvAttn(ROIS, output_size=OUT, device="cpu"), params)
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=FWD_TOL, atol=FWD_TOL)


def test_train_convattn_matches_jax(table, convattn_init):
    """Two epochs from JAX's initial weights (its trainer's
    `init(PRNGKey(seed), xs[:1])`), two batches of 12 in the order of
    `default_rng(seed)`: each epoch's loss within 1e-4 relative; without
    `params` the port draws its own start from the seed."""
    ds = ImageDataset(table, col_list=[f"roi_{i}" for i in range(ROIS)])
    ref_ds = JaxImageDataset(pd.read_csv(table), col_list=ds.col_list)
    weights = np.linspace(0.5, 1.5, OUT).astype(np.float32)
    flax_model, init = convattn_init
    _, want = jax_train_convattn(flax_model, ref_ds, weights, epochs=2, lr=1e-3,
                                 batch_size=12, seed=0)
    port = ConvAttn(ROIS, output_size=OUT, device="cpu")
    start = from_flax(init, port)
    state, got = train_convattn(port, ds, weights, epochs=2, lr=1e-3, batch_size=12,
                                seed=0, params=start)
    assert len(got) == 2 and all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=TRAIN_RTOL)
    assert not torch.equal(state["fc1.weight"], start["fc1.weight"])
    again = train_convattn(port, ds, weights, epochs=1, seed=3)[1]
    assert again == train_convattn(port, ds, weights, epochs=1, seed=3)[1]


def _pred_target(rng, n=6, c=4):
    pred = rng.normal(size=(n, c)).astype(np.float32)
    target = rng.normal(size=(n, c)).astype(np.float32)
    pred[:, -1] = 1.5  # a constant column: WeightedCCCL's NaN case
    return pred, target


@pytest.mark.parametrize("name", ["weighted_mse", "weighted_l1", "weighted_cc",
                                  "weighted_cccl"])
def test_weighted_losses_match_jax(name):
    rng = np.random.default_rng(2)
    pred, target = _pred_target(rng)
    w = np.abs(rng.normal(size=pred.shape[1])).astype(np.float32)
    want = float(_jit(getattr(jax_weighted, name))(*map(jnp.asarray, (pred, target, w))))
    got = float(getattr(port_weighted, name)(*map(torch.from_numpy, (pred, target, w))))
    assert np.isfinite(got)
    np.testing.assert_allclose(got, want, rtol=LOSS_TOL, atol=LOSS_TOL)
    assert getattr(port_losses, name) is getattr(port_weighted, name)


@pytest.mark.parametrize("pos_rows", [0, 3])
def test_npair_loss_matches_jax(pos_rows):
    """The positive template as one [E] vector or one per row [B, E]."""
    rng = np.random.default_rng(3)
    anchor = rng.normal(size=(3, 12)).astype(np.float32)
    pos = rng.normal(size=(pos_rows, 12) if pos_rows else (12,)).astype(np.float32)
    negs = rng.normal(size=(7, 12)).astype(np.float32)
    want = float(_jit(jax_contrastive.npair_loss)(*map(jnp.asarray, (anchor, pos, negs))))
    got = float(port_losses.npair_loss(*map(torch.from_numpy, (anchor, pos, negs))))
    np.testing.assert_allclose(got, want, rtol=LOSS_TOL, atol=LOSS_TOL)


@pytest.mark.parametrize("temperature", [1.0, 0.5])
def test_cluster_npair_loss_matches_jax(temperature):
    rng = np.random.default_rng(4)
    shapes = [(2, 8), (2, 16)]
    a, p = ([rng.normal(size=s).astype(np.float32) for s in shapes] for _ in range(2))
    n = [rng.normal(size=(s[0], 7, s[1])).astype(np.float32) for s in shapes]
    want = float(_jit(lambda *t: jax_contrastive.cluster_npair_loss(
        *t, temperature=temperature))(*([list(map(jnp.asarray, t)) for t in (a, p, n)])))
    got = float(port_losses.cluster_npair_loss(
        *([list(map(torch.from_numpy, t)) for t in (a, p, n)]), temperature=temperature))
    assert got > 0
    np.testing.assert_allclose(got, want, rtol=LOSS_TOL, atol=LOSS_TOL)


def test_heteroscedastic_loss_matches_jax():
    rng = np.random.default_rng(5)
    q, q_hat = (rng.normal(size=6).astype(np.float32) for _ in range(2))
    s2 = rng.uniform(0.2, 2.0, size=6).astype(np.float32)
    want = float(_jit(jax_contrastive.heteroscedastic_loss)(
        *map(jnp.asarray, (q, q_hat, s2))))
    got = float(port_losses.heteroscedastic_loss(*map(torch.from_numpy, (q, q_hat, s2))))
    np.testing.assert_allclose(got, want, rtol=LOSS_TOL, atol=LOSS_TOL)


def test_uq_heads_match_jax():
    """`MLP` (two hidden layers, softmax over 3 classes) and
    `AleatoricUncertaintyNet` on [B, F] and [B, 1, F] features."""
    rng = np.random.default_rng(6)
    x = rng.normal(size=(4, 10)).astype(np.float32)
    q_hat = rng.normal(size=4).astype(np.float32)
    flax_mlp = FlaxMLP(hidden_layers=(16, 8), num_classes=3)
    params = _params(flax_mlp, jnp.asarray(x))
    want = np.asarray(_jit(flax_mlp.apply)({"params": params}, jnp.asarray(x)))
    mlp = _port(MLP(10, (16, 8), 3, device="cpu"), params)
    with torch.no_grad():
        got = mlp(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=LOSS_TOL, atol=LOSS_TOL)

    flax_uq = FlaxAleatoric(hidden=16)
    params = _params(flax_uq, jnp.asarray(x), jnp.asarray(q_hat))
    uq = _port(AleatoricUncertaintyNet(10, hidden=16, device="cpu"), params)
    for feats in (x, x[:, None]):
        want = _jit(flax_uq.apply)({"params": params}, jnp.asarray(feats),
                                   jnp.asarray(q_hat))
        with torch.no_grad():
            got = uq(torch.from_numpy(feats), torch.from_numpy(q_hat))
        for g, w in zip(got, want):
            assert tuple(g.shape) == (4, 1)
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=LOSS_TOL,
                                       atol=LOSS_TOL)


@pytest.mark.parametrize("target,resize", [((8, 8, 8), False), ((6, 10, 8), False),
                                           ((8, 8, 8), True)])
def test_templates_match_jax(template_files, target, resize):
    """`load_quartile_templates` on the 8 quartile NIfTI files (padded and
    cropped to `target`, with and without the 2 mm resampling) and
    `select_npair_templates` for every (abeta, quartile), exactly."""
    pos, neg = template_files
    got = load_quartile_templates(pos, neg, target=target, resize=resize)
    want = jax_load_templates(pos, neg, target=target, resize=resize)
    for key in ("pos", "neg"):
        assert got[key].dtype == want[key].dtype == np.float32
        assert np.array_equal(got[key], want[key])
    for abeta in (0, 1):
        for quartile in (1, 2, 3, 4):
            for g, w in zip(select_npair_templates(got, abeta, quartile),
                            jax_select_templates(want, abeta, quartile)):
                assert np.array_equal(g, w)
    p, n = select_npair_templates(got, 1, 2)
    assert n.shape == (7, int(np.prod(target))) and p.max() == 11.0
    assert not np.isin(11.0, n)
