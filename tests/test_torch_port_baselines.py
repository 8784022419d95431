"""The port's model registry and baselines (`coma_unet_tpu_torch/models/
registry.py`, `baselines.py`, `swin.py`) and the blocks they added (batch
norm, dropout, gelu, Dense, LayerNorm) against the JAX package's, on the
CPU at f32.

Both sides take the same parameters: seeded numpy values for every leaf
of the flax variable tree (its shapes from `jax.eval_shape` of the init,
so no init is compiled), bridged by `from_flax`, batch norm's running
statistics included. The JAX models that reach Pallas run their plain XLA
reference (`pallas_convs=False`), as the existing port tests run them.
Shapes follow `tests/test_baselines.py`: 16^3 b=2, channels (4, 8, 16) for
UNET and the attention U-Nets; 32^3 b=2, hidden 64, 4 layers, 4 heads,
patch 16, feature size 4 for UNETR; 32^3 b=2, embed 8, depths (2, 2),
heads (2, 4) for Swin. Tolerances: forward rtol = atol = 1e-4, batch
statistics 1e-5.
"""

import math

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import flax.linen as fnn  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from coma_unet_tpu.config import ModelConfig as JaxModelConfig  # noqa: E402
from coma_unet_tpu.models import baselines as jax_baselines  # noqa: E402
from coma_unet_tpu.models import blocks as jax_blocks  # noqa: E402
from coma_unet_tpu.models import registry as jax_registry  # noqa: E402
from coma_unet_tpu.models import swin as jax_swin  # noqa: E402
from coma_unet_tpu_torch import ModelConfig, ops  # noqa: E402
from coma_unet_tpu_torch.convert import from_flax  # noqa: E402
from coma_unet_tpu_torch.models.attention_unet import KERNEL_LEVELS  # noqa: E402
from coma_unet_tpu_torch.models import registry  # noqa: E402
from coma_unet_tpu_torch.models.baselines import UNETR, SelfAttention  # noqa: E402
from coma_unet_tpu_torch.models.blocks import (  # noqa: E402
    Dropout,
    Norm,
    seed_dropout,
)
from coma_unet_tpu_torch.models.swin import (  # noqa: E402
    SwinUNETR,
    rel_pos_index,
    shift_mask,
)
from coma_unet_tpu_torch.ops.conv3d import conv3d_ref  # noqa: E402

B = 2
TOL = dict(rtol=1e-4, atol=1e-4)
STATS_TOL = dict(rtol=1e-5, atol=1e-5)
ARGS = ("mri", "covars", "roi_loc", "roi_std", "roi_compact")
TINY = dict(channels=(4, 8, 16), strides=(2, 2, 2), latent_spaces=(32,) * 3,
            prompt_shape=(16, 16, 16), num_experts=4, compute_dtype="float32")
JAX_ONLY = dict(pallas_convs=False, packed_level=False, remat=False)
UNETR_KW = dict(hidden_size=64, num_layers=4, num_heads=4, patch_size=16,
                feature_size=4)
SWIN_KW = dict(embed_dim=8, depths=(2, 2), num_heads=(2, 4), window=4)


def _batch(rng, s, b=B, r=5):
    mri = rng.uniform(0.0, 1.0, size=(b, 1, s, s, s)).astype(np.float32)
    covars = rng.normal(size=(b, 6)).astype(np.float32)
    covars[:, 0] = np.resize([1.0, 0.0], b)
    return {
        "mri": mri, "covars": covars,
        "roi_loc": rng.uniform(0.5, 2.0, size=(b, r)).astype(np.float32),
        "roi_std": rng.uniform(0.0, 0.5, size=(b, r)).astype(np.float32),
        "roi_compact": rng.integers(0, r + 1, size=(b, s, s, s)).astype(np.int32),
        "tau": rng.uniform(0.0, 2.0, size=(b, 1, s, s, s)).astype(np.float32),
    }


def _leaf(rng, path, shape):
    """A value for one flax leaf: weights at a 1/sqrt(fan_in) scale, norm
    scales near 1, running variances positive, everything else small."""
    name, owner = path[-1], path[-2] if len(path) > 1 else ""
    if name == "var":
        return rng.uniform(0.5, 1.5, size=shape)
    if name == "scale":
        return 1.0 + 0.1 * rng.normal(size=shape)
    if name == "alpha":
        return 0.25 + 0.05 * rng.normal(size=shape)
    if name in ("kernel", "experts"):
        if len(shape) == 2:
            fan_in = shape[0]
        elif len(shape) == 3:  # DenseGeneral: query/key/value, out
            fan_in = shape[0] if owner != "out" else shape[0] * shape[1]
        else:
            fan_in = math.prod(shape[-4:])
        return rng.normal(size=shape) / math.sqrt(fan_in)
    return 0.05 * rng.normal(size=shape)


def _variables(model, rng, *inputs, **kwargs):
    """Seeded numpy values in the shape of `model.init(...)`'s tree."""
    shapes = jax.eval_shape(lambda k: model.init(k, *inputs, **kwargs),
                            jax.random.PRNGKey(0))
    flat = jax.tree_util.tree_flatten_with_path(shapes)[0]
    treedef = jax.tree_util.tree_structure(shapes)
    leaves = [_leaf(rng, tuple(getattr(p, "key", str(p)) for p in path),
                    s.shape).astype(np.float32) for path, s in flat]
    return jax.tree_util.tree_unflatten(treedef, leaves)


def _models(name, norm="instance", dropout=0.0):
    """(flax model, port model, volume size) for a registry type at the
    test widths."""
    if name in ("AttnUNET", "GenAttnUnet", "UNET"):
        kw = dict(TINY, norm=norm, dropout=dropout)
        jm = jax_registry.build_model(name, JaxModelConfig(**kw, **JAX_ONLY))
        pm = registry.build_model(name, ModelConfig(**kw), device="cpu")
        return jm, pm, 16
    gates = name.startswith("Attn")
    common = dict(attention_gates=gates, norm=norm)
    if "UNETR" in name:
        return (jax_baselines.UNETR(dtype=jnp.float32, **common, **UNETR_KW),
                UNETR(img_size=32, dtype=torch.float32, device="cpu", **common,
                      **UNETR_KW), 32)
    return (jax_swin.SwinUNETR(dtype=jnp.float32, **common, **SWIN_KW),
            SwinUNETR(img_size=32, dtype=torch.float32, device="cpu", **common,
                      **SWIN_KW), 32)


def _setup(name, seed, norm="instance", dropout=0.0):
    rng = np.random.default_rng(seed)
    jm, pm, s = _models(name, norm, dropout)
    batch = _batch(rng, s)
    inputs = tuple(jnp.asarray(batch[k]) for k in ARGS)
    variables = _variables(jm, rng, *inputs, train=False)
    pm.load_state_dict(from_flax(variables["params"], pm,
                                 variables.get("batch_stats")))
    return jm, pm, batch, inputs, variables


def _port_forward(pm, batch):
    return pm(*(torch.from_numpy(batch[k]) for k in ARGS))


BASELINES = [t for t in registry.MODEL_TYPES if t != "ContraAttnUNET"]


@pytest.mark.parametrize("name", BASELINES)
def test_forward_matches_jax(name):
    """Every baseline of the registry, eval mode, against `model.apply`
    (the gated variants and the plain ones)."""
    jm, pm, batch, inputs, variables = _setup(name, BASELINES.index(name))
    want = np.asarray(jax.jit(lambda v: jm.apply(v, *inputs, train=False))(
        variables))
    with torch.no_grad():
        got = _port_forward(pm.eval(), batch)
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    assert tuple(got.shape) == want.shape == batch["mri"].shape
    assert (got >= 0).all() and want.max() > 0
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("train", [False, True])
def test_batch_norm_model_matches_jax(train):
    """UNET with `norm="batch"`: in eval mode the running statistics serve;
    in train mode the batch's, and the running ones move as flax's
    `batch_stats` do."""
    jm, pm, batch, inputs, variables = _setup("UNET", 20, norm="batch")
    if train:
        want, new_vars = jax.jit(lambda v: jm.apply(
            v, *inputs, train=True, mutable=["batch_stats"]))(variables)
    else:
        want = jax.jit(lambda v: jm.apply(v, *inputs, train=False))(variables)
    pm.train(train)
    with torch.no_grad():
        got = _port_forward(pm, batch)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    stats = {k: v for k, v in pm.state_dict().items()
             if k.endswith((".mean", ".var"))}
    assert stats and not any("num_batches_tracked" in k for k in pm.state_dict())
    new_stats = (new_vars if train else variables)["batch_stats"]
    want_stats = from_flax(variables["params"], pm, new_stats)
    moved = 0
    for key, value in stats.items():
        np.testing.assert_allclose(value.numpy(), want_stats[key].numpy(),
                                   err_msg=key, **STATS_TOL)
        before = from_flax(variables["params"], pm, variables["batch_stats"])[key]
        moved += not torch.equal(value, before)
    assert moved == (len(stats) if train else 0)


def test_batch_norm_block_matches_flax():
    """`Norm("batch")` against flax `Norm(kind="batch")`: momentum 0.9,
    eps 1e-5, statistics over (B, D, H, W), the biased variance (at
    n = 2 * 4^3 the unbiased one differs by 0.8 %), f32 out."""
    rng = np.random.default_rng(3)
    x = (rng.normal(size=(2, 3, 4, 4, 4)) * 2.0 + 1.0).astype(np.float32)
    flax_norm = jax_blocks.Norm(kind="batch")
    variables = _variables(flax_norm, rng, jnp.asarray(x), train=False)
    port = Norm("batch", 3, device="cpu")
    port.load_state_dict(from_flax(variables["params"], port,
                                   variables["batch_stats"]))
    y, new = flax_norm.apply(variables, jnp.asarray(x), train=True,
                             mutable=["batch_stats"])
    got = port.train()(torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(y), **STATS_TOL)
    for leaf in ("mean", "var"):
        np.testing.assert_allclose(getattr(port.bnorm, leaf).numpy(),
                                   np.asarray(new["batch_stats"]["bnorm"][leaf]),
                                   **STATS_TOL)
    biased = x.transpose(1, 0, 2, 3, 4).reshape(3, -1).var(axis=1)
    batch_var = (port.bnorm.var.numpy()
                 - 0.9 * variables["batch_stats"]["bnorm"]["var"]) / 0.1
    np.testing.assert_allclose(batch_var, biased, rtol=1e-4)
    assert not np.allclose(batch_var, biased * 128 / 127, rtol=1e-3)
    y_eval = flax_norm.apply({"params": variables["params"],
                              "batch_stats": new["batch_stats"]},
                             jnp.asarray(x), train=False)
    before = port.bnorm.mean.clone()
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(y_eval), **STATS_TOL)
    assert torch.equal(port.bnorm.mean, before)


def test_dropout_model_is_identity_in_eval_and_matches_jax():
    """AttnUNET with dropout 0.2: with train=False equal to JAX's. Dropout
    keeps the blocks' norm, FiLM and activation in plain ops, as JAX's
    `_norm_act_ok` refuses them; K4 (here its plain version) serves only
    the attention gates' three convs at each kernel level, which take no
    dropout in JAX either."""
    jm, pm, batch, inputs, variables = _setup("AttnUNET", 30, dropout=0.2)
    assert sum(isinstance(m, Dropout) for m in pm.modules()) > 0
    want = jax.jit(lambda v: jm.apply(v, *inputs, train=False))(variables)
    ops.reset_counts()
    with torch.no_grad():
        got = _port_forward(pm.eval(), batch)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert ops.PLAIN_ON_CPU["norm_act"] == 3 * KERNEL_LEVELS
    assert ops.PLAIN_ON_CPU["s1"] > 0


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_dropout_in_train_mode(rate):
    """Keep rate within 3 sigma of 1 - rate, kept values scaled by
    1 / (1 - rate), the same mask again from the same seed, another from
    another seed, and the global generator untouched."""
    n = 200_000
    x = torch.ones(n)
    drop = Dropout(rate, seed=7).train()
    state = torch.get_rng_state()
    y = drop(x)
    assert torch.equal(torch.get_rng_state(), state)
    kept = y != 0
    sigma = math.sqrt(rate * (1 - rate) / n)
    assert abs(float(kept.float().mean()) - (1 - rate)) <= 3 * sigma
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1 / (1 - rate)))
    drop.reseed(7)
    assert torch.equal(drop(x), y)
    drop.reseed(8)
    assert not torch.equal(drop(x), y)
    assert torch.equal(drop.eval()(x), x)


def test_seed_dropout_gives_each_site_and_step_its_own_seed():
    cfg = ModelConfig(**dict(TINY, dropout=0.3))
    model = registry.build_model("GenAttnUnet", cfg, device="cpu")
    n = seed_dropout(model, 5, step=0)
    sites = [m for m in model.modules() if isinstance(m, Dropout)]
    assert n == len(sites) > 4
    seeds = [m.seed for m in sites]
    assert len(set(seeds)) == n
    seed_dropout(model, 5, step=0)
    assert [m.seed for m in sites] == seeds
    seed_dropout(model, 5, step=1)
    assert not set(m.seed for m in sites) & set(seeds)

    # through the train step: the same (seed, step) gives the same masks
    from coma_unet_tpu_torch import LossConfig
    from coma_unet_tpu_torch.train import make_optimizer, make_train_step

    batch = {k: torch.from_numpy(v)
             for k, v in _batch(np.random.default_rng(9), 16).items()}
    losses = []
    for seed in (3, 3, 4):
        copy = registry.build_model("GenAttnUnet", cfg, device="cpu")
        copy.load_state_dict(model.state_dict())
        step = make_train_step(copy, LossConfig(),
                               make_optimizer(copy.parameters(), 1e-3), seed=seed)
        losses.append(float(step(batch, torch.full((5,), 225.0))["loss"]))
    assert losses[0] == losses[1] != losses[2]


def test_swin_tables_and_shifted_blocks():
    """The window tables equal the JAX package's; the shifted blocks (every
    second one, shift window // 2) mask across the roll and change the
    output against the same blocks unshifted."""
    for w in (1, 2, 4):
        np.testing.assert_array_equal(rel_pos_index(w), jax_swin._rel_pos_index(w))
    for args in ((8, 8, 8, 4, 2), (16, 16, 16, 4, 2), (4, 4, 4, 2, 1)):
        np.testing.assert_array_equal(shift_mask(*args), jax_swin._shift_mask(*args))
    model = SwinUNETR(img_size=32, dtype=torch.float32, device="cpu",
                      generator=torch.Generator().manual_seed(0),
                      **dict(SWIN_KW, depths=(2,), num_heads=(2,))).eval()
    blocks = [model.swin.stage0_block0, model.swin.stage0_block1]
    assert [(b.window, b.shift) for b in blocks] == [(4, 0), (4, 2)]
    assert blocks[1].mask.shape == (64, 64, 64) and (blocks[1].mask < -1e8).any()
    assert "swin.stage0_block1.mask" not in model.state_dict()
    x = torch.from_numpy(_batch(np.random.default_rng(4), 32)["mri"])
    with torch.no_grad():
        shifted = model(x)
        blocks[1].shift = 0
        plain = model(x)
    assert float((shifted - plain).abs().max()) > 1e-3


def test_swin_window_shrinks_to_the_grid():
    """At 16^3 (patch 2: stages 8, 4, 2, 1) the window resolves to 4, 4, 2,
    1 and the shift to 2, 2, 0, 0; the bias table follows the window."""
    model = SwinUNETR(img_size=16, device="cpu", embed_dim=12,
                      dtype=torch.float32)
    got = [(getattr(model.swin, f"stage{s}_block1").window,
            getattr(model.swin, f"stage{s}_block1").shift) for s in range(4)]
    assert got == [(4, 2), (4, 2), (2, 0), (1, 0)]
    table = model.swin.stage2_block0.attn.rel_pos_bias
    assert tuple(table.shape) == (27, 12)


def test_build_model_for_every_type():
    """`build_model` builds each of the 8 types on the CPU at a small
    config (UNETR and Swin at their own widths), each runs a forward, and an
    unknown name raises ValueError naming the choices."""
    cfg = ModelConfig(channels=(4, 8), strides=(2, 2), latent_spaces=(16, 16),
                      prompt_shape=(16, 16, 16), num_experts=2,
                      compute_dtype="float32")
    classes = {"ContraAttnUNET": "ContraAttnUNet", "AttnUNET": "PlainAttentionUNet",
               "GenAttnUnet": "PlainAttentionUNet", "UNET": "UNet3D",
               "GenUNETR": "UNETR", "AttnUNETR": "UNETR",
               "SwinUnetr": "SwinUNETR", "AttnSwinUnetr": "SwinUNETR"}
    assert set(classes) == set(registry.MODEL_TYPES)
    batch = _batch(np.random.default_rng(5), 16, b=1, r=36)
    gated = {}
    for name in registry.MODEL_TYPES:
        model = registry.build_model(name, cfg, device="cpu",
                                     generator=torch.Generator().manual_seed(0))
        assert type(model).__name__ == classes[name], name
        assert {p.device.type for p in model.parameters()} == {"cpu"}
        with torch.no_grad():
            out = registry.apply_model(
                model.eval(), *(torch.from_numpy(batch[k]) for k in ARGS),
                with_projections=False).out
        assert tuple(out.shape) == (1, 1, 16, 16, 16), name
        assert bool(torch.isfinite(out).all()), name
        assert registry.has_attention_maps(model) == (name == "ContraAttnUNET")
        gated[name] = hasattr(model, "dec0_gate")
    assert [n for n, g in gated.items() if g] == ["AttnUNETR", "AttnSwinUnetr"]
    with pytest.raises(ValueError, match="NoSuchModel.*SwinUnetr"):
        registry.build_model("NoSuchModel", cfg, device="cpu")


def test_bridge_maps_attention_layer_norm_and_batch_stats():
    """flax's MultiHeadDotProductAttention (DenseGeneral kernels and
    biases) maps onto `SelfAttention` and agrees with it; LayerNorm's scale
    becomes its weight; the bridge stays strict about shapes, strays and
    missing running statistics."""
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 8, 16)).astype(np.float32)
    flax_attn = fnn.MultiHeadDotProductAttention(num_heads=4, dtype=jnp.float32)
    variables = _variables(flax_attn, rng, jnp.asarray(x), jnp.asarray(x))
    params = variables["params"]
    assert params["query"]["kernel"].shape == (16, 4, 4)
    assert params["out"]["kernel"].shape == (4, 4, 16)
    port = SelfAttention(16, 4, dtype=torch.float32, device="cpu")
    port.load_state_dict(from_flax(params, port))
    want = flax_attn.apply(variables, jnp.asarray(x), jnp.asarray(x))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)

    wrong = dict(params, key=dict(params["key"],
                                  kernel=np.zeros((16, 4, 2), np.float32)))
    with pytest.raises(ValueError, match="key.weight"):
        from_flax(wrong, port)
    with pytest.raises(ValueError, match="stray"):
        from_flax(dict(params, stray={"bias": np.zeros(2, np.float32)}), port)

    jm, pm, batch, inputs, variables = _setup("GenUNETR", 7)
    ln = variables["params"]["vit"]["block0"]["ln1"]["scale"]
    np.testing.assert_array_equal(pm.vit.block0.ln1.weight.detach().numpy(), ln)
    jm, pm, batch, inputs, variables = _setup("UNET", 8, norm="batch")
    with pytest.raises(ValueError, match="bnorm.mean"):
        from_flax(variables["params"], pm)
    stats = jax.tree.map(lambda a: a[:1], variables["batch_stats"])
    with pytest.raises(ValueError, match="bnorm"):
        from_flax(variables["params"], pm, stats)


@pytest.mark.parametrize("k,s", [(1, 1), (1, 2), (2, 1), (2, 2), (3, 1),
                                 (3, 2), (16, 16), (16, 2), (2, 16)])
def test_conv_same_padding_matches_jax(k, s):
    """`conv3d_ref` pads as JAX's `same_padding`, (k // 2, k - 1 - k // 2):
    for even k one less on the high side (the k=16 s=16 patch embedding
    gives 2^3 tokens at 32^3, Swin's k=2 s=2 16^3 at 32^3)."""
    rng = np.random.default_rng(k * 100 + s)
    size = 32 if k == 16 else 13
    x = rng.normal(size=(1, 2, size, size, size)).astype(np.float32)
    w = (rng.normal(size=(3, 2, k, k, k)) / math.sqrt(2 * k ** 3)).astype(np.float32)
    want = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (s, s, s),
        jax_blocks.same_padding((k, k, k)),
        dimension_numbers=("NCDHW", "OIDHW", "NCDHW"))
    got = conv3d_ref(torch.from_numpy(x), torch.from_numpy(w), stride=s)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    if (k, s) == (16, 16):
        assert want.shape[2:] == (2, 2, 2)
