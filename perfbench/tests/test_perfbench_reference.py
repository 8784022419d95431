"""The plain reference against the program's CPU path at a tiny size: the
same weights (loaded into the program from the reference's initializer),
the same batch, float32."""

import dataclasses

import pytest
import torch

from coma_unet_tpu_torch import LossConfig, ModelConfig, build_model
from coma_unet_tpu_torch.models.registry import apply_model
from coma_unet_tpu_torch.train.optim import make_optimizer
from coma_unet_tpu_torch.train.step import make_train_step
from perfbench.inputs import make_pool
from perfbench.reference import model as ref_model
from perfbench.reference import train as ref_train

CFG = ModelConfig(channels=(4, 8, 16), strides=(2, 2, 2),
                  latent_spaces=(32,) * 3, prompt_shape=(16, 16, 16),
                  num_experts=4, compute_dtype="float32")
ROIS = 5
TYPES = ("ContraAttnUNET", "AttnUNET")


def _setup(model_type, seed=7):
    cfg = dataclasses.asdict(CFG)
    model = build_model(model_type, CFG, device="cpu")
    weights = ref_model.init_params(model_type, cfg, seed, torch.device("cpu"))
    model.load_state_dict(weights, strict=True)
    pool = make_pool(seed, 3, 2, 16, ROIS, torch.device("cpu"))
    return cfg, model, weights, pool


@pytest.mark.parametrize("model_type", TYPES)
def test_names_and_shapes_match_the_program(model_type):
    cfg, model, weights, _ = _setup(model_type)
    state = model.state_dict()
    assert list(state) == list(weights)
    assert all(state[n].shape == weights[n].shape for n in state)


@pytest.mark.parametrize("model_type", TYPES)
def test_forward_matches_the_program(model_type):
    cfg, model, weights, pool = _setup(model_type)
    b = pool[0]
    args = [b[k] for k in ("mri", "covars", "roi_loc", "roi_std", "roi_compact")]
    with torch.no_grad():
        outs = apply_model(model, *args, with_projections=True)
        out, projections = ref_model.forward(weights, model_type, cfg, *args)
    scale = float(out.abs().max())
    assert float((outs.out - out).abs().max()) <= 1e-5 * scale
    assert len(outs.projections) == len(projections)
    for a, r in zip(outs.projections, projections):
        assert float((a - r).abs().max()) <= 1e-5 * max(float(r.abs().max()), 1.0)


@pytest.mark.parametrize("model_type", TYPES)
def test_three_train_steps_match_the_program(model_type):
    cfg, model, weights, pool = _setup(model_type)
    lcfg = LossConfig()
    optimizer = make_optimizer(model.parameters(), 1e-3, 0.01)
    step = make_train_step(model, lcfg, optimizer)
    rw = torch.full((ROIS,), lcfg.roi_weight)
    losses = [float(step(b, rw)["loss"]) for b in pool]
    ref = {n: w.clone() for n, w in weights.items()}
    ref_losses, first, _ = ref_train.train_steps(
        ref, model_type, cfg, dataclasses.asdict(lcfg), pool, rw, 1e-3, 0.01)
    assert losses[0] == pytest.approx(ref_losses[0], rel=1e-6)
    # later steps start from weights that round-off leaves (moved by Adam's
    # sign of a near-zero gradient) have pulled apart a little
    assert losses[1:] == pytest.approx(ref_losses[1:], rel=1e-4)
    # the leaves without a gradient are the same on both sides
    got = {n for n, p in model.named_parameters() if p in optimizer.state}
    assert got == {n for n, g in first.items() if g is not None}
    state = model.state_dict()
    for n in got:
        # a leaf whose gradient is round-off moves by up to lr a step on
        # either side in Adam, so the bound is three steps of lr
        assert float((state[n] - ref[n]).abs().max()) <= 6e-3, n


def test_init_is_a_function_of_the_seed():
    cfg = dataclasses.asdict(CFG)
    a = ref_model.init_params("ContraAttnUNET", cfg, 2 ** 31 + 5, torch.device("cpu"))
    b = ref_model.init_params("ContraAttnUNET", cfg, 2 ** 31 + 5, torch.device("cpu"))
    c = ref_model.init_params("ContraAttnUNET", cfg, 2 ** 31 + 6, torch.device("cpu"))
    assert all(torch.equal(a[n], b[n]) for n in a)
    assert not torch.equal(a["unet.head.conv1.experts"], c["unet.head.conv1.experts"])
    w = a["unet.head.conv1.experts"]
    assert float(w.abs().max()) <= 1.0 / (4 * 27) ** 0.5
    d = a["unet.head.conv0.route.weight"]
    assert float(d.abs().max()) <= 2.0 * (1.0 / 5) ** 0.5 / ref_model.TRUNC_STD
