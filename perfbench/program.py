"""The program under test, as the generators build it: the port's model from
the configuration, holding the reference's weights of the seed, and the
seed's pool of batches."""

from __future__ import annotations

import gc

import torch

from perfbench.inputs import make_pool
from perfbench.reference import model as ref_model


def _port_config(fields: dict):
    from coma_unet_tpu_torch.config import ModelConfig

    return ModelConfig(**{k: tuple(v) if isinstance(v, list) else v
                          for k, v in fields.items()})


def build_program(ctx):
    """The program's model on the device, holding the reference's weights
    of the seed; (model, those weights)."""
    from coma_unet_tpu_torch.models.registry import build_model

    cfg = ctx.model_config()
    model_type = ctx.cell.config["model_type"]
    model = build_model(model_type, _port_config(cfg), device="meta")
    model = model.to_empty(device=ctx.device)
    weights = ref_model.init_params(model_type, cfg, ctx.seed, ctx.device)
    model.load_state_dict(weights, strict=True)
    return model, weights


def roi_weights(ctx) -> torch.Tensor:
    return torch.full((ctx.traffic["rois"],), ctx.loss_config()["roi_weight"],
                      dtype=torch.float32, device=ctx.device)


def pool_of(ctx):
    t = ctx.traffic
    return make_pool(ctx.seed, t["pool"], t["batch"], t["volume"], t["rois"],
                     ctx.device)


def free_program(ctx, state, keys) -> None:
    """Drop the program's objects from a generator's state and give their
    device memory back, before the reference runs."""
    for key in keys:
        state.pop(key, None)
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
