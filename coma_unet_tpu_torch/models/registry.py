"""The model registry behind `-model_type` (counterpart of
`coma_unet_tpu/models/registry.py`): ContraAttnUNET (the flagship),
AttnUNET and GenAttnUnet (the attention U-Net backbone with a ReLU head),
UNET, GenUNETR, AttnUNETR, SwinUnetr and AttnSwinUnetr.

Every model takes (mri, covars, roi_loc, roi_std, roi_compact,
with_projections=...); the baselines ignore all but the MRI and return the
synthesized volume alone.
`apply_model` gives every model's output the flagship's form
(`PlainOutputs` for a plain volume), so the train, eval and inference
paths serve them all, as the JAX package's `_PlainOutputs` does.

AttnUNET and GenAttnUnet run the flagship's backbone, whose levels 0-1 and
reduce conv go through the kernel families; the other five use PyTorch
built-ins throughout, as the JAX package leaves them to XLA.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Iterator, List, Optional, Tuple

import torch
from torch import nn

from coma_unet_tpu_torch.config import ModelConfig
from coma_unet_tpu_torch.models.attention_unet import AttentionUNet, _cubic
from coma_unet_tpu_torch.models.baselines import UNETR, UNet3D
from coma_unet_tpu_torch.models.contra import ContraAttnUNet
from coma_unet_tpu_torch.models.swin import SwinUNETR

MODEL_TYPES = (
    "ContraAttnUNET", "AttnUNET", "GenAttnUnet", "UNET",
    "GenUNETR", "AttnUNETR", "SwinUnetr", "AttnSwinUnetr",
)


class PlainAttentionUNet(nn.Module):
    """`GenAttnUnet` / non-contrastive `AttnUNET`: the attention U-Net
    backbone with a ReLU on its output, in f32; no projection heads, no
    modulator."""

    def __init__(self, config: ModelConfig, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.config = config
        self.unet = AttentionUNet(config, device=device, generator=generator)

    def forward(self, x: torch.Tensor, covariate=None, roi_loc=None,
                roi_std=None, roi_compact=None,
                with_projections: bool = True) -> torch.Tensor:
        return torch.relu(self.unet(x, covariate).out.float())


def build_model(model_type: str, config: Optional[ModelConfig] = None,
                device=None, generator: Optional[torch.Generator] = None
                ) -> nn.Module:
    """The model `model_type` names, at `config`'s widths: UNET takes its
    channels and `strides[:-1]`, the UNETR and Swin pairs their defaults
    with its norm, the volume size of `prompt_shape` and its dtypes. Built
    on the GPU unless `device` says otherwise; parameters drawn from
    `generator`."""
    if model_type not in MODEL_TYPES:
        raise ValueError(f"unknown model_type {model_type!r}; choose from "
                         f"{MODEL_TYPES}")
    cfg = config or ModelConfig()
    if model_type == "ContraAttnUNET":
        return ContraAttnUNet(cfg, device=device, generator=generator)
    if model_type in ("AttnUNET", "GenAttnUnet"):
        return PlainAttentionUNet(cfg, device=device, generator=generator)
    common = dict(in_channels=cfg.in_channels, out_channels=cfg.out_channels,
                  norm=cfg.norm, dtype=getattr(torch, cfg.compute_dtype),
                  param_dtype=getattr(torch, cfg.param_dtype), device=device,
                  generator=generator)
    if model_type == "UNET":
        return UNet3D(channels=cfg.channels,
                      strides=[_cubic(s) for s in cfg.strides[:-1]], **common)
    size = _cubic(cfg.prompt_shape)
    if model_type in ("GenUNETR", "AttnUNETR"):
        return UNETR(img_size=size, attention_gates=model_type == "AttnUNETR",
                     **common)
    return SwinUNETR(img_size=size,
                     attention_gates=model_type == "AttnSwinUnetr", **common)


@dataclass
class PlainOutputs:
    """A plain volume in the flagship's output form: no projections, no
    attention maps."""
    out: torch.Tensor
    projections: Tuple[torch.Tensor, ...] = ()
    final_projection: Optional[torch.Tensor] = None
    attention: Tuple[torch.Tensor, ...] = ()


MODEL_INPUTS = ("mri", "covars", "roi_loc", "roi_std", "roi_compact")


def apply_model(model: nn.Module, mri, covars=None, roi_loc=None,
                roi_std=None, roi_compact=None, with_projections: bool = True):
    """`model`'s forward, its output in the flagship's form: a plain volume
    comes back as `PlainOutputs`."""
    outs = model(mri, covars, roi_loc, roi_std, roi_compact,
                 with_projections=with_projections)
    return outs if hasattr(outs, "out") else PlainOutputs(out=outs)


def has_attention_maps(model: nn.Module) -> bool:
    """Whether the model's output carries the attention gates' psi maps
    and the encoder features: the flagship's does; the baselines return
    the volume alone, as in the JAX package, gated or not."""
    return isinstance(model, ContraAttnUNet)


def device_args(model: nn.Module, batch) -> List[Optional[torch.Tensor]]:
    """`apply_model`'s inputs after the model, `MODEL_INPUTS` of `batch`
    (a dict of arrays or tensors) on the model's device; a missing one is
    None."""
    device = next(model.parameters()).device
    return [None if batch.get(k) is None
            else torch.as_tensor(batch[k], device=device) for k in MODEL_INPUTS]


@contextlib.contextmanager
def eval_mode(model: nn.Module) -> Iterator[nn.Module]:
    """`model` in eval mode for the block (batch norm on its running
    statistics, which stay as they are; no dropout), as the JAX package's
    `train=False`; its earlier mode comes back after."""
    was_training = model.training
    model.eval()
    try:
        yield model
    finally:
        model.train(was_training)
