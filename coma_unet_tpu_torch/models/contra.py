"""ContraAttnUNet, the flagship covariate-modulated contrastive model
(counterpart of `coma_unet_tpu/models/contra.py`): the attention U-Net
backbone plus
  * per-level contrastive projection heads and a final projection head
    (global average pool -> Dense -> ReLU),
  * learned pos/neg/general full-volume prompts,
  * the UQ modulator head, which paints per-ROI predicted tau mean ("loc")
    and std volumes and fuses them with the prompts and the U-Net output
    through small conv stacks.
The modulator's convs and the level-0/1 projection heads run through the
kernel families' wrappers (see `attention_unet.py`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
from torch import nn

from coma_unet_tpu_torch.models.attention_unet import (
    AttentionUNet,
    uses_kernels,
)
from coma_unet_tpu_torch.models.blocks import (
    Convolution,
    ProjectionHead,
    StackedFusionConvLayers,
    current_slab,
    dense_init_,
    resolve_device,
)
from coma_unet_tpu_torch.ops.roi import paint_roi_values


@dataclass
class ContraOutputs:
    out: torch.Tensor                          # synthesized volume [B,1,D,H,W]
    projections: Tuple[torch.Tensor, ...]      # per-level [B, Ni] embeddings
    final_projection: torch.Tensor             # [B, latent]
    encoder: Tuple[torch.Tensor, ...]          # encoder features
    attention: Tuple[torch.Tensor, ...]        # attention maps


class ContraAttnUNet(nn.Module):
    """forward(mri, covars, roi_loc, roi_std, roi_compact) -> ContraOutputs.

    `covars` [B, K] carries [abeta, age, sex, edu, cog, meta_tau];
    `roi_loc`/`roi_std` are the per-sample per-ROI prediction tables [B, R];
    `roi_compact` is the compacted ROI id volume [B, D, H, W], ids 0..R.
    Parameters are drawn from `generator` with the flax initializers. The
    model builds on the GPU unless `device` says otherwise (`device="cpu"`
    for the CPU, where the kernel wrappers run their plain versions), and
    raises where there is no GPU.
    """

    def __init__(self, config, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        cfg = self.config = config
        device = resolve_device(device)
        self.dtype = getattr(torch, cfg.compute_dtype)
        pdtype = getattr(torch, cfg.param_dtype)
        common = dict(dtype=self.dtype, param_dtype=pdtype, device=device,
                      generator=generator)
        self.unet = AttentionUNet(cfg, device=device, generator=generator)
        head_in = cfg.out_channels
        if cfg.with_modulator:
            if cfg.out_channels != 1:
                raise NotImplementedError(
                    "the modulator is ported for out_channels == 1")
            shape = (1, 1) + tuple(cfg.prompt_shape)
            for name in ("pos_dynamic_prompt", "neg_dynamic_prompt",
                         "general_dynamic_prompt"):
                prompt = torch.randn(shape, generator=generator)
                setattr(self, name, nn.Parameter(
                    prompt.to(device=device, dtype=pdtype)))
            self.deep_modulator_3c = StackedFusionConvLayers(
                3, 16, 1, num_convs=3, norm=cfg.norm, kernels=True, **common)
            self.fusion_layer = StackedFusionConvLayers(
                2, 8, 1, num_convs=3, norm=cfg.norm, kernels=True, **common)
            self.final_pred_head = Convolution(
                2, 1, kernel_size=1, act="prelu", norm=cfg.norm, kernels=True,
                **common)
            head_in = 1
        for i, c in enumerate(cfg.channels):
            setattr(self, f"proj{i}", ProjectionHead(
                c, norm=cfg.norm, kernels=uses_kernels(i), **common))
        self.final_proj = nn.Linear(head_in, cfg.latent_spaces[-1],
                                    dtype=pdtype, device=device)
        dense_init_(self.final_proj, generator)

    def forward(self, x: torch.Tensor,
                covariate: Optional[torch.Tensor] = None,
                roi_loc: Optional[torch.Tensor] = None,
                roi_std: Optional[torch.Tensor] = None,
                roi_compact: Optional[torch.Tensor] = None,
                with_projections: bool = True) -> ContraOutputs:
        cfg = self.config
        feats = self.unet(x, covariate)
        out = feats.out
        if cfg.with_modulator:
            out = self._modulator(x, out, covariate, roi_loc, roi_std,
                                  roi_compact)
        else:
            out = torch.relu(out.float())

        projections: Tuple[torch.Tensor, ...] = ()
        final_projection = torch.zeros((x.shape[0], cfg.latent_spaces[-1]),
                                       dtype=torch.float32, device=x.device)
        if with_projections:
            projections = tuple(
                getattr(self, f"proj{i}")(feats.encoder[i])
                for i in range(len(cfg.channels)))
            pooled = out.float().mean(dim=(2, 3, 4))
            final_projection = torch.relu(self.final_proj(pooled))
        return ContraOutputs(out=out.float(), projections=projections,
                             final_projection=final_projection,
                             encoder=feats.encoder, attention=feats.attention)

    def _modulator(self, x, out, covariate, roi_loc, roi_std, roi_compact):
        """The modulator head. Inside `depth_sharded` x is the rank's depth
        slab: the prompts are checked against the whole volume (the slab
        plan's depth) and the rank takes its slab of each; the brain mask
        and the painting are voxel-local."""
        cfg, dtype = self.config, self.dtype
        b = x.shape[0]
        slab = current_slab()
        volume = tuple(x.shape[2:5])
        prompts = (self.pos_dynamic_prompt, self.neg_dynamic_prompt,
                   self.general_dynamic_prompt)
        if slab is not None:
            volume = (slab.plan.sizes[0],) + volume[1:]
            prompts = tuple(slab.local(p) for p in prompts)
        if tuple(cfg.prompt_shape) != volume:
            raise ValueError(
                f"modulator prompts are {tuple(cfg.prompt_shape)} but input "
                f"spatial dims are {volume}; set "
                f"ModelConfig.prompt_shape accordingly")
        pos_prompt, neg_prompt, general_prompt = prompts
        if covariate is not None:
            abeta = covariate.reshape(b, -1)[:, 0]
        else:
            abeta = torch.zeros((b,), dtype=torch.float32, device=x.device)
        is_pos = (abeta == 1.0).reshape(b, 1, 1, 1, 1)
        prompt = torch.where(is_pos, pos_prompt, neg_prompt).to(dtype)

        if roi_loc is None or roi_compact is None:
            suvr = torch.zeros_like(out)
            saliency = torch.zeros_like(out)
        else:
            loc = torch.nan_to_num(roi_loc.float())
            std = (torch.nan_to_num(roi_std.float()) if roi_std is not None
                   else torch.zeros_like(loc))
            mask = x >= 1e-4   # zero outside the brain
            suvr = torch.where(mask, paint_roi_values(roi_compact, loc)[:, None],
                               0.0)
            saliency = torch.where(
                mask, paint_roi_values(roi_compact, std)[:, None], 0.0)

        mod_in = torch.cat([prompt.expand_as(out), saliency.to(dtype),
                            suvr.to(dtype)], dim=1)
        modulated = (general_prompt.to(dtype)
                     + self.deep_modulator_3c(mod_in))
        fused = self.fusion_layer(torch.cat([modulated, out.to(dtype)], dim=1))
        final = self.final_pred_head(torch.cat([out.to(dtype), fused], dim=1))
        return torch.relu(final.float())
