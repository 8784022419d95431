"""Covariate-conditioned 3-D attention U-Net (counterpart of
`coma_unet_tpu/models/attention_unet.py`, stage "full").

Covariate threading as in the JAX package: the ConvBlocks (head and
encoder) see the first `block_num_covars` covariates; the UpBlocks and the
1x1 reduce conv see all of them.

Kernel rule, by U-Net level: level 0 is the full resolution, level i is
2^i times smaller. The head, gate i and merge i belong to level i; the
transition blocks down i and up i belong to level i + 1, the deeper level
they connect. Blocks of levels 0 and 1 (and the reduce conv) run through the
kernel families' wrappers; deeper blocks use PyTorch's built-in ops, as the
JAX package leaves them to XLA. The rule does not look at tensor shapes, so
a small test configuration takes the same routes as the 128^3 flagship.

Under `depth_sharded` (`parallel/spatial.py`) the forward runs as it is on
one rank's depth slab: the blocks take the halos and the merged norm
statistics. The upsample's crop to its skip cuts depth on the last rank
alone: every other rank's slab is even at each level above the deepest, so
its upsample of n planes gives 2n, the skip's slab, while the last rank's
skip may hold an odd tail, 2n - 1, as the whole volume's does at 216^3; a
depth crop anywhere else is a fault and raises (`Slab.check_crop`). A crop
of H or W is the same on every plane.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch
from torch import nn

from coma_unet_tpu_torch.models.blocks import (
    AttentionGate,
    CondConvolution,
    ConvBlock,
    Convolution,
    UpBlock,
    current_slab,
    resolve_device,
)

KERNEL_LEVELS = 2  # levels 0 .. KERNEL_LEVELS - 1 run on the kernels


def uses_kernels(level: int) -> bool:
    return level < KERNEL_LEVELS


def _cubic(v) -> int:
    t = (v,) * 3 if isinstance(v, int) else tuple(v)
    if len(set(t)) != 1:
        raise NotImplementedError(f"non-cubic size {v} is not ported")
    return t[0]


@dataclass
class UNetFeatures:
    out: torch.Tensor                     # [B, out_channels, D, H, W]
    encoder: Tuple[torch.Tensor, ...]     # per-level encoder features
    decoder: Tuple[torch.Tensor, ...]     # per-level merged decoder features
    attention: Tuple[torch.Tensor, ...]   # psi maps, top level first


class AttentionUNet(nn.Module):
    """The encoder-decoder backbone (reduce conv included). It builds on the
    GPU unless `device` says otherwise, and raises where there is none."""

    def __init__(self, config, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        cfg = self.config = config
        device = resolve_device(device)
        common = dict(dtype=getattr(torch, cfg.compute_dtype),
                      param_dtype=getattr(torch, cfg.param_dtype),
                      device=device, generator=generator)
        ch = cfg.channels
        strides = [_cubic(s) for s in cfg.strides]
        k, up_k = _cubic(cfg.kernel_size), _cubic(cfg.up_kernel_size)
        self.depth = len(ch)
        block = dict(kernel_size=k, dropout=cfg.dropout,
                     conditional=cfg.conditional,
                     num_covars=cfg.block_num_covars,
                     num_experts=cfg.num_experts, film=cfg.film,
                     norm=cfg.norm, **common)
        self.head = ConvBlock(cfg.in_channels, ch[0], strides=1,
                              kernels=uses_kernels(0), **block)
        for i in range(self.depth - 1):
            setattr(self, f"down{i}", ConvBlock(
                ch[i], ch[i + 1], strides=strides[i],
                kernels=uses_kernels(i + 1), **block))
        for i in range(self.depth - 2, -1, -1):
            setattr(self, f"up{i}", UpBlock(
                ch[i + 1], ch[i], strides=strides[i], kernel_size=up_k,
                dropout=cfg.dropout, conditional=cfg.conditional,
                num_covars=cfg.num_covars, num_experts=cfg.num_experts,
                film=cfg.film, norm=cfg.norm,
                kernels=uses_kernels(i + 1), **common))
            setattr(self, f"gate{i}", AttentionGate(
                max(ch[i] // 2, 1), ch[i], ch[i], norm=cfg.norm,
                kernels=uses_kernels(i), **common))
            setattr(self, f"merge{i}", Convolution(
                2 * ch[i], ch[i], kernel_size=3, act="prelu", norm=cfg.norm,
                dropout=cfg.dropout, kernels=uses_kernels(i), **common))
        if cfg.conditional:
            self.reduce = CondConvolution(
                ch[0], cfg.out_channels, kernel_size=1, conv_only=True,
                num_experts=cfg.num_experts, num_covars=cfg.num_covars,
                film=cfg.film, kernels=True, **common)
        else:
            self.reduce = Convolution(ch[0], cfg.out_channels, kernel_size=1,
                                      conv_only=True, kernels=True, **common)

    def forward(self, x: torch.Tensor,
                covariate: Optional[torch.Tensor] = None) -> UNetFeatures:
        cfg = self.config
        cov_block = cov_full = None
        if cfg.conditional and covariate is not None:
            cov_full = covariate.reshape(covariate.shape[0], -1)
            cov_block = cov_full[:, :cfg.block_num_covars]

        h = self.head(x, cov_block)
        encoder = [h]
        for i in range(self.depth - 1):
            h = getattr(self, f"down{i}")(h, cov_block)
            encoder.append(h)

        attention: List[Optional[torch.Tensor]] = [None] * (self.depth - 1)
        decoder_rev: List[torch.Tensor] = []
        d = encoder[-1]
        for i in range(self.depth - 2, -1, -1):
            up = getattr(self, f"up{i}")(d, cov_full)
            if up.shape[2:] != encoder[i].shape[2:]:
                # odd level sizes (216^3: 216 -> 108 -> 54 -> 27 -> 14, and
                # the up 14 -> 28 meets the skip of 27): crop the upsample
                # to the skip, as the JAX package does
                ed, eh, ew = encoder[i].shape[2:]
                slab = current_slab()
                if slab is not None and up.shape[2] != ed:
                    slab.check_crop(up.shape[2], ed)
                up = up[:, :, :ed, :eh, :ew]
            att, psi = getattr(self, f"gate{i}")(up, encoder[i])
            merged = getattr(self, f"merge{i}")(torch.cat([att, up], dim=1))
            attention[i] = psi
            decoder_rev.append(merged)
            d = merged

        if cfg.conditional:
            out = self.reduce(d, cov_full)
        else:
            out = self.reduce(d)
        return UNetFeatures(out=out, encoder=tuple(encoder),
                            decoder=tuple(reversed(decoder_rev)),
                            attention=tuple(attention))
