"""SwinUNETR baselines, `SwinUnetr` and `AttnSwinUnetr` (counterpart of
`coma_unet_tpu/models/swin.py`): a 3-D shifted-window transformer encoder
and a UNETR-style conv decoder; `attention_gates` gates the skips.

Window attention is batched matmuls over [windows, w^3, C] in the compute
dtype, with the logits, the relative-position bias, the shift mask and the
softmax in f32. As in the JAX package every conv and norm is a PyTorch
built-in (no `use_pallas` there) and no kernel family is launched.

The JAX encoder resolves each stage's window from the token grid at trace
time; this one does it at construction, from the volume size
(`ModelConfig.prompt_shape`): the relative-position bias table's shape
follows the resolved window. The index and shift-mask tables are
non-persistent buffers, outside the state dict.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from coma_unet_tpu_torch.models.baselines import _common
from coma_unet_tpu_torch.models.blocks import (
    AttentionGate,
    ConvBlock,
    Convolution,
    Dense,
    LayerNorm,
    _fill_,
    gelu,
)


@lru_cache(maxsize=8)
def rel_pos_index(w: int) -> np.ndarray:
    """Relative position index table of a w^3 window: [w^3, w^3] ints in
    [0, (2w-1)^3)."""
    coords = np.stack(
        np.meshgrid(np.arange(w), np.arange(w), np.arange(w), indexing="ij"),
        axis=-1,
    ).reshape(-1, 3)
    rel = coords[:, None, :] - coords[None, :, :] + (w - 1)
    return (rel[..., 0] * (2 * w - 1) ** 2 + rel[..., 1] * (2 * w - 1)
            + rel[..., 2]).astype(np.int64)


@lru_cache(maxsize=32)
def shift_mask(d: int, h: int, wdim: int, w: int, shift: int) -> np.ndarray:
    """Attention mask of the shifted windows: [windows, w^3, w^3], 0 for
    pairs of one region and -1e9 for pairs the roll brought together."""
    img = np.zeros((d, h, wdim), np.int32)
    cnt = 0
    slices = (slice(0, -w), slice(-w, -shift), slice(-shift, None))
    for sd in slices:
        for sh in slices:
            for sw in slices:
                img[sd, sh, sw] = cnt
                cnt += 1
    win = (img.reshape(d // w, w, h // w, w, wdim // w, w)
           .transpose(0, 2, 4, 1, 3, 5).reshape(-1, w ** 3))
    return (win[:, None, :] != win[:, :, None]).astype(np.float32) * -1e9


def resolve_window(grid: int, window: int, shift: int):
    """The JAX encoder's rule: halve the window until it divides the grid
    (and fits in it); keep the shift where the window is over 1 voxel and
    the shift under it, else 0. Returns (window, shift)."""
    w = window
    while grid % w != 0 or w > grid:
        w //= 2
    return max(w, 1), (shift if w > 1 and shift < w else 0)


class WindowAttention(nn.Module):
    """Multi-head attention inside each window, with a learned relative
    position bias `rel_pos_bias` [(2w-1)^3, heads]."""

    def __init__(self, channels: int, num_heads: int, window: int,
                 dtype=torch.bfloat16, param_dtype=torch.float32,
                 device=None, generator=None):
        super().__init__()
        self.num_heads, self.dtype = num_heads, dtype
        common = dict(dtype=dtype, param_dtype=param_dtype, device=device,
                      generator=generator)
        self.qkv = Dense(channels, 3 * channels, **common)
        self.rel_pos_bias = nn.Parameter(torch.empty(
            ((2 * window - 1) ** 3, num_heads), dtype=param_dtype,
            device=device))
        _fill_(self.rel_pos_bias, lambda t: t.normal_(0.0, 0.02,
                                                      generator=generator))
        self.register_buffer("rel_index", torch.from_numpy(
            rel_pos_index(window)).to(device), persistent=False)
        self.proj = Dense(channels, channels, **common)

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        nw, n, c = x.shape
        hd = c // self.num_heads
        qkv = self.qkv(x).reshape(nw, n, 3, self.num_heads, hd)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        attn = (q @ k.transpose(-2, -1)).float() / math.sqrt(hd)
        bias = self.rel_pos_bias[self.rel_index].permute(2, 0, 1)
        attn = attn + bias.float()[None]
        if mask is not None:
            attn = attn + mask[:, None]
        attn = torch.softmax(attn, dim=-1).to(self.dtype)
        out = (attn @ v).transpose(1, 2).reshape(nw, n, c)
        return self.proj(out)


class SwinBlock3D(nn.Module):
    """x + window attention of ln1(x) (rolled by -shift first and back
    after, masked where the roll joins regions), then x + MLP(ln2(x)) (4x
    wide), on a channels-last token grid [B, D, H, W, C] of side `grid`."""

    def __init__(self, channels: int, num_heads: int, window: int,
                 grid: int, shift: int = 0, dtype=torch.bfloat16,
                 param_dtype=torch.float32, device=None, generator=None):
        super().__init__()
        common = dict(dtype=dtype, param_dtype=param_dtype, device=device,
                      generator=generator)
        self.window, self.shift, self.dtype = window, shift, dtype
        self.ln1 = LayerNorm(channels, param_dtype, device)
        self.attn = WindowAttention(channels, num_heads, window, **common)
        self.ln2 = LayerNorm(channels, param_dtype, device)
        self.fc1 = Dense(channels, 4 * channels, **common)
        self.fc2 = Dense(4 * channels, channels, **common)
        mask = None
        if shift > 0:
            mask = torch.from_numpy(shift_mask(grid, grid, grid, window,
                                               shift)).to(device)
        self.register_buffer("mask", mask, persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, d, h, wd, c = x.shape
        w, s = self.window, self.shift
        y = self.ln1(x)
        mask = None
        if s > 0:
            y = torch.roll(y, (-s, -s, -s), (1, 2, 3))
            mask = self.mask.repeat(b, 1, 1)
        win = (y.reshape(b, d // w, w, h // w, w, wd // w, w, c)
               .permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(-1, w ** 3, c))
        win = self.attn(win.to(self.dtype), mask)
        y = (win.reshape(b, d // w, h // w, wd // w, w, w, w, c)
             .permute(0, 1, 4, 2, 5, 3, 6, 7).reshape(b, d, h, wd, c))
        if s > 0:
            y = torch.roll(y, (s, s, s), (1, 2, 3))
        x = x + y
        y = self.fc2(gelu(self.fc1(self.ln2(x))))
        return x + y


class PatchMerging3D(nn.Module):
    """Each 2 x 2 x 2 neighbourhood's channels side by side (8C, in the
    JAX package's gather order), LayerNorm, Dense to 2C."""

    def __init__(self, channels: int, dtype=torch.bfloat16,
                 param_dtype=torch.float32, device=None, generator=None):
        super().__init__()
        self.ln = LayerNorm(8 * channels, param_dtype, device)
        self.reduce = Dense(8 * channels, 2 * channels, dtype=dtype,
                            param_dtype=param_dtype, device=device,
                            generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, d, h, w, c = x.shape
        x = (x.reshape(b, d // 2, 2, h // 2, 2, w // 2, 2, c)
             .permute(0, 1, 3, 5, 2, 4, 6, 7)
             .reshape(b, d // 2, h // 2, w // 2, 8 * c))
        return self.reduce(self.ln(x))


class SwinEncoder3D(nn.Module):
    """Patch embedding (a k=p s=p SAME conv), then per stage `depth` Swin
    blocks (every second one shifted by window // 2) and a patch merging
    between stages; forward returns each stage's features, NCDHW."""

    def __init__(self, in_channels: int = 1, img_size: int = 128,
                 embed_dim: int = 48, depths: Sequence[int] = (2, 2, 2, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24), window: int = 4,
                 patch_size: int = 2, dtype=torch.bfloat16,
                 param_dtype=torch.float32, device=None, generator=None):
        super().__init__()
        common = _common(dtype, param_dtype, device, generator)
        self.dtype, self.depths = dtype, tuple(depths)
        self.patch_embed = Convolution(in_channels, embed_dim, patch_size,
                                       patch_size, conv_only=True, **common)
        grid = -(-img_size // patch_size)  # SAME padding: ceil
        if grid < 2 ** (len(depths) - 1):
            raise ValueError(f"a {img_size}^3 volume (a {grid}^3 token grid) "
                             f"is too small for {len(depths)} Swin stages")
        c = embed_dim
        for s, (depth, heads) in enumerate(zip(depths, num_heads)):
            for i in range(depth):
                w, shift = resolve_window(grid, window,
                                          0 if i % 2 == 0 else window // 2)
                setattr(self, f"stage{s}_block{i}", SwinBlock3D(
                    c, heads, w, grid, shift, **common))
            if s < len(depths) - 1:
                setattr(self, f"merge{s}", PatchMerging3D(c, **common))
                c, grid = 2 * c, grid // 2

    def forward(self, x: torch.Tensor):
        t = self.patch_embed(x.to(self.dtype)).permute(0, 2, 3, 4, 1)
        feats = []
        for s, depth in enumerate(self.depths):
            for i in range(depth):
                t = getattr(self, f"stage{s}_block{i}")(t)
            feats.append(t.permute(0, 4, 1, 2, 3))
            if s < len(self.depths) - 1:
                t = getattr(self, f"merge{s}")(t)
        return feats


class SwinUNETR(nn.Module):
    """Swin encoder and a UNETR-style decoder: with patch 2 the stages sit
    at 1/2, 1/4, ... of the volume; each decoder step upsamples by a k=2
    s=2 transposed conv, gates the skip where `attention_gates`, and fuses
    it by a ConvBlock. forward(x, ...) -> relu(out) in f32."""

    def __init__(self, in_channels: int = 1, out_channels: int = 1,
                 img_size: int = 128, embed_dim: int = 48,
                 depths: Sequence[int] = (2, 2, 2, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24), window: int = 4,
                 attention_gates: bool = False, norm: str = "instance",
                 dtype=torch.bfloat16, param_dtype=torch.float32,
                 device=None, generator=None):
        super().__init__()
        common = _common(dtype, param_dtype, device, generator)
        self.attention_gates = attention_gates
        self.swin = SwinEncoder3D(in_channels, img_size, embed_dim, depths,
                                  num_heads, window, **common)
        self.enc_in = ConvBlock(in_channels, embed_dim, strides=1, norm=norm,
                                **common)
        n = len(depths)
        self.widths = [embed_dim] + [embed_dim * 2 ** s for s in range(n - 1)]
        c = embed_dim * 2 ** (n - 1)
        for i in range(n - 1, -1, -1):
            width = self.widths[i]
            setattr(self, f"dec{i}_up", Convolution(
                c, width, 2, 2, act="prelu", norm=norm, is_transposed=True,
                **common))
            if attention_gates:
                setattr(self, f"dec{i}_gate", AttentionGate(
                    max(width // 2, 1), width, width, norm=norm, **common))
            setattr(self, f"dec{i}_conv", ConvBlock(2 * width, width,
                                                    strides=1, norm=norm,
                                                    **common))
            c = width
        self.out = Convolution(embed_dim, out_channels, 1, conv_only=True,
                               **common)

    def forward(self, x: torch.Tensor, covariate=None, roi_loc=None,
                roi_std=None, roi_compact=None,
                with_projections: bool = True) -> torch.Tensor:
        feats = self.swin(x)
        skips = [self.enc_in(x)] + feats[:-1]
        d = feats[-1]
        for i in range(len(skips) - 1, -1, -1):
            skip = skips[i]
            d = getattr(self, f"dec{i}_up")(d)
            if self.attention_gates:
                skip, _ = getattr(self, f"dec{i}_gate")(d, skip)
            d = getattr(self, f"dec{i}_conv")(torch.cat([d, skip], dim=1))
        return torch.relu(self.out(d).float())
