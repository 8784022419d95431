"""Baseline model family (counterpart of
`coma_unet_tpu/models/baselines.py`): the plain residual 3-D U-Net (`UNET`)
and the ViT-encoder UNETR (`GenUNETR`, and `AttnUNETR` with gated skips).
The SwinUNETR pair lives in `models/swin.py`.

Routing as in the JAX package, which builds every conv here without
`use_pallas`: the convs and norms are PyTorch built-ins (`F.conv3d`,
`F.conv_transpose3d` on cuDNN, plain norm ops), and the transformer parts
(LayerNorm, attention, GELU, the Dense layers) are plain PyTorch; no kernel
family is launched. Attention logits and the softmax are computed in f32,
the matmuls in the compute dtype.

The JAX modules infer their input sizes at init; these take them at
construction: the input channels, and for UNETR the volume size, whose
token count sets `pos_embed`'s shape. Parameter names equal the flax names
(`coma_unet_tpu_torch.convert` maps the tree). Models build on the GPU
unless `device` says otherwise.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from coma_unet_tpu_torch.models.blocks import (
    AttentionGate,
    ConvBlock,
    Convolution,
    Dense,
    LayerNorm,
    _fill_,
    gelu,
    resolve_device,
)


def _common(dtype, param_dtype, device, generator) -> dict:
    return dict(dtype=dtype, param_dtype=param_dtype,
                device=resolve_device(device), generator=generator)


# ---------------------------------------------------------------------------
# plain residual 3-D U-Net (MONAI `UNet`)
# ---------------------------------------------------------------------------


class ResidualUnit(nn.Module):
    """MONAI ResidualUnit: k=3 conv -> norm -> PReLU, conv -> norm, plus the
    input, projected by a strided 1x1 conv where the shapes differ. The JAX
    module compares shapes at trace time; this one decides at construction,
    by channels and stride (they differ alike except for a stride on a
    1-voxel grid)."""

    def __init__(self, in_channels: int, out_channels: int, strides: int = 1,
                 norm: str = "instance", **common):
        super().__init__()
        self.conv0 = Convolution(in_channels, out_channels, 3, strides,
                                 act="prelu", norm=norm, **common)
        self.conv1 = Convolution(out_channels, out_channels, 3, 1, act=None,
                                 norm=norm, **common)
        self.residual = None
        if in_channels != out_channels or strides != 1:
            self.residual = Convolution(in_channels, out_channels, 1, strides,
                                        conv_only=True, **common)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv1(self.conv0(x))
        return y + (x if self.residual is None else self.residual(x))


class UNet3D(nn.Module):
    """Plain 3-D U-Net, the `UNET` baseline: residual units down and up,
    transposed k=3 convs between levels, no conditioning or attention;
    forward(x, ...) -> relu(out) in f32. The covariate and ROI inputs are
    accepted and ignored, as in the JAX package."""

    def __init__(self, channels: Sequence[int] = (32, 64, 128, 256, 512),
                 strides: Sequence[int] = (2, 2, 2, 2), in_channels: int = 1,
                 out_channels: int = 1, norm: str = "instance",
                 dtype=torch.bfloat16, param_dtype=torch.float32,
                 device=None, generator=None):
        super().__init__()
        common = _common(dtype, param_dtype, device, generator)
        ch = self.channels = list(channels)
        self.head = ResidualUnit(in_channels, ch[0], 1, norm=norm, **common)
        for i in range(len(ch) - 1):
            setattr(self, f"down{i}", ResidualUnit(
                ch[i], ch[i + 1], strides[i], norm=norm, **common))
        for i in range(len(ch) - 2, -1, -1):
            setattr(self, f"up{i}", Convolution(
                ch[i + 1], ch[i], 3, strides[i], act="prelu", norm=norm,
                is_transposed=True, **common))
            setattr(self, f"dec{i}", ResidualUnit(2 * ch[i], ch[i], 1,
                                                  norm=norm, **common))
        self.out = Convolution(ch[0], out_channels, 1, conv_only=True,
                               **common)

    def forward(self, x: torch.Tensor, covariate=None, roi_loc=None,
                roi_std=None, roi_compact=None,
                with_projections: bool = True) -> torch.Tensor:
        depth = len(self.channels)
        h = self.head(x)
        skips = [h]
        for i in range(depth - 1):
            h = getattr(self, f"down{i}")(h)
            if i < depth - 2:
                skips.append(h)
        for i in range(depth - 2, -1, -1):
            h = getattr(self, f"up{i}")(h)
            h = getattr(self, f"dec{i}")(torch.cat([h, skips[i]], dim=1))
        return torch.relu(self.out(h).float())


# ---------------------------------------------------------------------------
# ViT encoder + UNETR
# ---------------------------------------------------------------------------


class MLPBlock(nn.Module):
    """Dense -> GELU (tanh approximation, `jax.nn.gelu`'s default) ->
    Dense."""

    def __init__(self, features: int, hidden: int, dtype=torch.bfloat16,
                 param_dtype=torch.float32, device=None, generator=None):
        super().__init__()
        common = dict(dtype=dtype, param_dtype=param_dtype, device=device,
                      generator=generator)
        self.fc1 = Dense(features, hidden, **common)
        self.fc2 = Dense(hidden, features, **common)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(gelu(self.fc1(x)))


class SelfAttention(nn.Module):
    """flax `nn.MultiHeadDotProductAttention` as self-attention: query,
    key and value projections to `num_heads` x head_dim (flax's DenseGeneral
    kernels [d, heads, head_dim] flattened to Linear weights), the query
    scaled by 1/sqrt(head_dim), softmax over the keys, the `out`
    projection back to d."""

    def __init__(self, features: int, num_heads: int, dtype=torch.bfloat16,
                 param_dtype=torch.float32, device=None, generator=None):
        super().__init__()
        if features % num_heads:
            raise ValueError(f"{features} features over {num_heads} heads")
        self.num_heads, self.dtype = num_heads, dtype
        common = dict(dtype=dtype, param_dtype=param_dtype, device=device,
                      generator=generator)
        for name in ("query", "key", "value", "out"):
            setattr(self, name, Dense(features, features, **common))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, d = x.shape
        h = self.num_heads
        q, k, v = (getattr(self, name)(x).reshape(b, n, h, d // h)
                   .transpose(1, 2) for name in ("query", "key", "value"))
        q = q / math.sqrt(d // h)
        attn = torch.softmax((q @ k.transpose(-2, -1)).float(), dim=-1)
        y = attn.to(self.dtype) @ v                      # [b, h, n, hd]
        return self.out(y.transpose(1, 2).reshape(b, n, d))


class TransformerBlock(nn.Module):
    """Pre-norm transformer block: x + attn(ln1(x)), then x + mlp(ln2(x)),
    the MLP 4x wide."""

    def __init__(self, features: int, num_heads: int, dtype=torch.bfloat16,
                 param_dtype=torch.float32, device=None, generator=None):
        super().__init__()
        common = dict(dtype=dtype, param_dtype=param_dtype, device=device,
                      generator=generator)
        self.ln1 = LayerNorm(features, param_dtype, device)
        self.attn = SelfAttention(features, num_heads, **common)
        self.ln2 = LayerNorm(features, param_dtype, device)
        self.mlp = MLPBlock(features, 4 * features, **common)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln1(x))
        return x + self.mlp(self.ln2(x))


class ViT3D(nn.Module):
    """3-D ViT: a k=p s=p SAME patch-embedding conv (JAX's padding, (p//2,
    p-1-p//2)), a learned position embedding [1, tokens, hidden] and
    `num_layers` blocks; forward returns the tokens after the blocks at
    the quarters of the depth and the token grid."""

    def __init__(self, in_channels: int = 1, img_size: int = 128,
                 hidden_size: int = 768, num_layers: int = 12,
                 num_heads: int = 12, patch_size: int = 16,
                 dtype=torch.bfloat16, param_dtype=torch.float32,
                 device=None, generator=None):
        super().__init__()
        if img_size % patch_size:
            raise ValueError(f"volume size {img_size} is not a multiple of "
                             f"the patch size {patch_size}")
        common = _common(dtype, param_dtype, device, generator)
        self.extract = tuple(max(1, (num_layers * q) // 4) for q in (1, 2, 3, 4))
        self.grid = (img_size // patch_size,) * 3
        self.hidden_size, self.dtype = hidden_size, dtype
        self.patch_embed = Convolution(in_channels, hidden_size, patch_size,
                                       patch_size, conv_only=True, **common)
        n = math.prod(self.grid)
        self.pos_embed = nn.Parameter(torch.empty(
            (1, n, hidden_size), dtype=param_dtype, device=common["device"]))
        _fill_(self.pos_embed, lambda t: t.normal_(0.0, 0.02,
                                                   generator=generator))
        for i in range(num_layers):
            setattr(self, f"block{i}", TransformerBlock(
                hidden_size, num_heads, **common))
        self.num_layers = num_layers

    def forward(self, x: torch.Tensor):
        h = self.patch_embed(x.to(self.dtype))
        if tuple(h.shape[2:]) != self.grid:
            raise ValueError(f"token grid {tuple(h.shape[2:])}, built for "
                             f"{self.grid}: the volume size is fixed at "
                             f"construction (ModelConfig.prompt_shape)")
        tokens = h.reshape(h.shape[0], self.hidden_size, -1).transpose(1, 2)
        tokens = tokens + self.pos_embed.to(tokens.dtype)
        outs = []
        for i in range(self.num_layers):
            tokens = getattr(self, f"block{i}")(tokens)
            if (i + 1) in self.extract:
                outs.append(tokens)
        return outs, self.grid


def _tokens_to_volume(tokens: torch.Tensor, grid) -> torch.Tensor:
    b, _, d = tokens.shape
    return tokens.transpose(1, 2).reshape((b, d) + tuple(grid))


class UNETR(nn.Module):
    """UNETR (Hatamizadeh et al.): ViT encoder and a progressive
    transposed-conv decoder with conv-projected skips; `attention_gates`
    gives `AttnUNETR` (gated skips, whose psi maps are not returned, as in
    the JAX package). forward(x, ...) -> relu(out) in f32."""

    def __init__(self, in_channels: int = 1, out_channels: int = 1,
                 img_size: int = 128, feature_size: int = 16,
                 hidden_size: int = 768, num_layers: int = 12,
                 num_heads: int = 12, patch_size: int = 16,
                 attention_gates: bool = False, norm: str = "instance",
                 dtype=torch.bfloat16, param_dtype=torch.float32,
                 device=None, generator=None):
        super().__init__()
        common = _common(dtype, param_dtype, device, generator)
        fs = feature_size
        self.attention_gates = attention_gates
        self.vit = ViT3D(in_channels, img_size, hidden_size, num_layers,
                         num_heads, patch_size, **common)
        up = dict(kernel_size=2, strides=2, act="prelu", norm=norm,
                  is_transposed=True, **common)
        self.enc0 = ConvBlock(in_channels, fs, strides=1, norm=norm, **common)
        for name, times, width in (("enc1", 3, fs * 2), ("enc2", 2, fs * 4),
                                   ("enc3", 1, fs * 8)):
            c = hidden_size
            for t in range(times):
                setattr(self, f"{name}_up{t}", Convolution(c, width, **up))
                c = width
        c = hidden_size
        for i, width in enumerate((fs * 8, fs * 4, fs * 2, fs)):
            setattr(self, f"dec{i}_up", Convolution(c, width, **up))
            if attention_gates:
                setattr(self, f"dec{i}_gate", AttentionGate(
                    max(width // 2, 1), width, width, norm=norm, **common))
            setattr(self, f"dec{i}_conv", ConvBlock(2 * width, width,
                                                    strides=1, norm=norm,
                                                    **common))
            c = width
        self.out = Convolution(fs, out_channels, 1, conv_only=True, **common)

    def _stack(self, name: str, v: torch.Tensor, times: int) -> torch.Tensor:
        for t in range(times):
            v = getattr(self, f"{name}_up{t}")(v)
        return v

    def forward(self, x: torch.Tensor, covariate=None, roi_loc=None,
                roi_std=None, roi_compact=None,
                with_projections: bool = True) -> torch.Tensor:
        hs, grid = self.vit(x)
        z3, z6, z9, z12 = (_tokens_to_volume(t, grid) for t in hs)
        skips = (self._stack("enc3", z9, 1), self._stack("enc2", z6, 2),
                 self._stack("enc1", z3, 3), self.enc0(x))
        d = z12
        for i, skip in enumerate(skips):
            d = getattr(self, f"dec{i}_up")(d)
            if self.attention_gates:
                skip, _ = getattr(self, f"dec{i}_gate")(d, skip)
            d = getattr(self, f"dec{i}_conv")(torch.cat([d, skip], dim=1))
        return torch.relu(self.out(d).float())
