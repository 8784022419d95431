"""`ConvAttn`, the ROI-vector regression model (counterpart of
`coma_unet_tpu/models/convattn.py`): a 1-D conv feature extractor over the
ROI positions with multi-head self-attention, regressing the tau ROI-SUVR
vector, and `train_convattn`, its trainer with the WeightedMSE loss.

The layers mirror flax's: `Conv` (k = 3, SAME) kernels [k, Cin, Cout] named
`kernel`, as flax keeps them; `LayerNorm` with eps 1e-6;
`MultiHeadDotProductAttention`'s query, key and value DenseGeneral
[E, heads, E / heads] with biases and its output projection, as `Linear`s
(`convert.from_flax` maps them); `Dense` layers. The JAX package leaves
all of it to XLA, so plain PyTorch ops run it; each conv is one matmul over
its three shifted copies and the attention is written out, so the card
sums in full f32 wherever `torch.backends.cuda.matmul.allow_tf32` is off
(its default).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from coma_unet_tpu_torch.models.blocks import _TRUNC_STD, Dense, _fill_, resolve_device


class ConvSame1d(nn.Module):
    """flax `nn.Conv(features, kernel_size=(k,), padding="SAME")` on
    [B, L, Cin] (length before channels): lecun-normal kernel [k, Cin,
    Cout], zero bias."""

    def __init__(self, cin: int, cout: int, k: int = 3, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.kernel = nn.Parameter(torch.empty((k, cin, cout), device=device))
        self.bias = nn.Parameter(torch.zeros((cout,), device=device))
        std = math.sqrt(1.0 / (k * cin)) / _TRUNC_STD
        _fill_(self.kernel, lambda t: nn.init.trunc_normal_(
            t, 0.0, std, -2.0 * std, 2.0 * std, generator=generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k = self.kernel.shape[0]
        lo = (k - 1) // 2
        xp = F.pad(x, (0, 0, lo, k - 1 - lo))
        taps = torch.cat([xp[:, i:i + x.shape[1]] for i in range(k)], dim=2)
        return taps @ self.kernel.reshape(-1, self.kernel.shape[2]) + self.bias


class SelfAttention(nn.Module):
    """flax `nn.MultiHeadDotProductAttention(num_heads)(a, a)` at its
    defaults: q, k and v projections with biases to E features in `heads`
    heads, softmax(q k^T / sqrt(E / heads)) v, the output projection."""

    def __init__(self, features: int, heads: int, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if features % heads:
            raise ValueError(f"{features} features do not split into {heads} heads")
        self.heads = heads
        for name in ("query", "key", "value", "out"):
            setattr(self, name, Dense(features, features, dtype=torch.float32,
                                      device=device, generator=generator))

    def forward(self, a: torch.Tensor) -> torch.Tensor:
        b, n, e = a.shape
        q, k, v = (getattr(self, name)(a).reshape(b, n, self.heads, -1).transpose(1, 2)
                   for name in ("query", "key", "value"))
        q = q / math.sqrt(q.shape[-1])
        weights = torch.softmax(q @ k.transpose(-1, -2), dim=-1)
        return self.out((weights @ v).transpose(1, 2).reshape(b, n, e))


class ConvAttn(nn.Module):
    """forward(x [B, R]) -> [B, output_size]. `num_rois` R is the sequence
    length, which flax reads from the first input and this module needs
    for `fc1`. Built on the GPU unless `device` says otherwise."""

    def __init__(self, num_rois: int, in_channels: int = 1,
                 first_out_channels: int = 16, num_heads: int = 4,
                 output_size: int = 36, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.sizes = dict(num_rois=num_rois, in_channels=in_channels,
                          first_out_channels=first_out_channels,
                          num_heads=num_heads, output_size=output_size)
        device = resolve_device(device)
        c1, c2 = first_out_channels, 2 * first_out_channels
        self.conv1 = ConvSame1d(in_channels, c1, device=device, generator=generator)
        self.conv2 = ConvSame1d(c1, c2, device=device, generator=generator)
        self.ln = nn.LayerNorm(c2, eps=1e-6, device=device)
        self.attn = SelfAttention(c2, num_heads, device=device, generator=generator)
        self.fc1 = Dense(num_rois * c2, 128, dtype=torch.float32, device=device,
                         generator=generator)
        self.out = Dense(128, output_size, dtype=torch.float32, device=device,
                         generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = torch.relu(self.conv1(x[:, :, None]))
        h = torch.relu(self.conv2(h))
        h = h + self.attn(self.ln(h))
        h = torch.relu(self.fc1(h.reshape(h.shape[0], -1)))
        return self.out(h)


def train_convattn(model: ConvAttn, dataset, weights, epochs: int = 100,
                   lr: float = 1e-3, batch_size: int = 32, seed: int = 0,
                   params: Optional[dict] = None):
    """The ROI-vector pipeline's trainer with the WeightedMSE criterion, on
    the model's device: Adam(lr) (optax.adam's defaults), each epoch's
    order from `np.random.default_rng(seed)`, batches of `batch_size` in
    that order. The model starts from `params` (a state dict, e.g.
    `convert.from_flax` of the JAX trainer's init) where given, else from
    weights drawn anew from `torch.Generator` seeded with `seed`. Returns
    (the trained state dict, each epoch's summed batch losses)."""
    from coma_unet_tpu_torch.losses.weighted import weighted_mse

    device = next(model.parameters()).device
    if params is None:
        params = ConvAttn(**model.sizes, device="cpu",
                          generator=torch.Generator().manual_seed(seed)).state_dict()
    model.load_state_dict(params)
    xs = np.stack([dataset[i][0] for i in range(len(dataset))])
    ys = np.stack([dataset[i][1] for i in range(len(dataset))])
    xs_d = torch.as_tensor(xs, device=device)
    ys_d = torch.as_tensor(ys, device=device)
    w = torch.as_tensor(np.asarray(weights, np.float32), device=device)
    opt = torch.optim.Adam(model.parameters(), lr=lr)
    model.train()
    losses = []
    rng = np.random.default_rng(seed)
    for _ in range(epochs):
        order = rng.permutation(xs.shape[0])
        epoch = []
        for i in range(0, len(order), batch_size):
            sel = torch.as_tensor(order[i:i + batch_size], device=device)
            loss = weighted_mse(model(xs_d[sel]), ys_d[sel], w)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            epoch.append(loss.detach())
        losses.append(sum(torch.stack(epoch).tolist()))
    return {k: v.detach().clone() for k, v in model.state_dict().items()}, losses
