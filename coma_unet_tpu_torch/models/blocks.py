"""Building blocks of the covariate-modulated 3-D attention U-Net
(counterpart of `coma_unet_tpu/models/blocks.py`).

Parameter names equal the flax names (`kernel`, `bias`, `experts`,
`route`, `film`, `prelu.alpha`, `conv0`, ...), so that a flax parameter tree
maps onto a state dict mechanically (`coma_unet_tpu_torch.convert`).
Activations are NCDHW and computed in the configured compute dtype; params
are kept in the param dtype (f32) and cast at use, as in the JAX package.

Every conv block takes `kernels`: when True its conv goes through the op
wrapper of its family (`conv3d_s1`, `conv3d_s2`, `conv3d_t2`) and its
instance norm + FiLM + activation through `norm_act`; each wrapper launches
the family's CUDA kernel for a CUDA tensor and runs the plain version for a
CPU tensor. When False the block uses PyTorch's built-in ops, as the JAX
package leaves those sites to XLA. As in the JAX package (`_norm_act_ok`),
batch norm, dropout and an activation outside K4's set (gelu) keep the
norm, FiLM and activation in plain ops even where `kernels` is True. The
models set `kernels` by U-Net level (`models/attention_unet.py`), never by
tensor shape. Blocks, like the
models, build on the GPU unless `device` names another device
(`resolve_device`).

Inside `depth_sharded(slab)` the blocks run on one rank's depth slab of the
volume (`parallel/spatial.py`): `conv3d` takes the neighbours' planes around
every conv that reaches across the slab's ends, whichever route it takes
(`slab.conv`), and instance norm merges its statistics over the ranks
(`slab.mean_rstd`): where `kernels` sends the chain to K4, K4's slab form
(`norm_stats`, then `norm_apply`) takes it, otherwise plain ops. Batch
norm in eval mode normalizes with its running statistics, which need no
merge. The context is a `ContextVar` that `depth_sharded` sets and restores.
"""

from __future__ import annotations

import contextlib
from contextvars import ContextVar
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from coma_unet_tpu_torch.ops.conv3d import conv3d_ref, conv3d_s1
from coma_unet_tpu_torch.ops.conv3d_strided import (
    conv3d_s2,
    conv3d_t2,
    conv_transpose3d_ref,
)
from coma_unet_tpu_torch.ops.norm_act import ACTS, apply_act, norm_act, norm_apply

# the rank's depth slab (`parallel/spatial.py:Slab`) while a forward runs
# inside `depth_sharded`, else None
_SLAB: ContextVar = ContextVar("coma_depth_slab", default=None)


@contextlib.contextmanager
def depth_sharded(slab):
    """Run the blocks (and the modulator's prompts) on `slab`'s depth slab
    of the volume until the block ends, then restore the context that was
    there before. Inference only: the convs write their boundary planes in
    place."""
    if torch.is_grad_enabled():
        raise RuntimeError("the depth-sharded forward runs without gradients "
                           "(torch.no_grad)")
    token = _SLAB.set(slab)
    try:
        yield slab
    finally:
        _SLAB.reset(token)


def current_slab():
    """The depth slab the forward runs on, or None."""
    return _SLAB.get()


def gelu(u: torch.Tensor) -> torch.Tensor:
    """`jax.nn.gelu`'s default, the tanh approximation."""
    return F.gelu(u, approximate="tanh")


# flax's lecun_normal: a normal truncated at two standard deviations, with
# the standard deviation rescaled so that the truncated variance is 1/fan_in
_TRUNC_STD = 0.87962566103423978


def resolve_device(device=None) -> torch.device:
    """`device`, or the card when it is None. The port builds on the GPU
    unless the caller asks for the CPU; with no card, a model built without
    `device` raises instead of running the plain versions on the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port builds its models on the GPU unless "
            "asked otherwise; pass device=\"cpu\" to build on the CPU")
    return torch.device("cuda")


def _fill_(param: torch.Tensor, draw) -> None:
    """Fill `param` from a CPU draw, so that one generator gives the same
    values whatever the parameter's device."""
    with torch.no_grad():
        param.copy_(draw(torch.empty(param.shape, dtype=torch.float32)))


def conv_init_(param: torch.Tensor, fan_in: int,
               generator: Optional[torch.Generator]) -> None:
    """torch's Conv3d default, as the JAX package uses it:
    U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""
    bound = 1.0 / float(np.sqrt(fan_in))
    _fill_(param, lambda t: t.uniform_(-bound, bound, generator=generator))


def dense_init_(layer: nn.Linear, generator: Optional[torch.Generator],
                zero: bool = False) -> None:
    """flax Dense init: lecun-normal kernel (or zeros) and a zero bias."""
    std = float(np.sqrt(1.0 / layer.in_features)) / _TRUNC_STD
    if zero:
        _fill_(layer.weight, torch.zeros_like)
    else:
        _fill_(layer.weight, lambda t: nn.init.trunc_normal_(
            t, 0.0, std, -2.0 * std, 2.0 * std, generator=generator))
    _fill_(layer.bias, torch.zeros_like)


class Dense(nn.Linear):
    """flax `nn.Dense` at a compute dtype: input, weight and bias cast to
    `dtype` at use, the parameters kept in the param dtype; lecun-normal
    weight, zero bias. `weight` is flax's kernel transposed."""

    def __init__(self, in_features: int, out_features: int,
                 dtype=torch.bfloat16, param_dtype=torch.float32,
                 device=None, generator=None):
        super().__init__(in_features, out_features, dtype=param_dtype,
                         device=resolve_device(device))
        self.compute_dtype = dtype
        dense_init_(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class LayerNorm(nn.LayerNorm):
    """flax `nn.LayerNorm(dtype=float32)`: eps 1e-6, the input taken in f32,
    the output f32. `weight` is flax's `scale`."""

    def __init__(self, features: int, param_dtype=torch.float32,
                 device=None):
        super().__init__(features, eps=1e-6, dtype=param_dtype,
                         device=resolve_device(device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape,
                            self.weight.float(), self.bias.float(), self.eps)


class PReLU(nn.Module):
    """torch-default PReLU: one shared learnable slope, init 0.25."""

    def __init__(self, param_dtype=torch.float32, device=None):
        super().__init__()
        self.alpha = nn.Parameter(torch.full(
            (1,), 0.25, dtype=param_dtype, device=resolve_device(device)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return apply_act(x, "prelu", self.alpha)


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Per-sample, per-channel normalization over the spatial dims (torch
    InstanceNorm3d defaults). Stats in f32; the normalize step runs in x's
    dtype, as the JAX package's `InstanceNorm` does. Inside
    `depth_sharded` the statistics are those of the whole volume, merged
    over the ranks."""
    slab = _SLAB.get()
    if slab is not None:
        shape = x.shape[:2] + (1,) * (x.dim() - 2)
        mean, rstd = (s.reshape(shape) for s in
                      slab.mean_rstd(x, kernels=False, eps=eps).unbind(1))
        return (x - mean.to(x.dtype)) * rstd.to(x.dtype)
    dims = tuple(range(2, x.dim()))
    xf = x.float()
    mean = xf.mean(dims, keepdim=True)
    var = (xf - mean).square().mean(dims, keepdim=True)
    return (x - mean.to(x.dtype)) * torch.rsqrt(var + eps).to(x.dtype)


class InstanceNorm(nn.Module):
    """`instance_norm` as a module (no parameters: affine=False)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return instance_norm(x)


class BatchNorm(nn.Module):
    """flax `nn.BatchNorm(momentum=0.9, epsilon=1e-5, axis=1,
    dtype=float32)`: per-channel statistics over (B, D, H, W) in f32 and
    the biased variance (flax's E[x^2] - E[x]^2, here taken in two passes),
    in train mode the batch's (and the running averages move: new = 0.9 old
    + 0.1 batch), in eval mode the running ones. Parameters `scale` and `bias`, buffers
    `mean` and `var`: the keys of flax's params and `batch_stats`. The
    output is f32."""

    MOMENTUM = 0.9
    EPS = 1e-5

    def __init__(self, channels: int, param_dtype=torch.float32, device=None):
        super().__init__()
        device = resolve_device(device)
        self.scale = nn.Parameter(torch.ones(channels, dtype=param_dtype,
                                             device=device))
        self.bias = nn.Parameter(torch.zeros(channels, dtype=param_dtype,
                                             device=device))
        self.register_buffer("mean", torch.zeros(channels, device=device))
        self.register_buffer("var", torch.ones(channels, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        if self.training:
            with torch.no_grad():
                dims = (0,) + tuple(range(2, x.dim()))
                var, mean = torch.var_mean(xf, dims, correction=0)
                m = self.MOMENTUM
                self.mean.mul_(m).add_(mean, alpha=1.0 - m)
                self.var.mul_(m).add_(var, alpha=1.0 - m)
        # training=True normalizes with the batch's biased variance
        return F.batch_norm(xf, None if self.training else self.mean,
                            None if self.training else self.var,
                            self.scale.float(), self.bias.float(),
                            training=self.training, eps=self.EPS)


class Norm(nn.Module):
    """Norm factory: "instance", "batch" (`BatchNorm` as `bnorm`) or
    "none"."""

    def __init__(self, kind: Optional[str] = "instance",
                 channels: Optional[int] = None, param_dtype=torch.float32,
                 device=None):
        super().__init__()
        if kind not in (None, "none", "instance", "batch"):
            raise ValueError(f"unknown norm {kind!r}")
        self.kind = kind or "none"
        self.inorm = InstanceNorm() if self.kind == "instance" else None
        if self.kind == "batch":
            self.bnorm = BatchNorm(channels, param_dtype=param_dtype,
                                   device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.kind == "batch":
            return self.bnorm(x)
        return x if self.inorm is None else self.inorm(x)


class Dropout(nn.Module):
    """flax `nn.Dropout`: in train mode each element is kept with
    probability 1 - rate and scaled by 1 / (1 - rate), in eval mode the
    identity. The mask is drawn from a `torch.Generator` of the input's
    device, seeded with `seed` (`seed_dropout` sets it); nothing draws from
    the global generator."""

    def __init__(self, rate: float, seed: int = 0):
        super().__init__()
        self.rate = float(rate)
        self.reseed(seed)

    def reseed(self, seed: int) -> None:
        self.seed = int(seed)
        self._generators: dict = {}

    def generator(self, device: torch.device) -> torch.Generator:
        key = str(device)
        if key not in self._generators:
            gen = torch.Generator(device=device)
            gen.manual_seed(self.seed)
            self._generators[key] = gen
        return self._generators[key]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        if self.rate >= 1.0:
            return torch.zeros_like(x)
        keep = 1.0 - self.rate
        draw = torch.rand(x.shape, generator=self.generator(x.device),
                          device=x.device)
        return torch.where(draw < keep, x / keep, torch.zeros_like(x))


def seed_dropout(model: nn.Module, seed: int, step: int = 0) -> int:
    """Seed every `Dropout` of `model` for one step: site i (in module
    order) draws from a seed of its own, a function of (seed, step, i), so
    a run seeded alike draws alike, a resumed run included. Returns the
    number of sites."""
    sites = [m for m in model.modules() if isinstance(m, Dropout)]
    for i, site in enumerate(sites):
        site.reseed(int(np.random.SeedSequence(
            [int(seed), int(step), i]).generate_state(1, np.uint64)[0] >> 1))
    return len(sites)


def conv3d(x: torch.Tensor, w: torch.Tensor,
           bias: Optional[torch.Tensor] = None, stride: int = 1,
           transposed: bool = False, kernels: bool = False) -> torch.Tensor:
    """SAME conv (stride 1 or 2) or the lhs-dilated transposed conv, with
    shared `[Cout, Cin, k, k, k]` or per-sample `[B, Cout, Cin, k, k, k]`
    weights. `kernels` routes to the kernel families' wrappers (stride-1
    k in {1, 3}, stride-2 k=3, transposed stride-2 k=3); otherwise PyTorch's
    built-in convs. Inside `depth_sharded`, x is the rank's slab and so is
    the result: the slab takes the neighbours' planes (`Slab.conv`)."""
    slab = _SLAB.get()
    if slab is not None:
        return slab.conv(
            x, lambda t: _conv3d(t, w, bias, stride, transposed, kernels),
            w.shape[-1], stride, transposed)
    return _conv3d(x, w, bias, stride, transposed, kernels)


def _conv3d(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor],
            stride: int, transposed: bool, kernels: bool) -> torch.Tensor:
    if not kernels:
        if transposed:
            return conv_transpose3d_ref(x, w, bias, stride)
        return conv3d_ref(x, w, bias, stride)
    x, w = x.contiguous(), w.contiguous()
    if transposed and stride == 2:
        return conv3d_t2(x, w, bias)
    if not transposed and stride == 2:
        return conv3d_s2(x, w, bias)
    if not transposed and stride == 1:
        return conv3d_s1(x, w, bias)
    raise ValueError(f"no kernel family for stride {stride}, "
                     f"transposed={transposed}")


def norm_film_act(y: torch.Tensor, norm: Norm, act: Optional[str],
                  alpha: Optional[torch.Tensor],
                  scale: Optional[torch.Tensor],
                  shift: Optional[torch.Tensor],
                  kernels: bool,
                  dropout: Optional[Dropout] = None) -> torch.Tensor:
    """norm -> FiLM (`scale`, `shift` [B, C] f32, or None) -> dropout ->
    act. K4 (`norm_act`) takes the chain where `kernels` is set, the norm is
    instance norm, there is no dropout and K4 has the activation; otherwise
    plain ops, as JAX's `_norm_act_ok` decides. Inside `depth_sharded`, K4's
    slab form takes it with the statistics merged over the ranks."""
    if (kernels and norm.kind == "instance" and dropout is None
            and (act or "none") in ACTS):
        slab = _SLAB.get()
        if slab is not None:
            return norm_apply(y, slab.mean_rstd(y, kernels=True), alpha, act,
                              scale, shift)
        return norm_act(y, alpha, act, scale, shift)
    y = norm(y)
    if scale is not None:
        y = (y * scale[:, :, None, None, None].to(y.dtype)
             + shift[:, :, None, None, None].to(y.dtype))
    if dropout is not None:
        y = dropout(y)
    if act == "gelu":
        return gelu(y)
    return apply_act(y, act or "none", alpha)


def _check_act(act: Optional[str]) -> None:
    if (act or "none") not in ACTS and act != "gelu":
        raise ValueError(f"unknown activation {act!r}")


class Convolution(nn.Module):
    """MONAI-equivalent Convolution: conv (or transposed conv) -> norm ->
    dropout -> act. `conv_only=True` skips norm, dropout and act."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, strides: int = 1,
                 act: Optional[str] = "prelu",
                 norm: Optional[str] = "instance", dropout: float = 0.0,
                 conv_only: bool = False,
                 is_transposed: bool = False, use_bias: bool = True,
                 kernels: bool = False, dtype=torch.bfloat16,
                 param_dtype=torch.float32, device=None, generator=None):
        super().__init__()
        _check_act(act)
        device = resolve_device(device)
        k = kernel_size
        self.strides, self.is_transposed = strides, is_transposed
        self.conv_only, self.act, self.kernels = conv_only, act, kernels
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty(
            (out_channels, in_channels, k, k, k), dtype=param_dtype,
            device=device))
        conv_init_(self.kernel, in_channels * k ** 3, generator)
        self.bias = (nn.Parameter(torch.zeros(out_channels, dtype=param_dtype,
                                              device=device))
                     if use_bias else None)
        self.dropout = None
        if not conv_only:
            self.norm = Norm(norm, out_channels, param_dtype, device)
            if dropout > 0.0:
                self.dropout = Dropout(dropout)
            if act == "prelu":
                self.prelu = PReLU(param_dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = conv3d(x.to(self.dtype), self.kernel.to(self.dtype), self.bias,
                   self.strides, self.is_transposed, self.kernels)
        if self.conv_only:
            return y
        alpha = self.prelu.alpha if self.act == "prelu" else None
        return norm_film_act(y, self.norm, self.act, alpha, None, None,
                             self.kernels, self.dropout)


class CondConvolution(nn.Module):
    """Covariate-conditioned convolution (the reconstructed `CondConv`): a
    routing Dense maps the first `num_covars` covariates to sigmoid gates
    over `num_experts` expert kernels, mixed per sample in the compute dtype;
    an optional FiLM Dense (zero-initialized, scale = 1 + s) follows the
    norm, then dropout and the activation."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, strides: int = 1,
                 act: Optional[str] = "prelu",
                 norm: Optional[str] = "instance", dropout: float = 0.0,
                 conv_only: bool = False,
                 is_transposed: bool = False, num_experts: int = 8,
                 num_covars: int = 5, film: bool = True,
                 use_bias: bool = True, kernels: bool = False,
                 dtype=torch.bfloat16, param_dtype=torch.float32,
                 device=None, generator=None):
        super().__init__()
        _check_act(act)
        device = resolve_device(device)
        k = kernel_size
        self.strides, self.is_transposed = strides, is_transposed
        self.conv_only, self.act, self.kernels = conv_only, act, kernels
        self.num_covars, self.dtype = num_covars, dtype
        self.experts = nn.Parameter(torch.empty(
            (num_experts, out_channels, in_channels, k, k, k),
            dtype=param_dtype, device=device))
        conv_init_(self.experts, in_channels * k ** 3, generator)
        self.route = nn.Linear(num_covars, num_experts, dtype=param_dtype,
                               device=device)
        dense_init_(self.route, generator)
        self.bias = (nn.Parameter(torch.zeros(out_channels, dtype=param_dtype,
                                              device=device))
                     if use_bias else None)
        self.film = self.dropout = None
        if not conv_only:
            self.norm = Norm(norm, out_channels, param_dtype, device)
            if dropout > 0.0:
                self.dropout = Dropout(dropout)
            if film:
                self.film = nn.Linear(num_covars, 2 * out_channels,
                                      dtype=param_dtype, device=device)
                dense_init_(self.film, generator, zero=True)
            if act == "prelu":
                self.prelu = PReLU(param_dtype, device)

    def forward(self, x: torch.Tensor,
                covariate: Optional[torch.Tensor]) -> torch.Tensor:
        b = x.shape[0]
        if covariate is None:
            cov = torch.zeros((b, self.num_covars), dtype=torch.float32,
                              device=x.device)
        else:
            cov = covariate.reshape(b, -1)[:, :self.num_covars].float()
        gates = torch.sigmoid(self.route(cov))
        kern = torch.einsum("be,e...->b...", gates.to(self.dtype),
                            self.experts.to(self.dtype))
        y = conv3d(x.to(self.dtype), kern, self.bias, self.strides,
                   self.is_transposed, self.kernels)
        if self.conv_only:
            return y
        scale = shift = None
        if self.film is not None:
            sc, shift = self.film(cov).chunk(2, dim=-1)
            scale = 1.0 + sc
        alpha = self.prelu.alpha if self.act == "prelu" else None
        return norm_film_act(y, self.norm, self.act, alpha, scale, shift,
                             self.kernels, self.dropout)


class ConvBlock(nn.Module):
    """attentionunet.ConvBlock: Convolution(stride s) + Convolution(stride
    1), ReLU activations; the conditional variant routes the covariates into
    both convs."""

    def __init__(self, in_channels: int, out_channels: int, strides: int = 1,
                 kernel_size: int = 3, dropout: float = 0.0,
                 conditional: bool = False,
                 num_covars: int = 5, num_experts: int = 8, film: bool = True,
                 norm: str = "instance", kernels: bool = False, **common):
        super().__init__()
        self.conditional = conditional
        args = dict(kernel_size=kernel_size, act="relu", norm=norm,
                    dropout=dropout, kernels=kernels, **common)
        if conditional:
            cond = dict(num_covars=num_covars, num_experts=num_experts,
                        film=film, **args)
            self.conv0 = CondConvolution(in_channels, out_channels,
                                         strides=strides, **cond)
            self.conv1 = CondConvolution(out_channels, out_channels, **cond)
        else:
            self.conv0 = Convolution(in_channels, out_channels,
                                     strides=strides, **args)
            self.conv1 = Convolution(out_channels, out_channels, **args)

    def forward(self, x: torch.Tensor,
                covariate: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.conditional:
            return self.conv1(self.conv0(x, covariate), covariate)
        return self.conv1(self.conv0(x))


class AttentionGate(nn.Module):
    """Additive attention gate:
    psi = sigmoid(norm(conv1x1(relu(norm(conv1x1(g)) + norm(conv1x1(x))))))
    and out = x * psi; returns (out, psi)."""

    def __init__(self, f_int: int, g_channels: int, x_channels: int,
                 norm: str = "instance", kernels: bool = False, **common):
        super().__init__()
        args = dict(kernel_size=1, act=None, norm=norm, kernels=kernels,
                    **common)
        self.W_g = Convolution(g_channels, f_int, **args)
        self.W_x = Convolution(x_channels, f_int, **args)
        self.psi = Convolution(f_int, 1, **args)

    def forward(self, g: torch.Tensor,
                x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        a = torch.relu(self.W_g(g) + self.W_x(x))
        psi = torch.sigmoid(self.psi(a).float()).to(x.dtype)
        return x * psi, psi


class UpBlock(nn.Module):
    """Transposed-conv upsampling; the conditional variant uses the
    expert-mixture transposed conv."""

    def __init__(self, in_channels: int, out_channels: int, strides: int = 2,
                 kernel_size: int = 3, dropout: float = 0.0,
                 conditional: bool = False,
                 num_covars: int = 6, num_experts: int = 8, film: bool = True,
                 norm: str = "instance", kernels: bool = False, **common):
        super().__init__()
        self.conditional = conditional
        args = dict(kernel_size=kernel_size, strides=strides, act="relu",
                    norm=norm, dropout=dropout, is_transposed=True,
                    kernels=kernels, **common)
        if conditional:
            self.up = CondConvolution(in_channels, out_channels,
                                      num_covars=num_covars,
                                      num_experts=num_experts, film=film,
                                      **args)
        else:
            self.up = Convolution(in_channels, out_channels, **args)

    def forward(self, x: torch.Tensor,
                covariate: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.conditional:
            return self.up(x, covariate)
        return self.up(x)


class StackedFusionConvLayers(nn.Module):
    """N-conv LeakyReLU fusion stack: in -> bottleneck, (N-2) x bottleneck
    -> bottleneck, bottleneck -> out; k=3 Convolutions."""

    def __init__(self, in_channels: int, bottleneck_channels: int,
                 out_channels: int, num_convs: int = 3,
                 norm: str = "instance", kernels: bool = False, **common):
        super().__init__()
        widths = [bottleneck_channels] * (num_convs - 1) + [out_channels]
        self.num_convs = num_convs
        for i, w in enumerate(widths):
            setattr(self, f"conv{i}", Convolution(
                in_channels, w, act="leakyrelu", norm=norm, kernels=kernels,
                **common))
            in_channels = w

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.num_convs):
            x = getattr(self, f"conv{i}")(x)
        return x


class ProjectionHead(nn.Module):
    """Per-level contrastive embedding: 1x1x1 ConvBlock to one channel ->
    flatten -> ReLU (f32)."""

    def __init__(self, in_channels: int, norm: str = "instance",
                 kernels: bool = False, **common):
        super().__init__()
        self.conv = ConvBlock(in_channels, 1, kernel_size=1, norm=norm,
                              kernels=kernels, **common)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        return torch.relu(x.reshape(x.shape[0], -1).float())
