"""Plain reference of the covariate-modulated attention U-Net
(ContraAttnUNET) and of its backbone with a ReLU head (AttnUNET), in
PyTorch float32.

A frozen, functional copy of the model's arithmetic: every layer is a
function of a dict of parameters whose names and shapes are those of the
program's state dict, so one set of weights loads into both sides. It
imports nothing of the program. Every activation passes through `prec`, a
`Precision`, wherever the program holds it in its compute dtype, and every
weight at its use: the reference's own is the identity (float32, with TF32
off, see `float32_exact`); the correctness control passes one that rounds
to a lower precision (`reference/control.py`).

The model, as the paper's code and the program state it:
  * a 5-level attention U-Net, channels 32-64-128-256-512, strides 2,
    k=3 convs, instance norm (eps 1e-5, biased variance);
  * every encoder and up block a CondConv: sigmoid gates of a Dense over
    the covariates mix 8 expert kernels per sample, then FiLM
    (scale = 1 + s, shift) after the norm; the encoder sees 5 covariates,
    the decoder 6;
  * additive attention gates, merges (k=3, PReLU), a k=1 CondConv reduce;
  * the UQ modulator: abeta-selected prompts, the per-ROI tables painted on
    the brain mask, two 3-conv LeakyReLU stacks and a k=1 PReLU head;
  * per-level projection heads (k=1 conv block to one channel, flattened)
    and a final projection head.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]

EPS = 1e-5            # instance norm
LEAKY_SLOPE = 1e-2
PRELU_INIT = 0.25
# lecun-normal std, truncated at 2 standard deviations: the truncated
# normal's std relative to the untruncated one
TRUNC_STD = 0.87962566103423978


class Precision:
    """The rounding an activation gets wherever the program holds it in
    its compute dtype (every conv's input and output, every norm's and
    activation's output), and a weight gets at its use: none."""

    def act(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def weight(self, w: torch.Tensor) -> torch.Tensor:
        return w


EXACT = Precision()


@contextlib.contextmanager
def float32_exact():
    """Float32 convs and matmuls without TF32 for the block; the earlier
    settings come back after it."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


# --- parameters ------------------------------------------------------------

def _cubic(v) -> int:
    t = (v,) * 3 if isinstance(v, int) else tuple(v)
    if len(set(t)) != 1:
        raise ValueError(f"the reference holds cubic sizes only, got {v}")
    return t[0]


def param_shapes(model_type: str, cfg: dict) -> Dict[str, Tuple[Tuple[int, ...], str]]:
    """name -> (shape, init kind) for `model_type` ("ContraAttnUNET" or
    "AttnUNET") at the configuration `cfg` (the program's `ModelConfig`
    fields). Kinds: conv (uniform over +-1/sqrt(fan_in)), dense (lecun
    normal), zero, prompt (standard normal), prelu (0.25)."""
    ch = list(cfg["channels"])
    k = _cubic(cfg["kernel_size"])
    uk = _cubic(cfg["up_kernel_size"])
    e = cfg["num_experts"]
    nb, nf = cfg["block_num_covars"], cfg["num_covars"]
    if not (cfg["conditional"] and cfg["film"] and cfg["norm"] == "instance"):
        raise ValueError("the reference holds the conditional, FiLM, "
                         "instance-norm model only")
    shapes: Dict[str, Tuple[Tuple[int, ...], str]] = {}

    def cond(name, cin, cout, kk, ncov, film=True):
        shapes[name + ".experts"] = ((e, cout, cin, kk, kk, kk), "conv")
        shapes[name + ".bias"] = ((cout,), "zero")
        shapes[name + ".route.weight"] = ((e, ncov), "dense")
        shapes[name + ".route.bias"] = ((e,), "zero")
        if film:
            shapes[name + ".film.weight"] = ((2 * cout, ncov), "zero")
            shapes[name + ".film.bias"] = ((2 * cout,), "zero")

    def conv(name, cin, cout, kk, prelu=False):
        shapes[name + ".kernel"] = ((cout, cin, kk, kk, kk), "conv")
        shapes[name + ".bias"] = ((cout,), "zero")
        if prelu:
            shapes[name + ".prelu.alpha"] = ((1,), "prelu")

    contra = model_type == "ContraAttnUNET"
    if contra and cfg["with_modulator"]:
        size = tuple(cfg["prompt_shape"])
        for name in ("pos", "neg", "general"):
            shapes[f"{name}_dynamic_prompt"] = ((1, 1) + size, "prompt")
    u = "unet."
    cond(u + "head.conv0", cfg["in_channels"], ch[0], k, nb)
    cond(u + "head.conv1", ch[0], ch[0], k, nb)
    for i in range(len(ch) - 1):
        cond(u + f"down{i}.conv0", ch[i], ch[i + 1], k, nb)
        cond(u + f"down{i}.conv1", ch[i + 1], ch[i + 1], k, nb)
    for i in range(len(ch) - 2, -1, -1):
        cond(u + f"up{i}.up", ch[i + 1], ch[i], uk, nf)
        f_int = max(ch[i] // 2, 1)
        conv(u + f"gate{i}.W_g", ch[i], f_int, 1)
        conv(u + f"gate{i}.W_x", ch[i], f_int, 1)
        conv(u + f"gate{i}.psi", f_int, 1, 1)
        conv(u + f"merge{i}", 2 * ch[i], ch[i], 3, prelu=True)
    cond(u + "reduce", ch[0], cfg["out_channels"], 1, nf, film=False)
    if not contra:
        return shapes
    if cfg["with_modulator"]:
        for name, widths in (("deep_modulator_3c", (3, 16, 16, 1)),
                             ("fusion_layer", (2, 8, 8, 1))):
            for j in range(3):
                conv(f"{name}.conv{j}", widths[j], widths[j + 1], 3)
        conv("final_pred_head", 2, 1, 1, prelu=True)
    for i, c in enumerate(ch):
        conv(f"proj{i}.conv.conv0", c, 1, 1)
        conv(f"proj{i}.conv.conv1", 1, 1, 1)
    head_in = 1 if cfg["with_modulator"] else cfg["out_channels"]
    shapes["final_proj.weight"] = ((cfg["latent_spaces"][-1], head_in), "dense")
    shapes["final_proj.bias"] = ((cfg["latent_spaces"][-1],), "zero")
    return shapes


def _fan_in(shape: Tuple[int, ...], kind: str) -> int:
    if kind == "dense":
        return shape[-1]
    return math.prod(shape[-4:])   # Cin * k^3 of [..., Cout, Cin, k, k, k]


def init_params(model_type: str, cfg: dict, seed: int,
                device: torch.device) -> Params:
    """The weights of `seed`, drawn on `device` from one `torch.Generator`
    in three large calls (conv uniforms, dense truncated normals, prompt
    normals), each leaf then scaled to its fan-in."""
    shapes = param_shapes(model_type, cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))

    def draw(kind):
        names = [n for n, (_, kd) in shapes.items() if kd == kind]
        total = sum(math.prod(shapes[n][0]) for n in names)
        return names, total

    out: Params = {}
    names, total = draw("conv")
    flat = torch.rand(total, generator=gen, device=device) * 2.0 - 1.0
    _split(out, shapes, names, flat,
           lambda n: 1.0 / math.sqrt(_fan_in(*shapes[n])))
    names, total = draw("dense")
    # a normal truncated at +-2 by the inverse CDF, in one call
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    u = torch.rand(total, generator=gen, device=device, dtype=torch.float64)
    flat = (math.sqrt(2.0) * torch.erfinv(2.0 * (lo + u * (1.0 - 2.0 * lo))
                                          - 1.0)).float()
    _split(out, shapes, names, flat,
           lambda n: math.sqrt(1.0 / _fan_in(*shapes[n])) / TRUNC_STD)
    names, total = draw("prompt")
    if names:
        flat = torch.randn(total, generator=gen, device=device)
        _split(out, shapes, names, flat, lambda n: 1.0)
    for name, (shape, kind) in shapes.items():
        if kind == "zero":
            out[name] = torch.zeros(shape, device=device)
        elif kind == "prelu":
            out[name] = torch.full(shape, PRELU_INIT, device=device)
    return {n: out[n] for n in shapes}


def _split(out: Params, shapes, names: List[str], flat: torch.Tensor,
           scale) -> None:
    at = 0
    for n in names:
        shape = shapes[n][0]
        size = math.prod(shape)
        out[n] = (flat[at:at + size] * scale(n)).reshape(shape)
        at += size


# --- layers ----------------------------------------------------------------

def conv3d(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor],
           stride: int, prec: Precision) -> torch.Tensor:
    """SAME correlation (padding k // 2 for odd k, any stride), shared
    weights [Cout, Cin, k, k, k] or per sample [B, Cout, Cin, k, k, k]."""
    x, w = prec.act(x), prec.weight(w)
    k = w.shape[-1]
    if w.dim() == 6:
        b, cout, cin = w.shape[:3]
        y = F.conv3d(x.reshape((1, b * cin) + x.shape[2:]),
                     w.reshape((b * cout, cin) + w.shape[3:]),
                     stride=stride, padding=k // 2, groups=b)
        y = y.reshape((b, cout) + y.shape[2:])
    else:
        y = F.conv3d(x, w, stride=stride, padding=k // 2)
    return prec.act(y if bias is None else y + bias.reshape(1, -1, 1, 1, 1))


def conv_transpose3d(x: torch.Tensor, w: torch.Tensor,
                     bias: Optional[torch.Tensor], prec: Precision,
                     stride: int = 2) -> torch.Tensor:
    """The stride-2 transposed conv with correlation weights w: lhs
    dilation 2, padding (k - 1 - p, s - 1 + p), p = (k - 1) // 2, so D ->
    2D; as a built-in transposed conv over the flipped, io-swapped taps."""
    x, w = prec.act(x), prec.weight(w)
    k = w.shape[-1]
    p = (k - 1) // 2
    kw = dict(stride=stride, padding=p, output_padding=stride + 2 * p - k)
    wt = torch.flip(w, dims=(-3, -2, -1)).transpose(-5, -4)
    if w.dim() == 6:
        b, cin, cout = wt.shape[:3]
        y = F.conv_transpose3d(x.reshape((1, b * cin) + x.shape[2:]),
                               wt.reshape((b * cin, cout) + wt.shape[3:]),
                               groups=b, **kw)
        y = y.reshape((b, cout) + y.shape[2:])
    else:
        y = F.conv_transpose3d(x, wt, **kw)
    return prec.act(y if bias is None else y + bias.reshape(1, -1, 1, 1, 1))


def linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
           prec: Precision) -> torch.Tensor:
    return F.linear(prec.act(x), prec.weight(w), b)


def instance_norm(y: torch.Tensor) -> torch.Tensor:
    dims = tuple(range(2, y.dim()))
    mean = y.mean(dims, keepdim=True)
    var = (y - mean).square().mean(dims, keepdim=True)
    return (y - mean) * torch.rsqrt(var + EPS)


def act(u: torch.Tensor, kind: Optional[str],
        alpha: Optional[torch.Tensor] = None) -> torch.Tensor:
    if kind == "relu":
        return torch.relu(u)
    if kind == "leakyrelu":
        return torch.where(u >= 0, u, LEAKY_SLOPE * u)
    if kind == "prelu":
        return torch.where(u >= 0, u, alpha.reshape(()) * u)
    return u


def convolution(p: Params, name: str, x: torch.Tensor, prec: Precision,
                kind: Optional[str], stride: int = 1,
                transposed: bool = False, conv_only: bool = False):
    """conv -> instance norm -> activation."""
    w, b = p[name + ".kernel"], p[name + ".bias"]
    y = (conv_transpose3d(x, w, b, prec) if transposed
         else conv3d(x, w, b, stride, prec))
    if conv_only:
        return y
    y = prec.act(instance_norm(y))
    return prec.act(act(y, kind, p.get(name + ".prelu.alpha")))


def cond_convolution(p: Params, name: str, x: torch.Tensor,
                     cov: torch.Tensor, prec: Precision, kind: Optional[str],
                     stride: int = 1, transposed: bool = False,
                     conv_only: bool = False) -> torch.Tensor:
    """CondConv: per-sample kernels mixed from the experts by sigmoid gates
    over the covariates, conv, instance norm, FiLM, activation."""
    n = p[name + ".route.weight"].shape[1]
    c = cov[:, :n]
    gates = torch.sigmoid(linear(c, p[name + ".route.weight"],
                                 p[name + ".route.bias"], prec))
    kern = torch.einsum("be,e...->b...", gates, p[name + ".experts"])
    b = p[name + ".bias"]
    y = (conv_transpose3d(x, kern, b, prec) if transposed
         else conv3d(x, kern, b, stride, prec))
    if conv_only:
        return y
    y = instance_norm(y)
    if name + ".film.weight" in p:
        sc, shift = linear(c, p[name + ".film.weight"],
                           p[name + ".film.bias"], prec).chunk(2, dim=-1)
        y = y * (1.0 + sc)[:, :, None, None, None] + shift[:, :, None, None, None]
    return prec.act(act(prec.act(y), kind))


def attention_unet(p: Params, cfg: dict, x: torch.Tensor, cov: torch.Tensor,
                   prec: Precision):
    """(out, encoder features) of the backbone, the reduce conv included."""
    depth = len(cfg["channels"])
    strides = [_cubic(s) for s in cfg["strides"]]
    u = "unet."
    h = cond_convolution(p, u + "head.conv0", x, cov, prec, "relu")
    h = cond_convolution(p, u + "head.conv1", h, cov, prec, "relu")
    encoder = [h]
    for i in range(depth - 1):
        h = cond_convolution(p, u + f"down{i}.conv0", h, cov, prec, "relu",
                             stride=strides[i])
        h = cond_convolution(p, u + f"down{i}.conv1", h, cov, prec, "relu")
        encoder.append(h)
    d = encoder[-1]
    for i in range(depth - 2, -1, -1):
        up = cond_convolution(p, u + f"up{i}.up", d, cov, prec, "relu",
                              transposed=True)
        ed, eh, ew = encoder[i].shape[2:]
        up = up[:, :, :ed, :eh, :ew]   # odd sizes: 27 -> 14 -> 28 meets 27
        g = f"{u}gate{i}."
        a = prec.act(torch.relu(convolution(p, g + "W_g", up, prec, None)
                                + convolution(p, g + "W_x", encoder[i], prec, None)))
        psi = prec.act(torch.sigmoid(convolution(p, g + "psi", a, prec, None)))
        att = prec.act(encoder[i] * psi)
        d = convolution(p, u + f"merge{i}", torch.cat([att, up], 1),
                        prec, "prelu")
    out = cond_convolution(p, u + "reduce", d, cov, prec, None, conv_only=True)
    return out, encoder


def paint(compact: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Per-ROI scalars [B, R] onto compact ids [B, ...]: id i in 1..R takes
    column i - 1, any other id 0."""
    b, r = table.shape
    full = torch.cat([table.new_zeros((b, 1)), table], dim=1)
    ids = compact.reshape(b, -1).long()
    ids = torch.where((ids >= 1) & (ids <= r), ids, 0)
    return full.gather(1, ids).reshape(compact.shape)


def modulator(p: Params, x, out, cov, roi_loc, roi_std, roi_compact,
              prec: Precision) -> torch.Tensor:
    b = x.shape[0]
    is_pos = (cov[:, 0] == 1.0).reshape(b, 1, 1, 1, 1)
    prompt = prec.act(torch.where(is_pos, p["pos_dynamic_prompt"],
                                  p["neg_dynamic_prompt"]))
    mask = x >= 1e-4
    suvr = torch.where(mask, paint(roi_compact, torch.nan_to_num(roi_loc))[:, None], 0.0)
    sal = torch.where(mask, paint(roi_compact, torch.nan_to_num(roi_std))[:, None], 0.0)
    h = torch.cat([prompt.expand_as(out), sal, suvr], dim=1)
    for j in range(3):
        h = convolution(p, f"deep_modulator_3c.conv{j}", h, prec, "leakyrelu")
    h = prec.act(prec.act(p["general_dynamic_prompt"]) + h)
    h = torch.cat([h, out], dim=1)
    for j in range(3):
        h = convolution(p, f"fusion_layer.conv{j}", h, prec, "leakyrelu")
    final = convolution(p, "final_pred_head", torch.cat([out, h], dim=1),
                        prec, "prelu")
    return prec.act(torch.relu(final))


def forward(p: Params, model_type: str, cfg: dict, mri, covars, roi_loc,
            roi_std, roi_compact, with_projections: bool = True,
            prec: Precision = EXACT):
    """(out [B, 1, D, H, W], per-level projections [B, N_i]) in float32."""
    x = mri.float()
    cov = covars.reshape(covars.shape[0], -1).float()
    out, encoder = attention_unet(p, cfg, x, cov, prec)
    if model_type != "ContraAttnUNET":
        return prec.act(torch.relu(out)), ()
    if cfg["with_modulator"]:
        out = modulator(p, x, out, cov, roi_loc.float(), roi_std.float(),
                        roi_compact, prec)
    else:
        out = torch.relu(out)
    if not with_projections:
        return out, ()
    projections = []
    for i, enc in enumerate(encoder):
        h = convolution(p, f"proj{i}.conv.conv0", enc, prec, "relu")
        h = convolution(p, f"proj{i}.conv.conv1", h, prec, "relu")
        projections.append(torch.relu(h.reshape(h.shape[0], -1)))
    return out, tuple(projections)
