"""Stride-2 3-D convolutions between the 128^3 and 64^3 levels: kernels K2
(stride-2 SAME conv, and the transposed conv's input gradient) and K3 (the
transposed conv, and the stride-2 conv's input gradient), KB2 (the weight
gradient of both), with their plain versions.

Counterpart of `coma_unet_tpu/ops/pallas/conv3d_strided.py` (`_s2_fwd`,
`_t2_fwd`) and `phase_split.py` (`pallas_hwsplit`, the parity prepass that
K2 does in shared memory). Unlike the TPU kernels, both take and return the
plain NCDHW layout: there is no packed 64^3 layout here. Weights are OIDHW
`[Cout, Cin, 3, 3, 3]` shared or `[B, Cout, Cin, 3, 3, 3]` per sample; K3's
weights keep the JAX package's lhs-dilated correlation convention.

K2 (`csrc/conv3d_s2_tc.cu`) is one tensor-core kernel for every call: K1's
implicit GEMM (`mma.sync` per tap, 16-channel chunks of Cin, W packed by
K1's packing) over bricks of 2 x 4 x 16 output positions whose stride-2
halo box is staged split by parity, cut as `s2_plan` says. As the
transposed conv's input gradient (`conv3d_s2_dx`) it reads `flip_t(w)`
from w in place. K3 (`csrc/conv3d_t2_tc.cu`) is one tensor-core kernel for
every call: K1's implicit GEMM over bricks of 2 x 4 x 16 input positions,
each owning its 2 x 2 x 2 output cube, whose 8 parity classes take the 27
taps from 8 input offsets of a high-side halo box, cut as `t2_plan` says.
As the stride-2 conv's input gradient (`conv3d_t2_dx`) it reads `flip_t(w)`
from w in place.
KB2 (`csrc/conv3d_dw_s2_tc.cu`) is one tensor-core kernel for every call:
KB1's per-tap GEMM over positions (`mma.sync`, split-K summed in a fixed
order) on K2's parity-split halo box, over bricks of 2 x 4 x 16
half-resolution positions, cut as `sdw_plan` says. K2, K3 and KB2 take
bf16. Their float32 forms, for a CUDA tensor of dtype float32: F2, K2's and
K3's designs in f32 on the tensor cores, every product as three TF32
`mma.sync` (3xTF32: f32 accuracy), a block holding up to 64 output channels
of the stride-2 map (`csrc/conv3d_s2_f32_tc.cu`) or 32 of the transposed one
(`csrc/conv3d_t2_f32_tc.cu`), both cut by `f2_plan`; and FB1's strided map,
KB2's design in 3xTF32 (`csrc/conv3d_dw_f32_tc.cu`, cut by
`fb1_plan("s2", ...)`), launched through `conv3d.dw_f32`, the launcher of
both of FB1's maps.

`conv3d_s2` and `conv3d_t2` are `torch.autograd.Function`s, closed under
AD as in the JAX package (`conv3d_strided.py:961-1079`): the input gradient
of each is the other's forward with `flip_t(w)`, and both weight gradients
are KB2, `conv3d_strided_dw(full, half)`, with the roles of the operands
swapped for the transposed conv.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from coma_unet_tpu_torch.ops import _build
from coma_unet_tpu_torch.ops import conv3d as _conv3d
from coma_unet_tpu_torch.ops.conv3d import (
    GRID_MAX,
    INT31,
    DwPlan,
    _cdiv,
    _half,
    bias_grad,
    channel_tile,
    check_conv_args,
    conv3d_ref,
    conv3d_weight_ref,
    device_check,
    fb1_plan,
    flip_t,
    split_plan,
)


def conv_transpose3d_ref(x: torch.Tensor, w: torch.Tensor,
                         bias: Optional[torch.Tensor] = None,
                         stride: int = 2) -> torch.Tensor:
    """The JAX package's transposed conv (lhs dilation `stride`, padding
    (k-1-p, s-1+p) with p = (k-1)//2, correlation weights) through PyTorch's
    built-in ConvTranspose3d: flip the taps and swap in/out channels."""
    k = w.shape[-1]
    p = (k - 1) // 2
    kw = dict(stride=stride, padding=p, output_padding=stride + 2 * p - k)
    wt = flip_t(w)
    if w.dim() == 6:
        b, cin, cout = wt.shape[:3]
        y = F.conv_transpose3d(x.reshape((1, b * cin) + x.shape[2:]),
                               wt.reshape((b * cin, cout) + wt.shape[3:]),
                               groups=b, **kw)
        y = y.reshape((b, cout) + y.shape[2:])
    else:
        y = F.conv_transpose3d(x, wt, **kw)
    if bias is not None:
        y = y + bias.to(y.dtype).reshape(1, -1, 1, 1, 1)
    return y


def conv3d_s2_plain(x: torch.Tensor, w: torch.Tensor,
                    bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of K2."""
    _build.count_plain("s2", x)
    return conv3d_ref(x, w, bias, stride=2)


def conv3d_t2_plain(x: torch.Tensor, w: torch.Tensor,
                    bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of K3."""
    _build.count_plain("t2", x)
    return conv_transpose3d_ref(x, w, bias, stride=2)


def conv3d_strided_dw_plain(full: torch.Tensor, half: torch.Tensor,
                            per_sample: bool) -> torch.Tensor:
    """Plain PyTorch version of KB2: the f32 weight gradient of the stride-2
    conv of `full` whose output cotangent is `half`."""
    _build.count_plain("strided_dw", full)
    return conv3d_weight_ref(full.float(), half.float(), 3, per_sample,
                             stride=2)


# KB2 (csrc/conv3d_dw_s2_tc.cu): a block owns SDW_CT channels of `full` x
# SDW_AT channels of `half` x 27 taps in registers and walks a run of bricks
# of half-resolution positions of one sample (221 KB of shared memory: one
# block an SM).
SDW_BRICK = (2, 4, 16)  # (bd, bh, bw) half positions; bw is one k16 mma step
SDW_CT = 16             # channels of `full` per block: one m16 tile
SDW_AT = 64             # channels of `half` per block (narrower ones pad with zeros)
SDW_BLOCKS = 132        # blocks a launch aims for: one wave of one block an SM
                        # (long runs: a run's first brick fills the pipeline,
                        # and only it copies its first positions along W)
SDW_MIN_BRICKS = 4      # bricks per split at least, for the partials' writes
SDW_MAX_BRICKS = 160    # and at most: KB1's cap in positions (DW_MAX_BRICKS
                        # bricks of 256), for the error of the f32 sums


def sdw_plan(b: int, cf: int, cp: int, d: int, h: int, w: int) -> DwPlan:
    """The cut of KB2 for full [b, cf, d, h, w] and half [b, cp,
    (d-1)//2+1, ...]: tiles of SDW_CT channels of `full` and SDW_AT of
    `half`, bricks of SDW_BRICK half positions, runs of SDW_MIN_BRICKS to
    SDW_MAX_BRICKS bricks, so that the launch has about SDW_BLOCKS blocks
    and at most GRID_MAX splits."""
    return split_plan(b, cf, cp, (_half(d), _half(h), _half(w)), 27,
                      SDW_BRICK, SDW_CT, SDW_AT, SDW_BLOCKS, SDW_MIN_BRICKS,
                      SDW_MAX_BRICKS)


def conv3d_strided_dw(full: torch.Tensor, half: torch.Tensor,
                      per_sample: bool) -> torch.Tensor:
    """M[cp, cf, t] = sum_p half[cp, p] * full[cf, 2p + t - 1] (taps t in
    3^3, zero outside `full`), f32 [Cp, Cf, 3, 3, 3], or [B, Cp, Cf, 3, 3,
    3] per sample: full [B, Cf, D, H, W], half [B, Cp, (D-1)//2+1, ...].
    For the stride-2 conv (full = x, half = g) M is dW; the transposed conv
    takes full = g, half = x. A CUDA tensor launches KB2 (bf16, cut as
    `sdw_plan` says) or FB1's strided map (f32, cut by `fb1_plan("s2",
    ...)`; half of full's dtype) or raises; a CPU tensor takes the plain
    version."""
    if not device_check("conv3d_strided_dw", full):
        return conv3d_strided_dw_plain(full, half, per_sample)
    dtype = _build.kernel_dtype("full", full)
    _build.check_cuda_input("full", full, 5, full.device, dtype)
    _build.check_cuda_input("half", half, 5, full.device, dtype)
    b, cf, d, h, wd = full.shape
    cp = half.shape[1]
    if half.shape[0] != b or tuple(half.shape[2:]) != (_half(d), _half(h), _half(wd)):
        raise ValueError(f"conv3d_strided_dw: half {tuple(half.shape)} is not "
                         f"the stride-2 grid of full {tuple(full.shape)}")
    if dtype == torch.float32:
        return _conv3d.dw_f32(fb1_plan("s2", b, cf, cp, d, h, wd), full, half,
                              per_sample)
    plan = sdw_plan(b, cf, cp, d, h, wd)
    ws = torch.empty(plan.workspace, dtype=torch.float32, device=full.device)
    out = torch.empty(((b,) if per_sample else ()) + (cp, cf, 3, 3, 3),
                      dtype=torch.float32, device=full.device)
    _build.launch("strided_dw", "coma_conv3d_strided_dw", full.device,
                  full.data_ptr(), half.data_ptr(), ws.data_ptr(),
                  out.data_ptr(), b, cf, cp, d, h, wd, int(per_sample),
                  plan.ct, plan.at, *plan.brick, plan.bps)
    return out


# K2 (csrc/conv3d_s2_tc.cu): a block owns AT output channels of one sample
# and walks bricks of S2_BRICK output positions, each in chunks of S2_CT
# input channels, every tap per chunk, staging the next step while it
# computes this one.
S2_BRICK = (2, 4, 16)   # (bd, bh, bw) output positions; bw is one m16 tile of mma
S2_CT = 16              # input channels per chunk: one k16 step
S2_BLOCKS = 132         # blocks a launch aims for: one a streaming multiprocessor
                        # of the H100 (199 KB of shared memory each at AT = 64)


class S2Plan(NamedTuple):
    """How one K2 or K3 call is cut. A block owns `at` output channels of
    one sample and walks bricks of `brick` positions (d, h, w) -- K2's
    output positions, K3's input positions, each with its 2 x 2 x 2 output
    cube -- staging Cin `ct` channels at a time. `grid` is the launch grid:
    blocks along the `bricks` bricks of a sample (block x walks bricks x,
    x + grid[0], ...), output-channel tiles, samples. `wpack` is the bf16
    length of the packed weights."""
    brick: Tuple[int, int, int]
    ct: int
    at: int
    bricks: int
    grid: Tuple[int, int, int]
    wpack: int


def s2_plan(b: int, cin: int, cout: int, d: int, h: int, w: int,
            per_sample: bool = False) -> S2Plan:
    """The cut of K2 for x [b, cin, d, h, w] and 3^3 weights to `cout`
    channels (per sample or shared): chunks of S2_CT input channels,
    AT = `channel_tile(cout)` output channels, bricks of S2_BRICK output
    positions of the ((n - 1) // 2 + 1)-per-axis output, and about
    S2_BLOCKS blocks in all, at least one per sample and output-channel
    tile and at most one per brick."""
    at = channel_tile(cout)
    bd, bh, bw = S2_BRICK
    bricks = _cdiv(_half(d), bd) * _cdiv(_half(h), bh) * _cdiv(_half(w), bw)
    tiles = _cdiv(cout, at)
    gx = min(bricks, _cdiv(S2_BLOCKS, tiles * b))
    wpack = (b if per_sample else 1) * tiles * _cdiv(cin, S2_CT) * 27 * at * S2_CT
    return S2Plan(S2_BRICK, S2_CT, at, bricks, (gx, tiles, b), wpack)


# F2 (csrc/conv3d_s2_f32_tc.cu, csrc/conv3d_t2_f32_tc.cu): K2's and K3's
# designs in f32, every product as three TF32 mma.sync. A block owns `at`
# output channels of one sample and walks bricks of F2_BRICK positions (the
# stride-2 map's output positions, the transposed map's input positions),
# each in chunks of F2_CT input channels; the packed weights hold the TF32
# hi and lo planes.
F2_MODES = ("s2", "t2")
F2_BRICK = (2, 4, 16)   # (bd, bh, bw) positions; bw is one m16 tile of mma
F2_CT = 8               # input channels per chunk: one k8 step of the TF32 mma
F2_T2_AT = 32           # the transposed map's output channels per block
F2_BLOCKS = 132         # blocks a launch aims for: one a streaming multiprocessor
                        # of the H100 (145,008 bytes of shared memory at AT = 64
                        # for the stride-2 map, 136,512 for the transposed one)


class F2Plan(NamedTuple):
    """How one F2 call is cut: `mode` "s2" (the stride-2 conv) or "t2"
    (the transposed conv); otherwise as `S2Plan`, with `wpack` the f32
    length of the packed weights (their TF32 hi and lo planes)."""
    mode: str
    brick: Tuple[int, int, int]
    ct: int
    at: int
    bricks: int
    grid: Tuple[int, int, int]
    wpack: int


def f2_plan(mode: str, b: int, cin: int, cout: int, d: int, h: int,
            w: int, per_sample: bool = False) -> F2Plan:
    """The cut of F2, the stride-2 conv (`mode` "s2") or the transposed
    conv ("t2") in f32, for x [b, cin, d, h, w] and 3^3 weights to `cout`
    channels (per sample or shared): chunks of F2_CT input channels, AT =
    64 output channels for the stride-2 map (32 where 32 hold the layer)
    and 32 for the transposed one, bricks of F2_BRICK positions of the
    grid the map walks (the ((n - 1) // 2 + 1)-per-axis output for "s2",
    the input for "t2"), and about F2_BLOCKS blocks in all, at least one
    per sample and output-channel tile and at most one per brick. Raises
    ValueError for a shape the kernels cannot take: an input (s2) or output
    (t2) of 2^31 voxels or more, more samples or channel tiles than a launch
    grid holds."""
    if mode not in F2_MODES:
        raise ValueError(f"f2_plan: mode is one of {F2_MODES}, got {mode!r}")
    voxels = d * h * w * (8 if mode == "t2" else 1)
    if min(b, cin, cout, d, h, w) <= 0 or voxels >= INT31:
        raise ValueError(f"f2_plan: cannot cut x [{b}, {cin}, {d}, {h}, {w}] to "
                         f"{cout} channels")
    at = F2_T2_AT if mode == "t2" else 32 if cout <= 32 else 64
    walk = (_half(d), _half(h), _half(w)) if mode == "s2" else (d, h, w)
    bricks = 1
    for n, e in zip(walk, F2_BRICK):
        bricks *= _cdiv(n, e)
    tiles = _cdiv(cout, at)
    if b > GRID_MAX or tiles > GRID_MAX:
        raise ValueError(f"f2_plan: cannot cut x [{b}, {cin}, {d}, {h}, {w}] to "
                         f"{cout} channels: {b} samples x {tiles} channel tiles")
    gx = min(bricks, _cdiv(F2_BLOCKS, tiles * b))
    wpack = (b if per_sample else 1) * tiles * _cdiv(cin, F2_CT) * 27 * 2 * at * F2_CT
    return F2Plan(mode, F2_BRICK, F2_CT, at, bricks, (gx, tiles, b), wpack)


def conv_f2(plan: F2Plan, x: torch.Tensor, w: torch.Tensor,
            bias32: Optional[torch.Tensor], per_sample: bool,
            flip: bool) -> torch.Tensor:
    """F2 on validated f32 CUDA tensors, cut as `plan` says (counted as
    `s2_f32` or `t2_f32`); `flip` convolves with `flip_t(w)`, which the
    weight packing reads from w in place."""
    b, cin, d, h, wd = x.shape
    cout = w.shape[-4] if flip else w.shape[-5]
    out = ((_half(d), _half(h), _half(wd)) if plan.mode == "s2"
           else (2 * d, 2 * h, 2 * wd))
    y = torch.empty((b, cout) + out, dtype=x.dtype, device=x.device)
    wpack = torch.empty(plan.wpack, dtype=torch.float32, device=x.device)
    _build.launch(_build.family(plan.mode, torch.float32),
                  f"coma_conv3d_{plan.mode}_f32_tc", x.device, x.data_ptr(),
                  w.data_ptr(), wpack.data_ptr(), _build.ptr(bias32),
                  y.data_ptr(), b, cin, cout, d, h, wd, int(per_sample),
                  int(flip), *plan.brick, plan.ct, plan.at, plan.grid[0])
    return y


def _k2(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor],
        flip: bool = False) -> torch.Tensor:
    """K2 (bf16) or F2's stride-2 map (f32) on a CUDA tensor, cut as
    `s2_plan` or `f2_plan` says; the plain version on a CPU tensor.
    `flip` convolves with `flip_t(w)` (the transposed conv's input
    gradient), which the kernel's weight packing reads from w in place."""
    if not device_check("conv3d_s2", x):
        return conv3d_s2_plain(x, flip_t(w) if flip else w, bias)
    _, per_sample, bias32 = check_conv_args(x, w, bias, (3,), flip)
    b, cin, d, h, wd = x.shape
    cout = w.shape[-4] if flip else w.shape[-5]
    if x.dtype == torch.float32:
        return conv_f2(f2_plan("s2", b, cin, cout, d, h, wd, per_sample), x, w,
                       bias32, per_sample, flip)
    plan = s2_plan(b, cin, cout, d, h, wd, per_sample)
    y = torch.empty((b, cout, _half(d), _half(h), _half(wd)), dtype=x.dtype,
                    device=x.device)
    wpack = torch.empty(plan.wpack, dtype=x.dtype, device=x.device)
    _build.launch("s2", "coma_conv3d_s2_tc", x.device, x.data_ptr(),
                  w.data_ptr(), wpack.data_ptr(), _build.ptr(bias32),
                  y.data_ptr(), b, cin, cout, d, h, wd, int(per_sample),
                  int(flip), *plan.brick, plan.ct, plan.at, plan.grid[0])
    return y


# K3 (csrc/conv3d_t2_tc.cu): a block owns T2_AT output channels of one
# sample and walks bricks of T2_BRICK input positions, each in chunks of
# T2_CT input channels, with the f32 sums of the brick's 8 parity classes in
# registers (128 a thread).
T2_BRICK = (2, 4, 16)   # (bd, bh, bw) input positions; bw is one m16 tile of mma
T2_CT = 16              # input channels per chunk: one k16 step
T2_AT = 32              # output channels per block (narrower layers pad with
                        # zeros, wider ones take tiles)
T2_BLOCKS = 132         # blocks a launch aims for: one a streaming multiprocessor
                        # of the H100 (202,560 bytes of shared memory each)


def t2_plan(b: int, cin: int, cout: int, d: int, h: int, w: int,
            per_sample: bool = False) -> S2Plan:
    """The cut of K3 for x [b, cin, d, h, w] (any sizes; the output is
    [b, cout, 2d, 2h, 2w]) and 3^3 weights to `cout` channels (per sample or
    shared): chunks of T2_CT input channels, tiles of T2_AT output
    channels, bricks of T2_BRICK input positions, and about T2_BLOCKS blocks
    in all, at least one per sample and output-channel tile and at most one
    per brick."""
    at = T2_AT
    bd, bh, bw = T2_BRICK
    bricks = _cdiv(d, bd) * _cdiv(h, bh) * _cdiv(w, bw)
    tiles = _cdiv(cout, at)
    gx = min(bricks, _cdiv(T2_BLOCKS, tiles * b))
    wpack = (b if per_sample else 1) * tiles * _cdiv(cin, T2_CT) * 27 * at * T2_CT
    return S2Plan(T2_BRICK, T2_CT, at, bricks, (gx, tiles, b), wpack)


def _k3(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor],
        flip: bool = False) -> torch.Tensor:
    """K3 (bf16) or F2's transposed map (f32) on a CUDA tensor, cut as
    `t2_plan` or `f2_plan` says; the plain version on a CPU tensor.
    `flip` convolves with `flip_t(w)` (the stride-2 conv's input
    gradient), which the kernel's weight packing reads from w in place."""
    if not device_check("conv3d_t2", x):
        return conv3d_t2_plain(x, flip_t(w) if flip else w, bias)
    _, per_sample, bias32 = check_conv_args(x, w, bias, (3,), flip)
    b, cin, d, h, wd = x.shape
    cout = w.shape[-4] if flip else w.shape[-5]
    if x.dtype == torch.float32:
        return conv_f2(f2_plan("t2", b, cin, cout, d, h, wd, per_sample), x, w,
                       bias32, per_sample, flip)
    plan = t2_plan(b, cin, cout, d, h, wd, per_sample)
    y = torch.empty((b, cout, 2 * d, 2 * h, 2 * wd), dtype=x.dtype,
                    device=x.device)
    wpack = torch.empty(plan.wpack, dtype=x.dtype, device=x.device)
    _build.launch("t2", "coma_conv3d_t2", x.device, x.data_ptr(),
                  w.data_ptr(), wpack.data_ptr(), _build.ptr(bias32),
                  y.data_ptr(), b, cin, cout, d, h, wd, int(per_sample),
                  int(flip), *plan.brick, plan.ct, plan.at, plan.grid[0])
    return y


def conv3d_t2_dx(g: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Input gradient of the stride-2 conv with weights w (shared or per
    sample) for the output cotangent g: the transposed conv of g with
    `flip_t(w)`, K3 on a CUDA tensor (its weight packing reads w flipped in
    place) or the plain version on a CPU tensor."""
    return _k3(g, w, None, flip=True)


def conv3d_s2_dx(g: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Input gradient of the transposed stride-2 conv with weights w (shared
    or per sample) for the output cotangent g: the stride-2 conv of g with
    `flip_t(w)`, K2 on a CUDA tensor (its weight packing reads w flipped in
    place) or the plain version on a CPU tensor."""
    return _k2(g, w, None, flip=True)


def _input_grad(dx: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    if dx.shape != like.shape:
        raise ValueError(f"input gradient {tuple(dx.shape)} does not match "
                         f"the input {tuple(like.shape)}: the strided pair is "
                         f"each other's adjoint only for even sizes")
    return dx


class Conv3dS2(torch.autograd.Function):
    """Stride-2 conv; backward as `conv3d_strided.py:_s2_vjp_bwd`: dx is K3
    on g with `flip_t(w)` (`conv3d_t2_dx`), dW is KB2 (full = x, half =
    g)."""

    @staticmethod
    def forward(ctx, x, w, bias):
        ctx.save_for_backward(x, w, bias)
        return _k2(x, w, bias)

    @staticmethod
    def backward(ctx, g):
        x, w, bias = ctx.saved_tensors
        gx = g.to(x.dtype).contiguous()
        dx = dw = dbias = None
        if ctx.needs_input_grad[0]:
            dx = _input_grad(conv3d_t2_dx(gx, w), x)
        if ctx.needs_input_grad[1]:
            dw = conv3d_strided_dw(x, gx, w.dim() == 6).to(w.dtype)
        if ctx.needs_input_grad[2]:
            dbias = bias_grad(g, bias)
        return dx, dw, dbias


class Conv3dT2(torch.autograd.Function):
    """Transposed stride-2 conv; backward as `_t2_vjp_bwd`: dx is K2 on g
    with `flip_t(w)` (`conv3d_s2_dx`), dW is KB2 (full = g, half = x) with
    its channel axes swapped and its taps flipped."""

    @staticmethod
    def forward(ctx, x, w, bias):
        ctx.save_for_backward(x, w, bias)
        return _k3(x, w, bias)

    @staticmethod
    def backward(ctx, g):
        x, w, bias = ctx.saved_tensors
        gx = g.to(x.dtype).contiguous()
        dx = dw = dbias = None
        if ctx.needs_input_grad[0]:
            dx = _input_grad(conv3d_s2_dx(gx, w), x)
        if ctx.needs_input_grad[1]:
            m = conv3d_strided_dw(gx, x, w.dim() == 6)  # [(B,) Cin, Cout, taps]
            dw = torch.flip(m.transpose(-5, -4), dims=(-3, -2, -1)).to(w.dtype)
        if ctx.needs_input_grad[2]:
            dbias = bias_grad(g, bias)
        return dx, dw, dbias


def conv3d_s2(x: torch.Tensor, w: torch.Tensor,
              bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Stride-2 SAME k=3 conv (padding 1/1): [B, Cin, D, H, W] ->
    [B, Cout, (D-1)//2+1, (H-1)//2+1, (W-1)//2+1], differentiable in x, w
    and bias. A CUDA tensor launches K2 (bf16, cut as `s2_plan` says; K3 as
    `conv3d_t2_dx` and KB2 in the backward) or F2 (f32, cut as `f2_plan`
    says; F2's transposed map and FB1 in the backward), x and w of one
    dtype, or raises; a CPU tensor takes the plain versions."""
    device_check("conv3d_s2", x)
    return Conv3dS2.apply(x, w, bias)


def conv3d_t2(x: torch.Tensor, w: torch.Tensor,
              bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Transposed stride-2 k=3 conv, [B, Cin, D, H, W] -> [B, Cout, 2D, 2H,
    2W] (= ConvTranspose3d(padding=1, output_padding=1) with flipped,
    io-swapped weights), differentiable in x, w and bias. A CUDA tensor
    launches K3 (bf16, cut as `t2_plan` says; K2 as `conv3d_s2_dx` and KB2
    in the backward) or F2 (f32, cut as `f2_plan` says; F2's stride-2 map
    and FB1 in the backward), x and w of one dtype, or raises; a CPU tensor
    takes the plain versions."""
    device_check("conv3d_t2", x)
    return Conv3dT2.apply(x, w, bias)
