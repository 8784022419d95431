"""Stride-1 SAME 3-D convolution, k in {1, 3}, and its gradients: kernel K1
(forward, and the input gradient with flipped, io-swapped weights), kernel
KB1 (the weight gradient) and their plain versions.

Counterpart of `coma_unet_tpu/ops/pallas/conv3d.py` (`pallas_conv3d`,
`pallas_conv3d_b` and their custom VJPs: `_pallas_conv3d_fwd`,
`_pallas_conv3d_dw`), `conv3d_p1.py` (`_p1_fwd`, `_p1_dw`) and
`conv3d_packed.py` (`_packed_fwd`, `_packed_dw`): the three compute one
function, split on the TPU only by its 128-lane tiling. Layouts are the JAX
package's: x NCDHW, w OIDHW `[Cout, Cin, k, k, k]` shared or
`[B, Cout, Cin, k, k, k]` per sample. `conv3d_s1` is a
`torch.autograd.Function`: on a CUDA tensor its forward and backward launch
the kernels or raise; on a CPU tensor they run the plain versions.

K1 (`csrc/conv3d_s1_tc.cu`) is one tensor-core kernel for every call:
`mma.sync` over 4 or 8 x 4 x 16 bricks of output positions and 16-channel
chunks of Cin, cut as `s1_plan` says. As the input gradient it reads
`flip_t(w)` from w in place. KB1 (`csrc/conv3d_dw_tc.cu`) is cut by
`dw_plan`.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from coma_unet_tpu_torch.ops import _build


def conv3d_ref(x: torch.Tensor, w: torch.Tensor,
               bias: Optional[torch.Tensor] = None,
               stride: int = 1) -> torch.Tensor:
    """SAME-padded (k // 2) correlation through PyTorch's built-in conv, for
    shared or per-sample weights; the bias is added in x's dtype."""
    k = w.shape[-1]
    if w.dim() == 6:
        b, cout, cin = w.shape[:3]
        y = F.conv3d(x.reshape((1, b * cin) + x.shape[2:]),
                     w.reshape((b * cout, cin) + w.shape[3:]),
                     stride=stride, padding=k // 2, groups=b)
        y = y.reshape((b, cout) + y.shape[2:])
    else:
        y = F.conv3d(x, w, stride=stride, padding=k // 2)
    if bias is not None:
        y = y + bias.to(y.dtype).reshape(1, -1, 1, 1, 1)
    return y


def conv3d_weight_ref(x: torch.Tensor, g: torch.Tensor, k: int,
                      per_sample: bool, stride: int = 1) -> torch.Tensor:
    """Weight gradient of `conv3d_ref(x, w, stride=stride)` for the output
    cotangent g, through PyTorch's built-in in the operands' dtype (for bf16
    operands, what autograd of a bf16 conv runs): [Cout, Cin, k, k, k], or
    [B, Cout, Cin, k, k, k] per sample (a grouped conv over the batch)."""
    b, cin = x.shape[:2]
    cout = g.shape[1]
    kw = dict(stride=stride, padding=k // 2)
    if not per_sample:
        return torch.nn.grad.conv3d_weight(x, (cout, cin, k, k, k), g, **kw)
    dw = torch.nn.grad.conv3d_weight(
        x.reshape((1, b * cin) + x.shape[2:]), (b * cout, cin, k, k, k),
        g.reshape((1, b * cout) + g.shape[2:]), groups=b, **kw)
    return dw.reshape(b, cout, cin, k, k, k)


def flip_t(w: torch.Tensor) -> torch.Tensor:
    """Spatially flipped, io-swapped weights, shared [Cout, Cin, k, k, k] ->
    [Cin, Cout, k, k, k] or per sample [B, Cout, Cin, ...] -> [B, Cin, Cout,
    ...]: the conv with these weights is the adjoint in x of the conv with
    w (stride 1), and the strided pair's adjoints likewise."""
    return torch.flip(w, dims=(-3, -2, -1)).transpose(-5, -4).contiguous()


def conv3d_s1_plain(x: torch.Tensor, w: torch.Tensor,
                    bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of K1."""
    _build.count_plain("s1", x)
    return conv3d_ref(x, w, bias, stride=1)


def conv3d_s1_dw_plain(x: torch.Tensor, g: torch.Tensor, k: int,
                       per_sample: bool) -> torch.Tensor:
    """Plain PyTorch version of KB1: f32 dW of the stride-1 SAME conv."""
    _build.count_plain("s1_dw", x)
    return conv3d_weight_ref(x.float(), g.float(), k, per_sample)


def check_conv_args(x: torch.Tensor, w: torch.Tensor,
                    bias: Optional[torch.Tensor], ks: Sequence[int],
                    io_swapped: bool = False):
    """Validate a CUDA conv call with weights w, or with `flip_t(w)` where
    `io_swapped`; return (k, per_sample, f32 bias or None)."""
    _build.check_cuda_input("x", x, 5, x.device)
    per_sample = w.dim() == 6
    _build.check_cuda_input("w", w, 6 if per_sample else 5, x.device)
    k = w.shape[-1]
    cout, cin = w.shape[-5], w.shape[-4]
    if io_swapped:
        cout, cin = cin, cout
    if (k not in ks or tuple(w.shape[-3:]) != (k, k, k) or cin != x.shape[1]
            or (per_sample and w.shape[0] != x.shape[0])):
        raise ValueError(f"weights {tuple(w.shape)} do not fit input "
                         f"{tuple(x.shape)} (k in {tuple(ks)})")
    if bias is None:
        return k, per_sample, None
    if tuple(bias.shape) != (cout,) or bias.device != x.device:
        raise ValueError(f"bias {tuple(bias.shape)} on {bias.device} is not "
                         f"[{cout}] on {x.device}")
    return k, per_sample, bias.detach().float().contiguous()


def device_check(name: str, x: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU tensor; raise otherwise."""
    if x.is_cuda:
        return True
    if x.device.type != "cpu":
        raise ValueError(f"{name}: unsupported device {x.device}")
    return False


def _k1(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor],
        flip: bool = False) -> torch.Tensor:
    """K1 on a CUDA tensor, cut as `s1_plan` says; the plain version on a
    CPU tensor. `flip` convolves with `flip_t(w)` (the input gradient),
    which the kernel's weight packing reads from w in place."""
    if not device_check("conv3d_s1", x):
        return conv3d_s1_plain(x, flip_t(w) if flip else w, bias)
    k, per_sample, bias32 = check_conv_args(x, w, bias, (1, 3), flip)
    b, cin, d, h, wd = x.shape
    cout = w.shape[-4] if flip else w.shape[-5]
    plan = s1_plan(b, cin, cout, d, h, wd, k, per_sample)
    y = torch.empty((b, cout, d, h, wd), dtype=x.dtype, device=x.device)
    wpack = torch.empty(plan.wpack, dtype=x.dtype, device=x.device)
    _build.launch("s1", "coma_conv3d_s1_tc", x.device, x.data_ptr(),
                  w.data_ptr(), wpack.data_ptr(), _build.ptr(bias32),
                  y.data_ptr(), b, cin, cout, d, h, wd, k, int(per_sample),
                  int(flip), *plan.brick, plan.ct, plan.at, plan.grid[0])
    return y


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


GRID_MAX = 65535        # CUDA's limit on grid.y and grid.z (and K1's grid.x)

# K1 (csrc/conv3d_s1_tc.cu): a block owns a brick of output positions of one
# sample x AT output channels in registers and walks Cin in chunks of S1_CT
# channels, every tap per chunk.
S1_BH, S1_BW = 4, 16    # the brick's H and W extent; bw is one m16 tile of mma
S1_CT = 16              # input channels per chunk: one k16 step


class S1Plan(NamedTuple):
    """How one K1 call is cut. A block owns `brick` output positions
    (d, h, w) of one sample and `at` output channels and stages Cin `ct`
    channels at a time. `grid` is the launch grid: blocks along the
    `bricks` bricks of a sample (each walking bricks grid[0] apart),
    output-channel tiles, samples. `wpack` is the bf16 length of the
    packed weights."""
    brick: Tuple[int, int, int]
    ct: int
    at: int
    bricks: int
    grid: Tuple[int, int, int]
    wpack: int


def channel_tile(cout: int) -> int:
    """AT of the tensor-core convs K1 and K2: 8, 16, 32 or 64 output
    channels, the smallest that holds the layer, up to 64 (narrower layers
    pad with zeros)."""
    return 8 if cout <= 8 else 16 if cout <= 16 else 32 if cout <= 32 else 64


def s1_plan(b: int, cin: int, cout: int, d: int, h: int, w: int, k: int,
            per_sample: bool = False) -> S1Plan:
    """The cut of K1 for x [b, cin, d, h, w] and k^3 weights to `cout`
    channels (per sample or shared): chunks of S1_CT input channels,
    AT = `channel_tile(cout)` output channels and bricks of
    (bd, S1_BH, S1_BW) positions, bd = 8 for k = 3 at AT = 32 (a warp's
    tile then holds as many products as at AT = 64) and 4 otherwise; at
    most GRID_MAX blocks along the bricks."""
    at = channel_tile(cout)
    brick = (8 if k == 3 and at == 32 else 4, S1_BH, S1_BW)
    bricks = _cdiv(d, brick[0]) * _cdiv(h, S1_BH) * _cdiv(w, S1_BW)
    tiles = _cdiv(cout, at)
    wpack = ((b if per_sample else 1) * tiles * _cdiv(cin, S1_CT) * k ** 3
             * at * S1_CT)
    return S1Plan(brick, S1_CT, at, bricks, (min(bricks, GRID_MAX), tiles, b),
                  wpack)


# KB1 (csrc/conv3d_dw_tc.cu): a block owns CT input channels x AT output
# channels x k^3 taps of dW in registers and walks a run of bricks of
# positions of one sample, one brick per shared-memory stage.
DW_BRICK = (4, 4, 16)   # (bd, bh, bw) positions per brick; bw is one k16 mma step
DW_TC_BLOCKS = 8 * 132  # blocks a launch aims for: 4 waves of 2 blocks per SM
DW_MIN_BRICKS = 4       # bricks per split at least, for the partials' writes
DW_MAX_BRICKS = 80      # and at most: the error of the tensor cores' f32 sums
                        # grows with the run (216^3 merge0 on an H100,
                        # chip_smoke.py phase 3: 2.1e-5 of max|dW| at 19840
                        # positions a split, 4.1e-5 at 39680)


class DwPlan(NamedTuple):
    """How one KB1 or KB2 call is cut. The bricks of each sample (`bricks`
    of `brick` positions, in order w fastest) are split into
    `splits_per_sample` runs of `bps` bricks (`positions` positions), so
    no split straddles two samples. Each split writes its partial dW to
    `workspace` floats of f32 scratch, and a second launch sums the
    partials in split order. `grid` is the launch grid: channel tiles of
    `ct` along mma's M (KB1's input channels, KB2's `full`), of `at` along
    its N (KB1's output channels, KB2's `half`), splits."""
    brick: Tuple[int, int, int]
    ct: int
    at: int
    bricks: int
    bps: int
    positions: int
    splits_per_sample: int
    splits: int
    workspace: int
    grid: Tuple[int, int, int]


def dw_plan(b: int, cin: int, cout: int, d: int, h: int, w: int,
            k: int) -> DwPlan:
    """The cut of KB1 for x [b, cin, d, h, w] and g [b, cout, d, h, w]:
    tiles of CT input channels (16 for k = 3, whose block then fits twice
    on an SM; 16 or 32 for k = 1) and AT = 8, 16 or 32 output channels (the
    smallest that holds the layer, up to 32; narrower layers pad with
    zeros), and runs of DW_MIN_BRICKS to DW_MAX_BRICKS bricks, so that the
    launch has about DW_TC_BLOCKS blocks and at most GRID_MAX splits."""
    ct = 16 if cin <= 16 or k == 3 else 32
    at = 8 if cout <= 8 else 16 if cout <= 16 else 32
    return split_plan(b, cin, cout, (d, h, w), k ** 3, DW_BRICK, ct, at,
                      DW_TC_BLOCKS, DW_MIN_BRICKS, DW_MAX_BRICKS)


def split_plan(b: int, c: int, a: int, size: Tuple[int, int, int], taps: int,
               brick: Tuple[int, int, int], ct: int, at: int, blocks: int,
               lo: int, hi: int) -> DwPlan:
    """The split-K cut of a weight gradient (KB1, KB2) over the positions
    `size` of b samples, in bricks of `brick` positions, for tiles of `ct`
    of the c channels along mma's M and `at` of the a channels along its N,
    with taps per channel pair: runs of `lo` to `hi` bricks, so that the
    launch has about `blocks` blocks and at most GRID_MAX splits."""
    bricks = 1
    for n, m in zip(size, brick):
        bricks *= _cdiv(n, m)
    tiles = _cdiv(c, ct) * _cdiv(a, at)
    want = _cdiv(max(1, blocks // tiles), b)  # splits per sample
    bps = min(max(lo, _cdiv(bricks, want)), hi)
    bps = max(bps, _cdiv(bricks * b, GRID_MAX))
    sps = _cdiv(bricks, bps)
    positions = bps * brick[0] * brick[1] * brick[2]
    return DwPlan(brick, ct, at, bricks, bps, positions, sps, b * sps,
                  b * sps * a * c * taps, (_cdiv(c, ct), _cdiv(a, at), b * sps))


def conv3d_s1_dw(x: torch.Tensor, g: torch.Tensor, k: int,
                 per_sample: bool) -> torch.Tensor:
    """Weight gradient of the stride-1 SAME conv, f32: [Cout, Cin, k, k, k],
    or [B, Cout, Cin, k, k, k] per sample, from x [B, Cin, ...] and the
    output cotangent g [B, Cout, ...]. A CUDA tensor launches KB1 (bf16
    only), cut as `dw_plan` says, or raises; a CPU tensor takes the plain
    version."""
    if not device_check("conv3d_s1_dw", x):
        return conv3d_s1_dw_plain(x, g, k, per_sample)
    _build.check_cuda_input("x", x, 5, x.device)
    _build.check_cuda_input("g", g, 5, x.device)
    b, cin, d, h, wd = x.shape
    cout = g.shape[1]
    if k not in (1, 3) or g.shape[0] != b or tuple(g.shape[2:]) != (d, h, wd):
        raise ValueError(f"conv3d_s1_dw: x {tuple(x.shape)} and g "
                         f"{tuple(g.shape)} do not fit a k={k} conv")
    plan = dw_plan(b, cin, cout, d, h, wd, k)
    ws = torch.empty(plan.workspace, dtype=torch.float32, device=x.device)
    out = torch.empty(((b,) if per_sample else ()) + (cout, cin, k, k, k),
                      dtype=torch.float32, device=x.device)
    _build.launch("s1_dw", "coma_conv3d_s1_dw", x.device, x.data_ptr(),
                  g.data_ptr(), ws.data_ptr(), out.data_ptr(), b, cin, cout,
                  d, h, wd, k, int(per_sample), plan.ct, plan.at, *plan.brick,
                  plan.bps)
    return out


def bias_grad(g: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """dbias: the output cotangent summed over all but the channel axis, in
    f32 (the JAX package leaves the bias to XLA; so does the port)."""
    return g.float().sum(dim=(0, 2, 3, 4)).to(bias.dtype)


def conv3d_s1_dx(g: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Input gradient of the stride-1 SAME conv with weights w (shared or
    per sample) for the output cotangent g: the conv of g with `flip_t(w)`,
    K1 on a CUDA tensor (its weight packing reads w flipped in place) or
    the plain version on a CPU tensor."""
    return _k1(g, w, None, flip=True)


class Conv3dS1(torch.autograd.Function):
    """y = conv(x, w) + bias; backward as `conv3d.py:_bwd`/`_bwd_b`: dx is
    K1 on g with `flip_t(w)` (`conv3d_s1_dx`), dW is KB1, dbias a plain
    reduction."""

    @staticmethod
    def forward(ctx, x, w, bias):
        ctx.save_for_backward(x, w, bias)
        return _k1(x, w, bias)

    @staticmethod
    def backward(ctx, g):
        x, w, bias = ctx.saved_tensors
        gx = g.to(x.dtype).contiguous()
        dx = dw = dbias = None
        if ctx.needs_input_grad[0]:
            dx = conv3d_s1_dx(gx, w)
        if ctx.needs_input_grad[1]:
            dw = conv3d_s1_dw(x, gx, w.shape[-1], w.dim() == 6).to(w.dtype)
        if ctx.needs_input_grad[2]:
            dbias = bias_grad(g, bias)
        return dx, dw, dbias


def conv3d_s1(x: torch.Tensor, w: torch.Tensor,
              bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y = conv(x, w) + bias, stride 1, SAME padding, k = w.shape[-1] in
    {1, 3}, differentiable in x, w and bias. A CUDA tensor launches K1
    (bf16 only, cut as `s1_plan` says; KB1 and K1 in the backward) or
    raises; a CPU tensor takes the plain versions."""
    device_check("conv3d_s1", x)
    return Conv3dS1.apply(x, w, bias)


def conv3d_w64(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Stride-1 SAME k=3 conv of x [B, Cin, D, H, 64] (D even) with shared
    weights w [Cout, Cin, 3, 3, 3]: counterpart of `coma_unet_tpu/ops/
    pallas/conv3d_packed.py:pallas_conv3d_w64`. The TPU packs D-pairs onto
    its 128 lanes around the kernel; here it is K1 on the plain layout."""
    if (x.dim() != 5 or x.shape[-1] != 64 or x.shape[2] % 2
            or w.dim() != 5 or tuple(w.shape[2:]) != (3, 3, 3)):
        raise ValueError(f"conv3d_w64 takes x [B, C, D even, H, 64] and w "
                         f"[Cout, Cin, 3, 3, 3], got {tuple(x.shape)} and "
                         f"{tuple(w.shape)}")
    return conv3d_s1(x, w)
