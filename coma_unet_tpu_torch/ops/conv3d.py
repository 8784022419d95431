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
`dw_plan`. Both take bf16. Their float32 forms, for a CUDA tensor of dtype
float32: F1 (`csrc/conv3d_s1_f32_tc.cu`, cut by `f1_plan`) is K1's design on
the tensor cores in 3xTF32 (every product three TF32 `mma.sync`, so the sums
keep f32's accuracy), over 8-channel chunks; FB1 (`csrc/conv3d_dw_f32_tc.cu`,
cut by `fb1_plan`) is KB1's and KB2's per-tap GEMM in 3xTF32.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from coma_unet_tpu_torch.ops import _build


def conv3d_ref(x: torch.Tensor, w: torch.Tensor,
               bias: Optional[torch.Tensor] = None,
               stride: int = 1) -> torch.Tensor:
    """SAME-padded correlation through PyTorch's built-in conv, for shared
    or per-sample weights; the bias is added in x's dtype. The padding is
    the JAX package's `same_padding`, (k // 2, k - 1 - k // 2) on each
    axis, whatever the stride: symmetric for odd k, one less on the high
    side for even k (the k=16 s=16 and k=2 s=2 patch embeddings)."""
    k = w.shape[-1]
    pad = k // 2
    if k % 2 == 0:
        x = F.pad(x, (k // 2, k // 2 - 1) * 3)
        pad = 0
    if w.dim() == 6:
        b, cout, cin = w.shape[:3]
        y = F.conv3d(x.reshape((1, b * cin) + x.shape[2:]),
                     w.reshape((b * cout, cin) + w.shape[3:]),
                     stride=stride, padding=pad, groups=b)
        y = y.reshape((b, cout) + y.shape[2:])
    else:
        y = F.conv3d(x, w, stride=stride, padding=pad)
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
    `io_swapped`: x bf16 or f32, w of x's dtype; return (k, per_sample,
    f32 bias or None)."""
    dtype = _build.kernel_dtype("x", x)
    _build.check_cuda_input("x", x, 5, x.device, dtype)
    per_sample = w.dim() == 6
    _build.check_cuda_input("w", w, 6 if per_sample else 5, x.device, dtype)
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
    """K1 (bf16, cut as `s1_plan` says) or F1 (f32, cut as `f1_plan` says)
    on a CUDA tensor; the plain version on a CPU tensor. `flip` convolves
    with `flip_t(w)` (the input gradient), which the kernels' weight packing
    reads from w in place."""
    if not device_check("conv3d_s1", x):
        return conv3d_s1_plain(x, flip_t(w) if flip else w, bias)
    k, per_sample, bias32 = check_conv_args(x, w, bias, (1, 3), flip)
    b, cin, d, h, wd = x.shape
    cout = w.shape[-4] if flip else w.shape[-5]
    if x.dtype == torch.float32:
        return conv_f32(f1_plan(b, cin, cout, d, h, wd, k, per_sample), x, w,
                        bias32, per_sample, flip)
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


def _half(n: int) -> int:
    """Positions along an axis of n of the stride-2 SAME conv's output."""
    return (n - 1) // 2 + 1


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


# F1 (csrc/conv3d_s1_f32_tc.cu): K1's design in f32, every product as three
# TF32 mma.sync. A block owns `at` output channels of one sample and walks
# bricks of (bd, S1_BH, S1_BW) output positions, each in chunks of F1_CT
# input channels and per chunk its taps in k groups (one kd each); the
# packed weights hold the TF32 hi and lo planes.
F1_CT = 8               # input channels per chunk: one k8 step of the TF32 mma
F1_BLOCKS = 132         # blocks a launch aims for at one block an SM (the H100's
                        # SMs; 201,472 bytes of shared memory at k = 3, AT = 64)
SMEM_MAX = 227 * 1024   # shared memory a CTA may have on the H100
INT31 = 2 ** 31


class F1Plan(NamedTuple):
    """How one F1 call is cut: as `S1Plan`, with the taps per axis `k`,
    the blocks an SM the tile holds `per_sm` (its registers and shared
    memory), and `wpack` the f32 length of the packed weights (their TF32 hi
    and lo planes)."""
    k: int
    brick: Tuple[int, int, int]
    ct: int
    at: int
    per_sm: int
    bricks: int
    grid: Tuple[int, int, int]
    wpack: int


def f1_plan(b: int, cin: int, cout: int, d: int, h: int, w: int, k: int,
            per_sample: bool = False) -> F1Plan:
    """The cut of F1, the stride-1 SAME conv in f32 (k in {1, 3}), for x
    [b, cin, d, h, w] and k^3 weights to `cout` channels (per sample or
    shared): chunks of F1_CT input channels, AT = `channel_tile(cout)`
    output channels, bricks of (bd, S1_BH, S1_BW) positions with bd = 8 for
    k = 3 at AT = 32 and 4 otherwise (K1's tiles), and about F1_BLOCKS x
    `per_sm` blocks in all (two an SM for the tiles of fewer than 8 m16n8
    tiles a warp, AT <= 16, which fit 128 registers), at least one per
    sample and output-channel tile and at most one per brick. Raises
    ValueError for a shape the kernel cannot take: k not 1 or 3, a volume
    of 2^31 voxels or more, more samples or channel tiles than a launch
    grid holds."""
    if k not in (1, 3):
        raise ValueError(f"f1_plan: takes k in (1, 3), got {k}")
    if min(b, cin, cout, d, h, w) <= 0 or d * h * w >= INT31:
        raise ValueError(f"f1_plan: cannot cut x [{b}, {cin}, {d}, {h}, {w}] to "
                         f"{cout} channels")
    at = channel_tile(cout)
    brick = (8 if k == 3 and at == 32 else 4, S1_BH, S1_BW)
    # m16n8 tiles a warp: 8 warps over the brick's rows and at / 8 n-tiles
    per_sm = 1 if brick[0] * S1_BH * at // 8 >= 8 * 8 else 2
    bricks = _cdiv(d, brick[0]) * _cdiv(h, S1_BH) * _cdiv(w, S1_BW)
    tiles = _cdiv(cout, at)
    if b > GRID_MAX or tiles > GRID_MAX:
        raise ValueError(f"f1_plan: cannot cut x [{b}, {cin}, {d}, {h}, {w}] to "
                         f"{cout} channels: {b} samples x {tiles} channel tiles")
    gx = min(bricks, _cdiv(F1_BLOCKS * per_sm, tiles * b))
    wpack = (b if per_sample else 1) * tiles * _cdiv(cin, F1_CT) * k ** 3 * 2 * at * F1_CT
    return F1Plan(k, brick, F1_CT, at, per_sm, bricks, (gx, tiles, b), wpack)


def conv_f32(plan: F1Plan, x: torch.Tensor, w: torch.Tensor,
             bias32: Optional[torch.Tensor], per_sample: bool,
             flip: bool) -> torch.Tensor:
    """F1 on validated f32 CUDA tensors, cut as `plan` says (counted as
    `s1_f32`); `flip` convolves with `flip_t(w)`, which the weight packing
    reads from w in place."""
    b, cin, d, h, wd = x.shape
    cout = w.shape[-4] if flip else w.shape[-5]
    y = torch.empty((b, cout, d, h, wd), dtype=x.dtype, device=x.device)
    wpack = torch.empty(plan.wpack, dtype=torch.float32, device=x.device)
    _build.launch(_build.family("s1", torch.float32), "coma_conv3d_s1_f32_tc", x.device,
                  x.data_ptr(), w.data_ptr(), wpack.data_ptr(), _build.ptr(bias32),
                  y.data_ptr(), b, cin, cout, d, h, wd, plan.k, int(per_sample),
                  int(flip), *plan.brick, plan.ct, plan.at, plan.grid[0])
    return y


# FB1 (csrc/conv3d_dw_f32_tc.cu): the float32 weight gradients on the tensor
# cores in 3xTF32, a per-tap GEMM over positions, M = channels of X (x, or
# the strided map's full) and N = channels of G (g, or half), swapped for a
# layer of fewer than FB1_SWAP channels of X. A block owns FB1_MC channels
# along M per m-tile x 8 along N per n-tile x k^3 taps and walks a run of
# bricks of G's grid of one sample; its 8 warps each own 3 or 4 of the 27
# taps (k = 3) or share the brick's k8 steps (k = 1).
FB1_BH, FB1_BW = 4, 16  # a brick's extent along H and W; a W row is two k8 steps
FB1_WARPS = 8           # a block's warps: k = 3 warp w owns taps w + 8 i
FB1_MC = 16             # channels a m-tile (M), FB1_NC an n-tile (N)
FB1_NC = 8
FB1_SWAP = 8            # fewer channels of X than this put G's channels on M
FB1_BLOCKS = 132        # blocks an SM holds times this: one wave on the H100


class FdwPlan(NamedTuple):
    """How one FB1 call is cut. `mode` 0 (S1) or 1 (S2, the strided map),
    `k` taps per axis; `swap` puts G's channels on mma's M; a warp holds
    `mt` m-tiles x `nt` n-tiles of its taps. A block of `threads` owns `ct`
    channels of X (x; S2: full) and `at` of G (g; S2: half); it stages X's
    `box` (positions, each in a row of `row` floats) and G's tile per brick
    of `brick` positions, two in flight (`smem` bytes), and fits `per_sm`
    blocks an SM. The bricks of G's grid of each sample (`bricks`, w
    fastest) are cut into `splits_per_sample` runs of `bps` (`positions`
    positions), each writing its partial to `workspace` floats, summed in
    split order by a second launch; `grid` is (X tiles, G tiles, splits)."""
    mode: int
    k: int
    swap: bool
    mt: int
    nt: int
    threads: int
    brick: Tuple[int, int, int]
    box: Tuple[int, int, int]
    row: int
    ct: int
    at: int
    per_sm: int
    bricks: int
    bps: int
    positions: int
    splits_per_sample: int
    splits: int
    workspace: int
    grid: Tuple[int, int, int]
    smem: int


def fb1_plan(mode: str, b: int, cin: int, cout: int, d: int, h: int, w: int,
             k: int = 3) -> FdwPlan:
    """The cut of FB1 for X [b, cin, d, h, w] (S1: x; "s2": the stride-2
    conv's full) and G [b, cout, ...] on G's grid (S1: X's; "s2": the
    stride-2 grid, k = 3): with fewer than FB1_SWAP channels of X (S1 only)
    G's channels on M, mt = 1 m-tile (2 for more than 16 channels of G at
    k = 3) and nt = 1 n-tile, else X's on M, mt = 1 and nt = 1, 2 or 4 (the
    fewest n-tiles of 8 that hold G's channels, up to 4; S2 4, for its
    path's 64 channels of half); bricks of (4, 4, 16) positions for S1
    k = 3, (2, 4, 16) for k = 1 and (1, 4, 16) for S2; runs of bricks so
    that the launch has at most FB1_BLOCKS x `per_sm` blocks (one wave), or
    one split a sample where the tiles and samples alone exceed that, at
    least one brick a split and at most GRID_MAX splits. Raises ValueError
    for a shape it cannot cut: a mode and k the kernel lacks, a volume of
    2^31 voxels or more, more G tiles or splits than a launch grid holds."""
    m = {"s1": 0, "s2": 1}[mode]
    if k not in ((1, 3) if m == 0 else (3,)):
        raise ValueError(f"fb1_plan: {mode} takes k in {(1, 3) if m == 0 else (3,)}, "
                         f"got {k}")
    if min(b, cin, cout, d, h, w) <= 0 or d * h * w >= INT31:
        raise ValueError(f"fb1_plan: cannot cut x [{b}, {cin}, {d}, {h}, {w}] and "
                         f"{cout} channels of g")
    swap = m == 0 and cin < FB1_SWAP
    if swap:
        mt, nt = (2 if k == 3 and cout > FB1_MC else 1), 1
        ct, at = FB1_NC * nt, FB1_MC * mt
    else:
        mt = 1
        nt = 4 if m == 1 or cout > 2 * FB1_NC else 1 if cout <= FB1_NC else 2
        ct, at = FB1_MC * mt, FB1_NC * nt
    brick = (1 if m == 1 else 4 if k == 3 else 2, FB1_BH, FB1_BW)
    if m == 1:
        box = tuple(2 * n + 1 for n in brick)
        size = (_half(d), _half(h), _half(w))
    else:
        box = tuple(n + k - 1 for n in brick)
        size = (d, h, w)
    row = ct + 8 if ct % 16 == 0 else ct
    positions = brick[0] * brick[1] * brick[2]
    stage = box[0] * box[1] * box[2] * row + at * (positions + 4)
    # k = 1: the warps' sums, summed through shared memory at the end
    red = FB1_WARPS * mt * nt * 4 * 32 if k == 1 else 0
    smem = 4 * max(2 * stage, red)
    per_sm = 2 if k == 1 else 1
    # splits a sample: as many as one wave holds (a block more would take a
    # second wave), at least one
    tiles = _cdiv(cin, ct) * _cdiv(cout, at)
    wave = FB1_BLOCKS * per_sm // (tiles * b) * tiles * b
    dw = split_plan(b, cin, cout, size, k ** 3, brick, ct, at, wave, 1, INT31)
    if (smem > SMEM_MAX or dw.grid[1] > GRID_MAX or dw.grid[2] > GRID_MAX
            or dw.grid[0] >= INT31):
        raise ValueError(f"fb1_plan: {mode} cannot cut x [{b}, {cin}, {d}, {h}, "
                         f"{w}] and {cout} channels of g: {smem} bytes of shared "
                         f"memory, grid {dw.grid}")
    return FdwPlan(m, k, swap, mt, nt, 32 * FB1_WARPS, brick, box, row, ct, at, per_sm,
                   dw.bricks, dw.bps, dw.positions, dw.splits_per_sample,
                   dw.splits, dw.workspace, dw.grid, smem)


def dw_f32(plan: FdwPlan, x: torch.Tensor, g: torch.Tensor,
           per_sample: bool) -> torch.Tensor:
    """FB1 on validated f32 CUDA tensors, cut as `plan` says (counted as
    `s1_dw_f32` or `strided_dw_f32` by its map)."""
    b, cin, d, h, wd = x.shape
    cout = g.shape[1]
    k = plan.k
    ws = torch.empty(plan.workspace, dtype=torch.float32, device=x.device)
    out = torch.empty(((b,) if per_sample else ()) + (cout, cin, k, k, k),
                      dtype=torch.float32, device=x.device)
    family = _build.family(("s1_dw", "strided_dw")[plan.mode], torch.float32)
    _build.launch(family, "coma_conv3d_dw_f32_tc", x.device,
                  x.data_ptr(), g.data_ptr(), ws.data_ptr(), out.data_ptr(),
                  plan.mode, b, cin, cout, d, h, wd, k, int(per_sample),
                  int(plan.swap), plan.mt, plan.nt, *plan.brick, plan.bps)
    return out


def conv3d_s1_dw(x: torch.Tensor, g: torch.Tensor, k: int,
                 per_sample: bool) -> torch.Tensor:
    """Weight gradient of the stride-1 SAME conv, f32: [Cout, Cin, k, k, k],
    or [B, Cout, Cin, k, k, k] per sample, from x [B, Cin, ...] and the
    output cotangent g [B, Cout, ...]. A CUDA tensor launches KB1 (bf16,
    cut as `dw_plan` says) or FB1 (f32, cut as `fb1_plan` says; g of x's
    dtype) or raises; a CPU tensor takes the plain version."""
    if not device_check("conv3d_s1_dw", x):
        return conv3d_s1_dw_plain(x, g, k, per_sample)
    dtype = _build.kernel_dtype("x", x)
    _build.check_cuda_input("x", x, 5, x.device, dtype)
    _build.check_cuda_input("g", g, 5, x.device, dtype)
    b, cin, d, h, wd = x.shape
    cout = g.shape[1]
    if k not in (1, 3) or g.shape[0] != b or tuple(g.shape[2:]) != (d, h, wd):
        raise ValueError(f"conv3d_s1_dw: x {tuple(x.shape)} and g "
                         f"{tuple(g.shape)} do not fit a k={k} conv")
    if dtype == torch.float32:
        return dw_f32(fb1_plan("s1", b, cin, cout, d, h, wd, k), x, g,
                      per_sample)
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
    (bf16, cut as `s1_plan` says; KB1 and K1 in the backward) or F1 (f32,
    cut as `f1_plan` says; FB1 and F1 in the backward), x and w of one
    dtype, or raises; a CPU tensor takes the plain versions."""
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
