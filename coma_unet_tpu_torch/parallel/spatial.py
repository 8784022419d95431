"""Spatial parallelism on `torch.distributed` (counterpart of the spatial
half of `coma_unet_tpu/parallel/mesh.py`: `make_mesh`'s `spatial` axis,
`shard_batch(..., spatial=True)` and `make_spatial_infer_fn`).

One volume is synthesized by N ranks, one process a device, each holding a
depth slab of the volume and of every activation. Level i of the U-Net
holds D_i planes, D_{i+1} = ceil(D_i / 2) (a k = 3 stride-2 conv with
padding 1), so 216 planes give 216, 108, 54, 27, 14. Rank r's first plane
at level 0, b_r, is the multiple of 2^L nearest r D / N (L the number of
depth strides), and at level i it is b_r / 2^i; the last rank takes the
tail (`plan_slabs`). Every slab but the last is then even at each level a
stride-2 conv reads, and every stride-2 window starts on an even global
plane; the last rank's slab may be odd, and its upsample then gives one
plane more than its skip, which the decoder crops (`Slab.check_crop`).
All N ranks of the group are depth slabs: the JAX spec splits D over the
mesh's `data` axis and H over its `spatial` axis, which gives the same
numbers (`ROADMAP.md` §3). The model runs unchanged inside `depth_sharded`
(`models/blocks.py`), which hands every conv and instance norm of the
blocks the rank's `Slab`:

  * a conv whose taps reach across the slab's ends runs on the slab with
    its own SAME zero padding, then recomputes its outermost output planes
    from small windows that hold the neighbours' planes (`Slab.conv`):
    k = 3 stride 1 reads one plane below and one above, the stride-2 conv
    one below (its window starts on an even global plane, so it lines up
    with the unsharded grid), the transposed conv one above. The first and
    last ranks' outer neighbours are zeros, which is SAME's padding;
  * the neighbours' planes come from one all-reduce of zero-padded
    per-rank slots (`Slab.halo`), which gloo runs on CPU and CUDA tensors
    and NCCL on CUDA ones (gloo has no CUDA send or all_gather); a halo is
    never wider than a slab;
  * an instance norm takes each row's (count, mean, M2) of the slab in f64
    (K4's `norm_stats` where the block runs the kernels, plain ops
    otherwise), gathers the ranks' partials the same way, and merges them
    in rank order (`Slab.merge`), so every rank holds bit-identical mean
    and rstd whatever the slabs' counts; the apply is K4's `norm_apply` or
    plain ops.

The slab plan refuses only a volume whose deepest level holds too few
planes to give every rank one (the JAX package pads there instead).
Inference only, as in the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import torch
import torch.distributed as dist

from coma_unet_tpu_torch.models.blocks import depth_sharded
from coma_unet_tpu_torch.models.contra import ContraAttnUNet
from coma_unet_tpu_torch.ops.norm_act import (
    mean_rstd,
    merge_partials,
    norm_stats,
    row_partials,
)
from coma_unet_tpu_torch.parallel.mesh import Mesh, all_reduce_


@dataclass(frozen=True)
class SlabPlan:
    """The volume's depth at each level (`sizes[0]` the input's), each
    rank's first plane at level 0 (`starts`, from 0 up) and the factor by
    which each level is smaller along depth (`factors`, 1 at level 0)."""

    sizes: Tuple[int, ...]
    starts: Tuple[int, ...]
    factors: Tuple[int, ...]

    @property
    def world(self) -> int:
        return len(self.starts)

    def planes(self, rank: int, level: int = 0) -> slice:
        """Rank `rank`'s global planes at `level`: from its level-0 start
        over the level's factor up to the next rank's, the last rank to
        the level's end."""
        f = self.factors[level]
        hi = (self.starts[rank + 1] // f if rank + 1 < self.world
              else self.sizes[level])
        return slice(self.starts[rank] // f, hi)


def plan_slabs(depth: int, strides, world: int) -> SlabPlan:
    """The slabs of a volume of `depth` planes over `world` ranks for a
    U-Net whose levels are `strides` apart along depth (a stride is an int
    or a (d, h, w) triple; level i + 1 holds ceil(D_i / s) planes). Each
    rank starts at the multiple of the deepest level's factor nearest
    r depth / world (ties up). Raises ValueError naming the deepest level
    where it would leave some rank no plane."""
    sizes, factors = [int(depth)], [1]
    for s in strides:
        s = s if isinstance(s, int) else s[0]
        sizes.append(-(-sizes[-1] // s))
        factors.append(factors[-1] * s)
    f, level = factors[-1], len(sizes) - 1
    starts = tuple(f * ((2 * r * depth + world * f) // (2 * world * f))
                   for r in range(world))
    plan = SlabPlan(tuple(sizes), starts, tuple(factors))
    if any(plan.planes(r, level).stop <= plan.planes(r, level).start
           for r in range(world)):
        raise ValueError(
            f"level {level} holds {sizes[level]} planes, too few for {world} "
            f"ranks to hold one each (a volume of depth {depth})")
    return plan


def level_strides(config) -> tuple:
    """The strides between the levels of the U-Net of a `ModelConfig`."""
    return tuple(config.strides[:len(config.channels) - 1])


class Slab:
    """This rank's place in a depth-sharded forward: what `depth_sharded`
    hands the blocks."""

    def __init__(self, mesh: Mesh, plan: SlabPlan):
        if plan.world != mesh.size:
            raise ValueError(f"a plan for {plan.world} ranks on a group of "
                             f"{mesh.size}")
        self.mesh, self.plan = mesh, plan
        self.rank, self.world = mesh.rank, mesh.size
        self.last = self.rank == self.world - 1

    def local(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's planes (axis 2) of a tensor of the volume's depth."""
        return t[:, :, self.plan.planes(self.rank)]

    def check_crop(self, have: int, want: int) -> None:
        """An upsample of `have` planes cut to its skip's `want`: only the
        last rank's odd slab gives one plane more; anywhere else the slabs
        are misaligned, and this raises."""
        if not self.last or have != want + 1:
            raise RuntimeError(
                f"rank {self.rank} of {self.world}: an upsample of {have} "
                f"planes meets a skip of {want}; only the last rank's odd "
                f"slab is cut, by one plane")

    def halo(self, x: torch.Tensor, below: int, above: int):
        """(the `below` planes under this rank's slab of x, the `above`
        planes over it), each [B, C, n, H, W] and zeros past the volume's
        ends: one all-reduce of per-rank slots, rank r's holding its first
        `above` and its last `below` planes."""
        depth = x.shape[2]
        if max(below, above) > depth:
            raise ValueError(f"a halo of {max(below, above)} planes is wider "
                             f"than a slab of {depth}")
        shape = x.shape[:2] + (below + above,) + x.shape[3:]
        slots = torch.zeros((self.world,) + shape, dtype=x.dtype, device=x.device)
        slots[self.rank] = torch.cat([x[:, :, :above], x[:, :, depth - below:]], 2)
        all_reduce_([slots], self.mesh)
        zeros = slots.new_zeros(shape)
        lower = slots[self.rank - 1] if self.rank > 0 else zeros
        upper = slots[self.rank + 1] if self.rank + 1 < self.world else zeros
        return lower[:, :, above:], upper[:, :, :above]

    def merge(self, partials: torch.Tensor) -> torch.Tensor:
        """Each row's (count, mean, M2) [rows, 3] f64 over the whole
        volume, from this rank's partials of its slab: the ranks' partials,
        each with its own slab's count, gathered in zero-padded slots and
        merged in rank order."""
        slots = torch.zeros((self.world,) + tuple(partials.shape),
                            dtype=torch.float64, device=partials.device)
        slots[self.rank] = partials
        all_reduce_([slots], self.mesh)
        return merge_partials(slots)

    def mean_rstd(self, x: torch.Tensor, kernels: bool,
                  eps: float = 1e-5) -> torch.Tensor:
        """[B * C, 2] f32 (mean, rstd) of x's rows over the whole volume:
        the slab's partials from K4's `norm_stats` where `kernels`, else
        plain ops, merged over the ranks."""
        partials = norm_stats(x) if kernels else row_partials(x)
        return mean_rstd(self.merge(partials), eps)

    def conv(self, x: torch.Tensor, run: Callable[[torch.Tensor], torch.Tensor],
             k: int, stride: int, transposed: bool) -> torch.Tensor:
        """`run` (a SAME conv, k = 1 or 3; stride 2 k = 3; or the
        transposed stride-2 k = 3 conv) on this rank's slab x: its output
        slab of the unsharded conv's output. The outermost output planes
        that read past the slab are recomputed from windows that hold the
        neighbours' planes, and written into the output in place."""
        y = run(x)
        if k == 1 and stride == 1 and not transposed:
            return y
        if k != 3 or stride not in (1, 2) or (transposed and stride != 2):
            raise ValueError(f"no depth-sharded form of the conv with k={k}, "
                             f"stride {stride}, transposed={transposed}")
        depth = x.shape[2]
        first, last = self.rank == 0, self.rank == self.world - 1
        if transposed:  # fine plane 2(c + depth) - 1 reads coarse c + depth
            _, upper = self.halo(x, 0, 1)
            if not last:
                y[:, :, -1:] = run(torch.cat([x[:, :, -1:], upper], 2))[:, :, 1:2]
        elif stride == 2:  # output a/2 reads planes a - 1 .. a + 1
            lower, _ = self.halo(x, 1, 0)
            if not first:
                window = torch.cat([torch.zeros_like(lower), lower, x[:, :, :2]], 2)
                y[:, :, :1] = run(window)[:, :, 1:2]
        else:
            lower, upper = self.halo(x, 1, 1)
            if depth == 1:
                if not (first and last):
                    y[:] = run(torch.cat([lower, x, upper], 2))[:, :, 1:2]
                return y
            if not first:
                y[:, :, :1] = run(torch.cat([lower, x[:, :, :2]], 2))[:, :, 1:2]
            if not last:
                y[:, :, -1:] = run(torch.cat([x[:, :, -2:], upper], 2))[:, :, 1:2]
        return y


def gather_depth(out: torch.Tensor, mesh: Mesh) -> Optional[torch.Tensor]:
    """The ranks' slabs of `out`, of any depths, concatenated along depth in
    rank order on rank 0 (on its device), None on the other ranks: each
    slab travels to rank 0 alone."""
    slabs = [None] * mesh.size if mesh.rank == 0 else None
    dist.gather_object(out.cpu(), slabs, dst=0)
    if mesh.rank != 0:
        return None
    return torch.cat(slabs, 2).to(out.device)


def make_spatial_infer_fn(model: torch.nn.Module, mesh: Mesh) -> Callable:
    """infer(mri, covars, roi_loc, roi_std, roi_compact) -> out, the
    signature of `infer.make_infer_fn`, run by every rank of `mesh` on the
    same full-size inputs (numpy arrays or tensors): each rank moves its
    depth slab of `mri` [B, 1, D, H, W] and `roi_compact` [B, D, H, W] to
    its device and runs the forward on it with `with_projections=False`,
    under `torch.no_grad()`. Rank 0 returns the whole `out` [B, 1, D, H, W]
    f32 on its device, the other ranks None. Only ContraAttnUNet runs: the
    reference's `make_spatial_infer_fn` passes `with_projections=False`,
    which no baseline takes. A depth the slab plan refuses raises
    ValueError on every rank before any collective."""
    if not isinstance(model, ContraAttnUNet):
        raise ValueError(f"spatial inference runs ContraAttnUNet only, not "
                         f"{type(model).__name__}")
    device = next(model.parameters()).device
    levels = level_strides(model.config)

    @torch.no_grad()
    def infer(mri, covars, roi_loc, roi_std, roi_compact):
        mri, roi_compact = torch.as_tensor(mri), torch.as_tensor(roi_compact)
        plan = plan_slabs(mri.shape[2], levels, mesh.size)
        planes = plan.planes(mesh.rank)
        args = [t.to(device) for t in (
            mri[:, :, planes], torch.as_tensor(covars), torch.as_tensor(roi_loc),
            torch.as_tensor(roi_std), roi_compact[:, planes])]
        with depth_sharded(Slab(mesh, plan)):
            out = model(*args, with_projections=False).out
        return gather_depth(out, mesh)

    return infer
