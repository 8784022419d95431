"""Data parallelism on `torch.distributed` (counterpart of the data-parallel
half of `coma_unet_tpu/parallel/mesh.py`).

The JAX mesh's `data` axis is a process group of N ranks here, one process
on one device each. Each rank runs the whole model on its rows of the
global batch, as a `shard_map` shard does:

  * the generative term is summed over the rank's valid rows;
  * the batch-coupled terms (RnC, or tCDS and the pred-space triplet) are
    computed on projections all-gathered over the ranks, so that they stay
    exact over the global batch and its `valid_mask`, and divided by N:
    every rank computes the same coupled value, the gather's backward sums
    the cotangent over the ranks, and the summed gradients then count the
    coupled term once;
  * the gradients are summed over the ranks (`psum`), not averaged, so
    the sum of the local objectives is the single-process loss on the
    concatenated batch and the summed gradients are its gradients;
  * batch norm's running statistics are averaged over the ranks (`pmean`),
    while the forward normalizes with each rank's local batch;
  * AdamW then runs on every rank with the same summed gradients, so the
    parameters stay replicated.

A collective on a bf16 or bool tensor travels as f32 or uint8; a gather is
an all-reduce of zero-padded rows, which the NCCL and the gloo backend both
run on CPU and CUDA tensors. Spatial parallelism (the JAX mesh's `spatial`
axis, `make_spatial_infer_fn`) is `parallel/spatial.py`, on the same group.
"""

from __future__ import annotations

import datetime
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, List, Sequence

import numpy as np
import torch
import torch.distributed as dist

from coma_unet_tpu_torch.config import LossConfig
from coma_unet_tpu_torch.data.pipeline import shard_rows
from coma_unet_tpu_torch.models.blocks import BatchNorm
from coma_unet_tpu_torch.train.optim import MultiSteps, Optimizer
from coma_unet_tpu_torch.train.state import TrainState
from coma_unet_tpu_torch.train.step import (
    _device_of,
    _step_of,
    make_eval_step,
    make_loss_fn,
)

# a collective that waits longer than this on a rank that died fails
TIMEOUT_S = 600.0
# the largest flat tensor one all-reduce or broadcast carries
BUCKET_BYTES = 64 << 20


@dataclass(frozen=True)
class Mesh:
    """This process's place in the data-parallel group: its rank, the
    group's size and the device its model lives on."""

    rank: int
    size: int
    device: torch.device

    def rows(self, n: int) -> slice:
        """This rank's rows of a global batch of `n`."""
        return shard_rows(n, self.rank, self.size)


def make_mesh(rank: int, world: int, device, init_method: str) -> Mesh:
    """Join (the first call creates) the group of `world` ranks at
    `init_method` (`file://...` or `tcp://host:port`) as `rank`, on
    `device`: `cuda:<r>` on the cards, `cpu` on the host. The backend is
    NCCL where every rank has a card of its own, else gloo (on the CPU, or
    where the ranks outnumber the visible cards and share them). A
    collective that waits `TIMEOUT_S` fails."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    own_card = device.type == "cuda" and world <= torch.cuda.device_count()
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialized")
    dist.init_process_group("nccl" if own_card else "gloo",
                            init_method=init_method, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    return Mesh(rank=rank, size=world, device=device)


def destroy_mesh() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


# --- collectives on lists of tensors, bucketed into flat ones ------------------

def _wire_dtype(dtype: torch.dtype) -> torch.dtype:
    if dtype in (torch.bfloat16, torch.float16):
        return torch.float32
    return torch.uint8 if dtype == torch.bool else dtype


def _buckets(tensors: Sequence[torch.Tensor]) -> Iterable[List[torch.Tensor]]:
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        bucket: List[torch.Tensor] = []
        nbytes = 0
        for t in group:
            size = t.numel() * t.element_size()
            if bucket and nbytes + size > BUCKET_BYTES:
                yield bucket
                bucket, nbytes = [], 0
            bucket.append(t)
            nbytes += size
        if bucket:
            yield bucket


def _flat_collective(tensors: Sequence[torch.Tensor], mesh: Mesh,
                     op: Callable[[torch.Tensor], Any]) -> None:
    """Run `op` in place on the tensors, a few flat buckets at a time, and
    copy the results back into them (on whatever device each lives)."""
    for bucket in _buckets(tensors):
        wire = _wire_dtype(bucket[0].dtype)
        flat = torch.cat([t.detach().reshape(-1).to(mesh.device, wire)
                          for t in bucket])
        op(flat)
        offset = 0
        for t in bucket:
            n = t.numel()
            t.detach().copy_(flat[offset:offset + n].view(t.shape))
            offset += n


def all_reduce_(tensors: Sequence[torch.Tensor], mesh: Mesh,
                op=dist.ReduceOp.SUM) -> None:
    """Sum (or `op`) each tensor over the ranks, in place."""
    _flat_collective(tensors, mesh, lambda flat: dist.all_reduce(flat, op=op))


def broadcast_(tensors: Sequence[torch.Tensor], mesh: Mesh,
               src: int = 0) -> None:
    """Overwrite each tensor with rank `src`'s, in place."""
    _flat_collective(tensors, mesh, lambda flat: dist.broadcast(flat, src))


def gather_all(tensors: Sequence[torch.Tensor],
               mesh: Mesh) -> List[torch.Tensor]:
    """`jax.lax.all_gather(..., tiled=True)` of each tensor along its first
    axis: every rank gets the rows of every rank, in rank order. No
    gradient."""
    outs = []
    for t in tensors:
        b = t.shape[0]
        buf = torch.zeros((b * mesh.size,) + tuple(t.shape[1:]), dtype=t.dtype,
                          device=t.device)
        buf[mesh.rows(b * mesh.size)] = t.detach()
        outs.append(buf)
    all_reduce_(outs, mesh)
    return outs


class _GatherRows(torch.autograd.Function):
    """The all-gather with JAX's transpose: the backward sums the cotangent
    over the ranks and keeps this rank's rows."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
        ctx.mesh = mesh
        return gather_all([x], mesh)[0]

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        mesh = ctx.mesh
        grad = grad.contiguous().clone()
        all_reduce_([grad], mesh)
        return grad[mesh.rows(grad.shape[0])], None


def gather_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """All-gather `x` along its first axis, differentiably."""
    return _GatherRows.apply(x, mesh)


def gather_objects(obj: Any, mesh: Mesh) -> List[Any]:
    """Every rank's `obj` (picklable), in rank order."""
    out: List[Any] = [None] * mesh.size
    dist.all_gather_object(out, obj)
    return out


def check_same(values: torch.Tensor, mesh: Mesh, what: str) -> None:
    """Raise unless `values` is identical on every rank (one all-reduce of
    the values beside their negations under MAX)."""
    v = values.detach().reshape(-1).to(mesh.device, torch.float64)
    both = torch.cat([v, -v])
    dist.all_reduce(both, op=dist.ReduceOp.MAX)
    hi, lo = both[: v.numel()], -both[v.numel():]
    if not torch.equal(hi, lo):
        raise RuntimeError(f"the ranks disagree on {what}: "
                           f"max {hi.tolist()}, min {lo.tolist()}")


# --- the batch and the state ---------------------------------------------------

def shard_batch(batch: Dict[str, Any], mesh: Mesh) -> Dict[str, Any]:
    """This rank's rows of a global batch: every array, tensor and list
    entry (`valid_mask`, `pos_*`/`neg_*`, `sample_ids` included) sliced to
    rows [r*b/N, (r+1)*b/N); anything else as it is."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, (np.ndarray, torch.Tensor, list, tuple)) and len(v):
            v = v[mesh.rows(len(v))]
        out[k] = v
    return out


def _optimizer_tensors(optimizer: Optimizer) -> List[torch.Tensor]:
    inner = optimizer.inner if isinstance(optimizer, MultiSteps) else optimizer
    tensors = []
    for group in inner.param_groups:
        for p in group["params"]:
            state = inner.state.get(p, {})
            tensors += [state[k] for k in sorted(state)
                        if isinstance(state[k], torch.Tensor)]
            if isinstance(optimizer, MultiSteps) and p in optimizer._acc:
                tensors.append(optimizer._acc[p])
    return tensors


def replicate_state(state: TrainState, mesh: Mesh) -> TrainState:
    """Broadcast the model's parameters and buffers and the optimizer's
    state from rank 0, so that a run seeded alike or resumed from one
    checkpoint starts identical on every rank. The optimizer state must
    have the same layout on every rank (none yet, or one checkpoint's)."""
    opt = _optimizer_tensors(state.optimizer)
    mini = (state.optimizer.mini_step
            if isinstance(state.optimizer, MultiSteps) else 0)
    check_same(torch.tensor([len(opt), sum(t.numel() for t in opt), mini],
                            dtype=torch.float64), mesh, "the optimizer state's layout")
    with torch.no_grad():
        broadcast_(list(state.model.state_dict().values()) + opt, mesh)
    return state


def average_batch_stats_(model: torch.nn.Module, mesh: Mesh) -> None:
    """Batch norm's running `mean` and `var` averaged over the ranks
    (`jax.lax.pmean` of `batch_stats`)."""
    stats = [t for m in model.modules() if isinstance(m, BatchNorm)
             for t in (m.mean, m.var)]
    if stats:
        all_reduce_(stats, mesh)
        for t in stats:
            t.div_(mesh.size)


# --- the steps -----------------------------------------------------------------

def make_sharded_train_step(model: torch.nn.Module, loss_config: LossConfig,
                            optimizer: Optimizer, mesh: Mesh,
                            seed: int = 0) -> Callable:
    """step(batch, roi_weights, voxel_weights=None) -> metrics on this
    rank's rows of the global batch: the single-process `make_train_step`
    on the concatenated batch. The metrics are global and the same on every
    rank: `loss` (the sum of the local objectives), `gen_loss` ([B_total]),
    `tcds_loss` and `pred_space_loss` (the coupled terms, weighted),
    `grad_norm` (of the summed gradients) and the gathered `valid_mask` and
    `abeta` ([B_total]; -1 where the batch has no abeta) for the loop's
    booking. Dropout sites are seeded from (`seed`, the step count) on every
    rank alike, as `shard_map` hands every shard the same key."""
    n = mesh.size
    device = _device_of(model)
    loss_fn = make_loss_fn(model, loss_config,
                           gather=lambda x: gather_rows(x, mesh), world=n)

    def reduce(grads, batch, metrics):
        all_reduce_(grads, mesh)
        average_batch_stats_(model, mesh)
        # every metric in one all-reduce: the three sums, then gen_loss,
        # valid_mask and abeta of every rank's rows in zero-padded slots
        b = batch["mri"].shape[0]
        valid = batch.get("valid_mask")
        valid = torch.ones(b, device=device) if valid is None else valid
        abeta = batch.get("abeta")
        abeta = (torch.full((b,), -1.0, device=device) if abeta is None
                 else abeta.reshape(-1).float())
        rows, total = mesh.rows(b * n), b * n
        packed = torch.zeros(3 + 3 * total, dtype=torch.float32, device=device)
        packed[:3] = torch.stack([metrics[k].float() for k in (
            "loss", "tcds_loss", "pred_space_loss")])
        for i, v in enumerate((metrics["gen_loss"], valid.reshape(-1), abeta)):
            packed[3 + i * total:][rows] = v.float()
        all_reduce_([packed], mesh)
        return {"loss": packed[0], "tcds_loss": packed[1],
                "pred_space_loss": packed[2],
                "gen_loss": packed[3:3 + total],
                "valid_mask": packed[3 + total:3 + 2 * total],
                "abeta": packed[3 + 2 * total:]}

    return _step_of(model, optimizer, seed, loss_fn, reduce)


def make_sharded_eval_step(model: torch.nn.Module, num_rois: int,
                           mesh: Mesh) -> Callable:
    """eval_step(batch) -> (pred, vox, roi) over the global batch: each
    rank runs `make_eval_step` on its rows, then `pred` and every
    per-sample voxel and ROI metric are all-gathered, so every rank holds
    the whole batch's."""
    local = make_eval_step(model, num_rois)

    def eval_step(batch):
        pred, vox, roi = local(batch)
        with torch.no_grad():
            got = gather_all([pred, *vox.values(), *roi.values()], mesh)
        pred, rest = got[0], got[1:]
        return (pred, dict(zip(vox, rest[:len(vox)])),
                dict(zip(roi, rest[len(vox):])))

    return eval_step
