"""The rank side of `tests/test_torch_port_parallel.py`: two gloo ranks on
the CPU run the port's data-parallel steps on the inputs the test wrote
and save what each rank saw. This file imports no JAX.

    python tests/torch_port_dp_worker.py INPUTS.pt OUT_DIR

INPUTS.pt holds the flagship's and AttnUNET's state dicts, the loss
configs' fields, the global batches (numpy) and the ROI weights. Each rank
writes OUT_DIR/rank<r>.pt with, per case:
  rnc      one RnC step: the metrics and the summed gradients;
  local    the same step with a gather whose backward keeps only this rank's
           cotangent (no cross-rank sum): the fault the tests must catch;
  tcds     one tCDS step (`reg_weight` 1, `valid_mask` with unequal valid
           counts per rank): the metrics and the gradients;
  bn       one step of AttnUNET with batch norm: the running statistics;
  eval     the sharded eval step (before any step): pred and the voxel and
           ROI metrics;
  adamw    the parameters after a second AdamW step of the RnC run;
and rank 0 also, once the group is gone, as the single-process reference:
  single   the port's `make_train_step` on the global batches: the RnC
           step's metrics and gradients on each of the two batches and the
           parameters after both, and the tCDS step's metrics and
           gradients.
"""

from __future__ import annotations

import os
import sys

import torch
import torch.multiprocessing as mp

WORLD = 2


def _grads(model):
    return {n: (p.grad.clone() if p.grad is not None else None)
            for n, p in model.named_parameters()}


def _metrics(m):
    return {k: v.detach().clone() for k, v in m.items()}


class _LocalOnlyGather(torch.autograd.Function):
    """An all-gather whose backward keeps only this rank's rows of the
    cotangent, without summing it over the ranks."""

    @staticmethod
    def forward(ctx, x, mesh):
        from coma_unet_tpu_torch.parallel.mesh import gather_all

        ctx.mesh = mesh
        return gather_all([x], mesh)[0]

    @staticmethod
    def backward(ctx, grad):
        return grad[ctx.mesh.rows(grad.shape[0])].clone(), None


def _rank(rank: int, inputs_path: str, out_dir: str, init_method: str) -> None:
    from coma_unet_tpu_torch import ContraAttnUNet, LossConfig, ModelConfig
    from coma_unet_tpu_torch.models.registry import build_model
    from coma_unet_tpu_torch.parallel import mesh as pmesh
    from coma_unet_tpu_torch.train import make_optimizer, make_train_step

    torch.set_num_threads(2)
    inputs = torch.load(inputs_path, weights_only=False)
    mesh = pmesh.make_mesh(rank, WORLD, "cpu", init_method)
    roi_w = torch.from_numpy(inputs["roi_w"])
    cfg = ModelConfig(**inputs["model"])

    def flagship():
        model = ContraAttnUNet(cfg, device="cpu")
        model.load_state_dict(inputs["flagship"])
        return model

    def step_of(model, loss_config):
        opt = make_optimizer(model.parameters(), 1e-3)
        return pmesh.make_sharded_train_step(model, loss_config, opt, mesh)

    def local(batch):
        return pmesh.shard_batch({k: torch.from_numpy(v) for k, v in batch.items()},
                                 mesh)

    out = {}
    try:
        model = flagship()
        out["eval"] = pmesh.make_sharded_eval_step(model, inputs["num_rois"], mesh)(
            local({k: v for k, v in inputs["batch"].items()
                   if k != "valid_mask"}))
        step = step_of(model, LossConfig())
        out["rnc"] = dict(metrics=_metrics(step(local(inputs["batch"]), roi_w)),
                          grads=_grads(model))
        step(local(inputs["batch2"]), roi_w)
        out["adamw"] = {n: p.detach().clone() for n, p in model.named_parameters()}

        model = flagship()
        good = pmesh.gather_rows
        pmesh.gather_rows = lambda x, m: _LocalOnlyGather.apply(x, m)
        try:
            step_of(model, LossConfig())(local(inputs["batch"]), roi_w)
        finally:
            pmesh.gather_rows = good
        out["local"] = dict(grads=_grads(model))

        model = flagship()
        step = step_of(model, LossConfig(**inputs["tcds_loss"]))
        out["tcds"] = dict(metrics=_metrics(step(local(inputs["tcds_batch"]), roi_w)),
                           grads=_grads(model))

        bn = build_model("AttnUNET", ModelConfig(**inputs["bn_model"]),
                         device="cpu")
        bn.load_state_dict(inputs["bn"])
        metrics = step_of(bn, LossConfig())(local(inputs["bn_batch"]), roi_w)
        out["bn"] = dict(metrics=_metrics(metrics),
                         stats={k: v.clone() for k, v in bn.state_dict().items()
                                if k.endswith((".mean", ".var"))})
    finally:
        pmesh.destroy_mesh()
    if rank == 0:
        out["single"] = _single(flagship, inputs, roi_w, make_train_step,
                                make_optimizer, LossConfig)
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))


def _single(flagship, inputs, roi_w, make_train_step, make_optimizer,
            LossConfig):
    """The single-process port's steps on the whole global batches."""
    def run(batches, loss_config):
        model = flagship()
        step = make_train_step(model, loss_config,
                               make_optimizer(model.parameters(), 1e-3))
        seen = []
        for batch in batches:
            metrics = step({k: torch.from_numpy(v) for k, v in batch.items()},
                           roi_w)
            seen.append(dict(metrics=_metrics(metrics),
                             grads={n: g for n, g in _grads(model).items()
                                    if g is not None}))
        return model, seen

    model, rnc = run((inputs["batch"], inputs["batch2"]), LossConfig())
    _, tcds = run((inputs["tcds_batch"],), LossConfig(**inputs["tcds_loss"]))
    return dict(rnc=rnc, tcds=tcds[0],
                params={n: p.detach().clone() for n, p in model.named_parameters()})


def main(inputs_path: str, out_dir: str) -> None:
    init_method = "file://" + os.path.join(out_dir, "store")
    # this process has imported torch and run nothing: the ranks fork from
    # it without importing torch again
    mp.start_processes(_rank, args=(inputs_path, out_dir, init_method),
                       nprocs=WORLD, join=True, start_method="fork")


if __name__ == "__main__":
    main(*sys.argv[1:3])
