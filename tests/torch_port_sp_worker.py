"""The rank side of `tests/test_torch_port_spatial.py`: gloo ranks on the
CPU run the port's depth-sharded forward on the inputs the test wrote and
save what each rank saw. This file imports no JAX.

    python tests/torch_port_sp_worker.py INPUTS.pt OUT_DIR

INPUTS.pt holds the cases: each a name, a rank count, a model config and
state dict, the inputs (numpy), the planted faults to run and, for the
misaligned fault, the plan's starts. For each case, its ranks fork from
this process and each writes OUT_DIR/<name>_rank<r>.pt with, per run:
  sound      `make_spatial_infer_fn`'s result (rank 0: the whole `out`),
             every (mean, rstd) the rank's norms merged, in call order, and
             the plain versions it ran (counted from 0);
  zero_halo  the same forward with every halo read as zeros: a fault the
             tests must catch;
  unmerged   the same forward with each rank's own statistics left
             unmerged: a fault the tests must catch;
  misaligned the same forward on a plan whose boundaries lie off their
             multiples of 2^L, with the guard that refuses the odd slabs
             this gives a rank other than the last lifted: a fault the
             tests must catch.
"""

from __future__ import annotations

import os
import sys

import torch
import torch.multiprocessing as mp


def _rank(rank: int, case: dict, out_dir: str, init_method: str) -> None:
    from coma_unet_tpu_torch import ContraAttnUNet, ModelConfig, ops
    from coma_unet_tpu_torch.parallel import mesh as pmesh
    from coma_unet_tpu_torch.parallel import spatial

    torch.set_num_threads(1)
    model = ContraAttnUNet(ModelConfig(**case["model"]), device="cpu")
    model.load_state_dict(case["state"])
    args = case["args"]
    mesh = pmesh.make_mesh(rank, case["world"], "cpu", init_method)
    good_merge, good_halo = spatial.Slab.merge, spatial.Slab.halo
    good_plan, good_crop = spatial.plan_slabs, spatial.Slab.check_crop
    out = {}
    try:
        infer = spatial.make_spatial_infer_fn(model, mesh)
        seen = []

        def recording(self, partials):
            merged = good_merge(self, partials)
            seen.append(spatial.mean_rstd(merged))
            return merged

        spatial.Slab.merge = recording
        ops.reset_counts()
        out["sound"] = dict(out=infer(*args), stats=seen,
                            plain=dict(ops.PLAIN_ON_CPU))
        spatial.Slab.merge = good_merge
        if "zero_halo" in case["faults"]:
            def zeros(self, x, below, above):
                lower, upper = good_halo(self, x, below, above)
                return torch.zeros_like(lower), torch.zeros_like(upper)

            spatial.Slab.halo = zeros
            out["zero_halo"] = dict(out=infer(*args))
            spatial.Slab.halo = good_halo
        if "unmerged" in case["faults"]:
            spatial.Slab.merge = lambda self, partials: partials
            out["unmerged"] = dict(out=infer(*args))
            spatial.Slab.merge = good_merge
        if "misaligned" in case["faults"]:
            spatial.plan_slabs = lambda *a: spatial.SlabPlan(
                good_plan(*a).sizes, case["misaligned"], good_plan(*a).factors)
            spatial.Slab.check_crop = lambda self, have, want: None
            out["misaligned"] = dict(out=infer(*args))
    finally:
        spatial.Slab.merge, spatial.Slab.halo = good_merge, good_halo
        spatial.plan_slabs, spatial.Slab.check_crop = good_plan, good_crop
        pmesh.destroy_mesh()
    torch.save(out, os.path.join(out_dir, f"{case['name']}_rank{rank}.pt"))


def main(inputs_path: str, out_dir: str) -> None:
    # this process has imported torch and run nothing: the ranks fork from
    # it without importing torch again
    for case in torch.load(inputs_path, weights_only=False):
        init_method = "file://" + os.path.join(out_dir, f"store_{case['name']}")
        mp.start_processes(_rank, args=(case, out_dir, init_method),
                           nprocs=case["world"], join=True, start_method="fork")


if __name__ == "__main__":
    main(*sys.argv[1:3])
