"""The readings that the limits of `correct` are set from, for one cell, on
many seeds in one process (the benchmark's own runs never run this):

    python3 -m perfbench.calibrate --workload <cell> --seeds 1,2,3 [--control 1]

For each seed: the program's readings, taken as a run takes them (the
generator's set-up, which drives the timed path's first steps, then the
check), and with `--control 1` the control's: the reference computed in
float8 (`reference/control.py`) put in the program's place. `--fault
half_batch` plants a fault in the program's loss first (`half_batch_loss`).
Each reading also names the leaf it was worst at. One JSON line a seed on
standard output.
"""

from __future__ import annotations

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
from typing import Optional  # noqa: E402

import torch  # noqa: E402

from perfbench import harness  # noqa: E402
from perfbench.reference import compare  # noqa: E402
from perfbench.reference.control import FLOAT8  # noqa: E402


def worst(prog: dict, ref: dict) -> dict:
    """The leaf each leaf gap is worst at, with its gap."""
    moved = compare.moved_leaves(ref["grad"])
    out = {}
    for key in ("grad", "change"):
        gaps = compare.leaf_gaps(prog[key], ref[key], moved)
        name = max(gaps, key=gaps.get)
        out[key] = [name, gaps[name]]
    return out


def train_seed(ctx, generator, control: bool) -> dict:
    state = generator.setup(ctx)
    prog = state["prog"]
    generator.free_program(ctx, state, list(state))
    ref = generator.reference_side(ctx)
    out = {"program": compare.train_readings(prog, ref),
           "program_worst": worst(prog, ref),
           "ref_losses": ref["losses"], "program_losses": prog["losses"],
           "leaves": len(ref["grad"]),
           "moved_leaves": len(compare.moved_leaves(ref["grad"]))}
    if control:
        low = generator.reference_side(ctx, FLOAT8)
        out["control"] = compare.train_readings(low, ref)
        out["control_worst"] = worst(low, ref)
        out["control_losses"] = low["losses"]
    return out


def infer_seed(ctx, generator, control: bool) -> dict:
    state = generator.setup(ctx)
    pool_size = len(state["pool"])
    answers = [(i, generator.request(state, i)) for i in range(pool_size)]
    generator.free_program(ctx, state, list(state))
    want = generator.reference_outs(ctx, range(pool_size))
    out = {"program": {"out_gap": max(compare.rel_l2(torch.from_numpy(a), want[i])
                                      for i, a in answers)}}
    if control:
        low = generator.reference_outs(ctx, range(pool_size), FLOAT8)
        out["control"] = {"out_gap": max(compare.rel_l2(low[i], want[i])
                                         for i in range(pool_size))}
    return out


def half_batch_loss(generative):
    """A planted fault for `GenerativeContrastiveLoss.generative`: the
    forward keeps the whole batch, and the loss leaves out the batch's
    second half, the mean taken over the rest (at b = 2, the first row's
    loss in place of the sum over both)."""

    def half(self, pred, target, roi_compact, roi_weights, **kwargs):
        gen, _ = generative(self, pred, target, roi_compact, roi_weights,
                            **kwargs)
        rows = max(gen.shape[0] // 2, 1)
        return gen, self.config.gen_weight * gen[:rows].mean()

    return half


def half_batch():
    """Plant `half_batch_loss` under the timed step."""
    from coma_unet_tpu_torch.losses.composite import GenerativeContrastiveLoss

    GenerativeContrastiveLoss.generative = half_batch_loss(
        GenerativeContrastiveLoss.generative)


def calibrate(name: str, seeds, control: bool, device: torch.device,
              overrides: Optional[dict] = None):
    cell = harness.Cell.load(name, overrides=overrides)
    generator = harness.load_module(harness.ROOT / "traffic"
                                 / f"{cell.traffic['generator']}.py")
    for seed in seeds:
        ctx = harness.Context(cell, int(seed), device, time.perf_counter())
        t0 = time.perf_counter()
        fn = train_seed if cell.traffic["generator"] == "train_step" else infer_seed
        out = fn(ctx, generator, control)
        out.update(seed=int(seed), seconds=time.perf_counter() - t0)
        yield out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--control", type=int, default=1)
    parser.add_argument("--fault", choices=("half_batch",),
                        help="plant a fault in the program first")
    args = parser.parse_args(argv)
    if args.fault == "half_batch":
        half_batch()
    device = torch.device("cuda", 0)
    seeds = [int(s) for s in args.seeds.split(",")]
    for out in calibrate(args.workload, seeds, bool(args.control), device):
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
