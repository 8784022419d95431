"""The comparison that decides `correct`.

Training: the program's first three steps against the reference's from the
same weights and batches, the numbers the cell's limits name:
  * `out_gap`: the first forward's output, the largest relative L2
    distance of a sample from the reference's;
  * `loss1_gap`: |loss - ref| / |ref| of the first step (`loss_gap`, the
    largest over the three steps, is reported beside it: Adam's first
    update moves every weight by about lr times the sign of its gradient,
    so weights whose gradient is near nought part by the sign of rounding,
    and the later losses part by percents on both sides alike);
  * `grad_gap`: over the leaves, the largest gap between the norm of the
    program's first gradient (as its AdamW state holds it after one step)
    and the reference's, over the larger of that leaf's reference norm and
    the median leaf's;
  * `change_gap`: the same of each leaf's change over the three steps.
Leaves whose reference gradient is under a thousandth of the median leaf's
(a bias before an instance norm, a prompt no row selected) have a
gradient of round-off alone, and move by it under Adam: both leaf gaps
leave them out.
Synthesis: `out_gap`, the largest relative L2 distance of a returned
volume's sample from the reference's forward of the same inputs.

Each number is held to the cell's limit (`workloads/<cell>.json`).
"""

from __future__ import annotations

import statistics
from typing import Dict, Iterable, List, Optional

import torch

ZERO_GRAD = 1e-3   # of the median leaf's reference gradient norm


def leaf_norms(tensors: Dict[str, Optional[torch.Tensor]]) -> Dict[str, float]:
    """Float32 L2 norm of each leaf (None: a leaf without gradient), read
    in one transfer."""
    names = [n for n, t in tensors.items() if t is not None]
    if not names:
        return {}
    norms = torch.stack([torch.linalg.vector_norm(tensors[n].float())
                         for n in names]).cpu().tolist()
    return dict(zip(names, norms))


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              leaves: Iterable[str]) -> Dict[str, float]:
    """Each leaf's gap |prog - ref| over the larger of its reference norm
    and the median leaf's (a leaf the program never moved reads its norm
    0)."""
    leaves = list(leaves)
    median = statistics.median(ref[n] for n in leaves)
    return {n: abs(prog.get(n, 0.0) - ref[n]) / max(ref[n], median, 1e-30)
            for n in leaves}


def moved_leaves(ref_grad: Dict[str, float]) -> List[str]:
    """The leaves whose reference gradient is not nought to rounding."""
    median = statistics.median(ref_grad.values())
    return [n for n, g in ref_grad.items() if g >= ZERO_GRAD * median]


def train_readings(prog: dict, ref: dict) -> Dict[str, float]:
    """`prog` and `ref` each hold `out` (the first forward's), `losses`
    (floats), `grad` and `change` (leaf -> norm; a leaf the side never
    moved is absent). Beside the compared numbers (the cell's limits name
    them): the largest loss gap over all the steps and the median leaf's
    gaps, which `calibrate.py` reports."""
    if len(prog["losses"]) != len(ref["losses"]):
        return {"loss1_gap": float("inf")}
    losses = [abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"])]
    moved = moved_leaves(ref["grad"])
    grad = leaf_gaps(prog["grad"], ref["grad"], moved)
    change = leaf_gaps(prog["change"], ref["change"], moved)
    return {
        "out_gap": rel_l2(prog["out"], ref["out"]),
        "loss_gap": max(losses),
        "loss1_gap": losses[0],
        "grad_gap": max(grad.values()),
        "grad_gap_median": statistics.median(grad.values()),
        "change_gap": max(change.values()),
        "change_gap_median": statistics.median(change.values()),
    }


def rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest relative L2 distance over the samples of a batch."""
    b = want.shape[0]
    if tuple(got.shape) != tuple(want.shape):
        return float("inf")
    g = got.reshape(b, -1).double()
    w = want.reshape(b, -1).double()
    gap = torch.linalg.vector_norm(g - w, dim=1) / torch.linalg.vector_norm(w, dim=1)
    gap = torch.where(torch.isfinite(gap), gap, torch.full_like(gap, float("inf")))
    return float(gap.max())


def failures(readings: Dict[str, float], limits: Dict[str, float]) -> int:
    """The readings over their limits (a missing or non-finite one counts):
    the run is correct where there are none."""
    return sum(1 for name, limit in limits.items()
               if not readings.get(name, float("inf")) <= limit)
