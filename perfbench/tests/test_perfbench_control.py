"""The control of `correct`: the reference computed in float8
(`reference/control.py`) put in the program's place has to come out as
not correct under each cell's limits, on three seeds. Here at a small size
on the CPU; on the card (`chip`) at the cells' own sizes, where the
program's own readings on the same seeds have to pass."""

import pytest

import torch

from perfbench import harness
from perfbench.calibrate import calibrate
from perfbench.reference.compare import failures

CELLS = ("contra.train_rnc.128", "attnunet.train.128", "contra.infer.216",
         "contra.train.216")
SEEDS = (2 ** 31 + 21, 2 ** 31 + 22, 2 ** 31 + 23)
# the smallest size at which float8's error reaches what it is at the
# cells' own: 32^3, four levels of (8, 16, 32, 64) channels
SMALL = {"model": {"channels": [8, 16, 32, 64], "strides": [2, 2, 2, 2],
                   "latent_spaces": [32] * 4, "num_experts": 4},
         "traffic": {"volume": 32, "rois": 5}}


def _cells():
    names = {w["name"] for w in harness.load_json(
        harness.CHECKOUT / "BENCHMARK.json")["workloads"]}
    return [c for c in CELLS if c in names]


@pytest.mark.parametrize("cell", _cells())
def test_control_fails_at_a_small_size(cell):
    limits = harness.Cell.load(cell).limits
    for out in calibrate(cell, SEEDS, True, torch.device("cpu"), SMALL):
        assert failures(out["control"], limits), (out["seed"], out["control"])


@pytest.mark.chip
@pytest.mark.parametrize("cell", _cells())
def test_control_fails_and_the_program_passes_on_the_card(cell, cuda_device):
    limits = harness.Cell.load(cell).limits
    for out in calibrate(cell, SEEDS, True, cuda_device):
        assert not failures(out["program"], limits), (out["seed"], out["program"])
        assert failures(out["control"], limits), (out["seed"], out["control"])
