"""The work of one unit (a train step or a request), counted from the
plain reference at the cell's shapes, whatever runs it in the program.

The reference runs on the `meta` device, so nothing is computed: a
`FlopCounterMode` counts the step's operations (forward, and for a train
step the backward), its convs replaced by the record's count (it counts a
grouped conv's weight gradient once for each group), and a dispatch mode
records every conv's shapes, from
which each conv's least time on the chip follows: the larger of its
operations over the peak rate and its bytes over the peak bandwidth, each
input and output byte counted once at the configuration's element size.
A conv's backward is its input gradient and its weight gradient, each one
conv's operations.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from perfbench.reference import model as ref_model
from perfbench.reference import train as ref_train

aten = torch.ops.aten


@dataclass
class Conv:
    """One conv call: operations and the bytes it must read and write."""
    flops: float
    bytes: float


@dataclass
class Work:
    flops: float               # every operation FlopCounterMode counts
    convs: List[Conv]

    @property
    def conv_flops(self) -> float:
        return sum(c.flops for c in self.convs)

    def conv_least_s(self, flops_per_s: float, bytes_per_s: float) -> float:
        return sum(max(c.flops / flops_per_s, c.bytes / bytes_per_s)
                   for c in self.convs)


def conv_flops(x_shape, w_shape, out_shape, transposed: bool) -> float:
    """2 x MACs of a conv: every weight element meets every voxel of the
    smaller side (the output, or a transposed conv's input), per sample."""
    spatial = x_shape[2:] if transposed else out_shape[2:]
    return 2.0 * x_shape[0] * math.prod(w_shape) * math.prod(spatial)


class _ConvRecorder(TorchDispatchMode):
    def __init__(self, element: int):
        super().__init__()
        self.element = element
        self.convs: List[Conv] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        e = self.element
        if func is aten.convolution.default:
            x, w, transposed = args[0], args[1], args[6]
            f = conv_flops(x.shape, w.shape, out.shape, transposed)
            n = x.numel() + w.numel() + out.numel()
            self.convs.append(Conv(f, e * n))
        elif func is aten.convolution_backward.default:
            g, x, w = args[0], args[1], args[2]
            transposed, mask = args[7], args[10]
            f = conv_flops(x.shape, w.shape, g.shape, transposed)
            n = g.numel()
            if mask[0]:     # input gradient: reads w, writes dx
                n += w.numel() + x.numel()
            if mask[1]:     # weight gradient: reads x, writes dw
                n += x.numel() + w.numel()
            self.convs.append(Conv(f * (int(mask[0]) + int(mask[1])), e * n))
        return out


def _meta_inputs(b: int, size: int, rois: int):
    vol = (b, 1, size, size, size)
    return {"mri": torch.empty(vol, device="meta"),
            "tau": torch.empty(vol, device="meta"),
            "roi_compact": torch.empty((b, size, size, size), dtype=torch.int32,
                                       device="meta"),
            "covars": torch.empty((b, 6), device="meta"),
            "roi_loc": torch.empty((b, rois), device="meta"),
            "roi_std": torch.empty((b, rois), device="meta")}


def count(model_type: str, cfg: dict, lcfg: dict, batch: int, size: int,
          rois: int, train: bool, element: int) -> Work:
    """The work of one train step (`train`) or one forward without the
    projection heads, at batch `batch` and volume `size`^3."""
    shapes = ref_model.param_shapes(model_type, cfg)
    params = {n: torch.empty(s, device="meta") for n, (s, _) in shapes.items()}
    inputs = _meta_inputs(batch, size, rois)
    recorder = _ConvRecorder(element)
    counter = FlopCounterMode(display=False)
    with counter, recorder:
        if train:
            leaves = [p.requires_grad_(True) for p in params.values()]
            total = ref_train.loss(params, model_type, cfg, lcfg, inputs,
                                   torch.empty((rois,), device="meta"))
            torch.autograd.grad(total, leaves, allow_unused=True)
        else:
            with torch.no_grad():
                ref_model.forward(params, model_type, cfg, inputs["mri"],
                                  inputs["covars"], inputs["roi_loc"],
                                  inputs["roi_std"], inputs["roi_compact"],
                                  with_projections=False)
    # FlopCounterMode's weight gradient of a grouped conv leaves the groups
    # out (it counts `groups` times too much: the per-sample expert convs
    # are grouped over the batch); its conv counts give way to the record's
    counts = counter.get_flop_counts()["Global"]
    convs = sum(v for k, v in counts.items()
                if k in (aten.convolution, aten.convolution_backward))
    flops = counter.get_total_flops() - convs + sum(c.flops for c in recorder.convs)
    return Work(float(flops), recorder.convs)


def count_work(ctx) -> Work:
    """The work of one unit of the cell's traffic (`Context`)."""
    t = ctx.traffic
    element = torch.finfo(getattr(torch, ctx.model_config()["compute_dtype"])).bits // 8
    return count(ctx.cell.config["model_type"], ctx.model_config(),
                 ctx.loss_config(), t["batch"], t["volume"], t["rois"],
                 t["generator"] == "train_step", element)


def peak_rates(ctx) -> Tuple[float, float]:
    """(operations per second, bytes per second) of the chip at the
    configuration's compute dtype (`peaks.json`)."""
    peaks = ctx.peaks
    dtype = ctx.model_config()["compute_dtype"]
    return float(peaks["flops_per_s"][dtype]), float(peaks["bytes_per_s"])
