"""The correctness control: the reference computed in float8, the
precision below the configuration's bfloat16 (the step a later change
would be tempted to take): every activation is rounded to float8 wherever
the program holds it in bfloat16 (each conv's input and output, each
norm's and activation's output), and each weight at its use.

Forward values go to e4m3 and the gradients that flow back through the
same places to e5m2, each tensor scaled so that its largest magnitude
meets the format's largest finite value, as a float8 training recipe does;
the products and sums inside a layer stay in float32. The limits of `correct` lie between what the program
reads and what this control reads (`reference/compare.py`).
"""

from __future__ import annotations

import torch

from perfbench.reference.model import Precision

E4M3 = torch.float8_e4m3fn
E5M2 = torch.float8_e5m2


def round_to(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x rounded to `dtype` under a per-tensor scale, returned in x's
    dtype."""
    amax = x.detach().abs().amax().float()
    if not torch.isfinite(amax) or float(amax) == 0.0:
        return x
    scale = torch.finfo(dtype).max / amax
    return ((x.float() * scale).to(dtype).float() / scale).to(x.dtype)


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return round_to(x, E4M3)

    @staticmethod
    def backward(ctx, g):
        return round_to(g, E5M2)


class Float8(Precision):
    def act(self, x: torch.Tensor) -> torch.Tensor:
        return _Fp8.apply(x)

    def weight(self, w: torch.Tensor) -> torch.Tensor:
        return _Fp8.apply(w)


FLOAT8 = Float8()
