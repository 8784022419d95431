"""Time K4 and KB3 at the shapes of `chip_smoke.py` phase 3, through the
public wrappers of the tree this module is imported from.

    python3 -m coma_unet_tpu_torch.norm_times TAG

For each site prints the median of 10 calls by CUDA events (as phase 3
times them, the host's enqueue included) and the device time a call by
torch.profiler (the kernels whose name holds "norm"). To compare two trees
on one card, run it from each in turns (parent, change, change, parent)
within one call to the card; a tree unpacked elsewhere runs it with
`PYTHONPATH=.` from its root.
"""

from __future__ import annotations

import statistics
import sys

import torch

V0, V1, T0 = (128,) * 3, (64,) * 3, (216,) * 3
# (site, batch, channels, activation, FiLM, spatial); the last one is K4 only
CASES = [("head.conv1", 2, 32, "relu", True, V0), ("merge0", 2, 32, "prelu", False, V0),
         ("deep_modulator_3c.conv0", 2, 16, "leakyrelu", False, V0),
         ("gate0.psi", 2, 1, "none", False, V0), ("final_pred_head", 2, 1, "prelu", False, V0),
         ("down0.conv1", 2, 64, "relu", True, V1), ("216 head.conv1", 1, 32, "relu", True, T0),
         ("odd sizes", 2, 24, "prelu", True, (27, 18, 45)),
         ("216 b=2 head.conv1 (eval)", 2, 32, "relu", True, T0)]


def median_ms(fn, reps: int = 10) -> float:
    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, calls: int = 5) -> float:
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = 0.0
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA and "norm" in e.key:
            us += (getattr(e, "self_device_time_total", 0)
                   or getattr(e, "self_cuda_time_total", 0))
    return us / calls / 1e3


def main() -> int:
    from coma_unet_tpu_torch import ops

    if not torch.cuda.is_available():
        print("norm_times: no CUDA device", file=sys.stderr)
        return 2
    tag = sys.argv[1] if len(sys.argv) > 1 else "tree"
    dev = torch.device("cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for site, b, c, act, film, sp in CASES:
        shape = (b, c) + sp
        x = (3.0 + torch.randn(shape, generator=gen, device=dev)).bfloat16()
        alpha = torch.full((1,), 0.25, device=dev)
        scale = shift = None
        if film:
            scale = 1.0 + 0.3 * torch.randn((b, c), generator=gen, device=dev)
            shift = 0.3 * torch.randn((b, c), generator=gen, device=dev)
        g = torch.randn(shape, generator=gen, device=dev).bfloat16()
        with torch.no_grad():
            def k4():
                return ops.norm_act(x, alpha, act, scale, shift)

            _, stats = ops.norm_act_forward(x, alpha, act, scale, shift)

            def kb3():
                return ops.norm_act_bwd(x, g, stats, alpha, act, scale, shift)

            line = (f"{tag} {site:28s} {str(list(shape)):24s} K4 {median_ms(k4):.3f} ms "
                    f"(device {device_ms(k4):.4f})")
            if "eval" not in site:
                line += f"  KB3 {median_ms(kb3):.3f} ms (device {device_ms(kb3):.4f})"
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
