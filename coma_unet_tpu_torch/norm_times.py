"""Time K4, KB3 and K4's two slab halves at the shapes of `chip_smoke.py`
phase 3, through the public wrappers of the tree this module is imported
from.

    python3 -m coma_unet_tpu_torch.norm_times TAG [k4|slab|sweep]

`k4` times K4 and KB3 alone, `slab` the slab halves alone; both by
default. For K4 and KB3 each site prints the median of 10 calls by CUDA
events (as phase 3 times them, the host's enqueue included) and the device
time a call by torch.profiler (the kernels whose name holds "norm"). For
the slab halves, in bf16 and in float32: the median of 20 calls by CUDA
events; the span of a call on the device (events behind an L2 flush, a
read of 256 MB that keeps the device busy while the host enqueues the
call: first launch to last, gaps between launches included, median of 10);
the device time a call by torch.profiler over 5 calls with the L2 flushed
before each (every device activity of the call but the flush's); and the
host's time to enqueue a call (no synchronize, median of 20);
the statistics half also prints `torch.var_mean`'s on the same rows, its
one-call counterpart. `sweep` times each half's kernel (flushed device
time) at the path's slab shapes for a range of cuts forced past
`slab_plan`. To compare two trees on one card, run it from each in turns
(parent, change, change, parent) within one call to the card; a tree
unpacked elsewhere runs it with `PYTHONPATH=.` from its root.
"""

from __future__ import annotations

import statistics
import sys
import time

import torch

V0, V1, T0 = (128,) * 3, (64,) * 3, (216,) * 3
# (site, batch, channels, activation, FiLM, spatial); the last one is K4 only
CASES = [("head.conv1", 2, 32, "relu", True, V0), ("merge0", 2, 32, "prelu", False, V0),
         ("deep_modulator_3c.conv0", 2, 16, "leakyrelu", False, V0),
         ("gate0.psi", 2, 1, "none", False, V0), ("final_pred_head", 2, 1, "prelu", False, V0),
         ("down0.conv1", 2, 64, "relu", True, V1), ("216 head.conv1", 1, 32, "relu", True, T0),
         ("odd sizes", 2, 24, "prelu", True, (27, 18, 45)),
         ("216 b=2 head.conv1 (eval)", 2, 32, "relu", True, T0)]
# K4's slab halves at phase 3's slab sites: a rank's half slab (64 of 128
# planes at level 0, 32 of 64 at level 1) of the depth-sharded forward, and
# off the path at odd sizes, also with x 2 bytes off 16
HALF0, HALF1 = (64, 128, 128), (32, 64, 64)
SLAB_CASES = [("half slab head.conv1", 1, 32, "relu", True, HALF0, 0),
              ("half slab gate0.psi", 1, 1, "none", False, HALF0, 0),
              ("half slab final_pred_head", 1, 1, "prelu", False, HALF0, 0),
              ("half slab down0.conv1", 1, 64, "relu", True, HALF1, 0),
              ("odd sizes", 2, 24, "prelu", True, (27, 18, 45), 0),
              ("odd sizes, x off 16", 2, 24, "prelu", True, (27, 18, 45), 1)]


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


def enqueue_ms(fn, reps: int = 20) -> float:
    """The median host time of one call, which returns before the device
    has run it."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append(1e3 * (time.perf_counter() - t0))
    torch.cuda.synchronize()
    return statistics.median(times)


_FLUSH: dict = {}


def _flush() -> None:
    """Reads 256 MB, so that the next call finds none of its data in the
    50 MB L2 (and no dirty lines to write back)."""
    if "buf" not in _FLUSH:
        _FLUSH["buf"] = torch.ones(64 * 2 ** 20, device="cuda")
    _FLUSH["buf"].sum()


def _keys(prof) -> dict:
    return {e.key: (getattr(e, "self_device_time_total", 0)
                    or getattr(e, "self_cuda_time_total", 0))
            for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA}


def device_ms(fn, calls: int = 5, name: str | None = "norm", flush: bool = False) -> float:
    """The device time of one call by torch.profiler: the kernels whose name
    holds `name`, or every device activity where `name` is None. With
    `flush`, the L2 is flushed before each call, and the flush's own
    kernels are left out."""
    from torch.profiler import ProfilerActivity, profile

    skip = set()
    if flush:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            _flush()
            torch.cuda.synchronize()
        skip = set(_keys(prof))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            if flush:
                _flush()
            fn()
        torch.cuda.synchronize()
    us = sum(t for key, t in _keys(prof).items()
             if key not in skip and (name is None or name in key))
    return us / calls / 1e3


def span_ms(fn, reps: int = 10) -> float:
    """The median device span of one call, from its first launch's start to
    its last one's end, gaps between launches included: CUDA events around
    the call, recorded behind a flush of the L2 that keeps the device busy
    while the host enqueues the call."""
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        _flush()
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _times(fn) -> str:
    return (f"{median_ms(fn, 20):.4f} ms (span {span_ms(fn):.4f}, device "
            f"{device_ms(fn, name=None, flush=True):.4f}, enqueue {enqueue_ms(fn):.4f})")


def k4_sites(tag: str, dev: torch.device, gen: torch.Generator) -> None:
    from coma_unet_tpu_torch import ops

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


def slab_sites(tag: str, dev: torch.device, gen: torch.Generator) -> None:
    from coma_unet_tpu_torch import ops
    from coma_unet_tpu_torch.ops.norm_act import mean_rstd, row_partials

    for dtype in (torch.bfloat16, torch.float32):
        for site, b, c, act, film, sp, offset in SLAB_CASES:
            shape = (b, c) + sp
            size = b * c * sp[0] * sp[1] * sp[2]
            # bf16 values in either dtype, x `offset` elements into its
            # allocation, as phase 3 makes them
            x = (3.0 + torch.randn(size + offset, generator=gen, device=dev)).bfloat16()
            x = x.to(dtype)[offset:].view(shape)
            alpha = torch.full((1,), 0.25, device=dev)
            scale = shift = None
            if film:
                scale = 1.0 + 0.3 * torch.randn((b, c), generator=gen, device=dev)
                shift = 0.3 * torch.randn((b, c), generator=gen, device=dev)
            stats = mean_rstd(row_partials(x))
            rows = x.reshape(b * c, -1)
            name = "f32 " if dtype == torch.float32 else "bf16"
            with torch.no_grad():
                print(f"{tag} {name} {site:26s} {str(list(shape)):22s} "
                      f"stats {_times(lambda: ops.norm_stats(x))}  "
                      f"var_mean {_times(lambda: torch.var_mean(rows, dim=1))}  "
                      f"apply {_times(lambda: ops.norm_apply(x, stats, alpha, act, scale, shift))}",
                      flush=True)


SWEEP_SHAPES = [(1, 32) + HALF0, (1, 16) + HALF0, (1, 1) + HALF0, (1, 64) + HALF1,
                (1, 32) + HALF1, (1, 1) + HALF1]


def sweep(tag: str, dev: torch.device, gen: torch.Generator) -> None:
    """Each half's flushed device time at the path's slab shapes, for cuts
    of 1 to 528 segments a row forced past `slab_plan` (through the C
    entries, as the wrappers launch them), beside the plan's own cut."""
    import importlib
    import math

    from coma_unet_tpu_torch.ops import _build

    na = importlib.import_module("coma_unet_tpu_torch.ops.norm_act")
    for dtype in (torch.bfloat16, torch.float32):
        for shape in SWEEP_SHAPES:
            rows, n = shape[0] * shape[1], math.prod(shape[2:])
            x = (3.0 + torch.randn(shape, generator=gen, device=dev)).to(dtype)
            stats = na.mean_rstd(na.row_partials(x))
            out = torch.empty((rows, 3), dtype=torch.float64, device=dev)
            y = torch.empty_like(x)
            plans = {na.slab_plan_of(x, 0).segs, na.slab_plan_of(x, 1, "relu").segs}
            wants = sorted({w for w in (1, 2, 4, 8, 9, 16, 17, 33, 66, 99, 132, 264, 528)
                            if 8 * w <= n} | plans)
            for want in wants:
                seg = 8 * na._cdiv(na._cdiv(n, want), 8)
                segs = na._cdiv(n, seg)
                part, count = na._slab_work(x.device, rows * segs * 3, rows)
                fam_s, entry_s = na._entry("norm_stats", dtype)
                fam_a, entry_a = na._entry("norm_apply", dtype)

                def stats_call():
                    _build.launch(fam_s, entry_s, x.device, x.data_ptr(), part.data_ptr(),
                                  count.data_ptr(), out.data_ptr(), rows, n, seg, segs)

                def apply_call():
                    _build.launch(fam_a, entry_a, x.device, x.data_ptr(), stats.data_ptr(),
                                  None, None, None, y.data_ptr(), rows, n, na.ACTS["relu"],
                                  seg, segs)

                mark = "  (plan)" if segs in plans else ""
                print(f"{tag} sweep {str(dtype)[6:]:8s} {str(list(shape)):22s} segs {segs:4d} "
                      f"ctas {rows * segs:5d} seg {seg:7d}: stats "
                      f"{device_ms(stats_call, name='slab', flush=True):.4f} apply "
                      f"{device_ms(apply_call, name='slab', flush=True):.4f} ms{mark}",
                      flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("norm_times: no CUDA device", file=sys.stderr)
        return 2
    tag = sys.argv[1] if len(sys.argv) > 1 else "tree"
    which = sys.argv[2] if len(sys.argv) > 2 else "all"
    dev = torch.device("cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    if which in ("all", "k4"):
        k4_sites(tag, dev, gen)
    if which in ("all", "slab"):
        slab_sites(tag, dev, gen)
    if which == "sweep":
        sweep(tag, dev, gen)
    return 0


if __name__ == "__main__":
    sys.exit(main())
