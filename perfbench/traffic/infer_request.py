"""Generator `infer_request`: synthesis requests as `cli infer` serves them,
in a closed loop of one client. Each request hands over a batch (mri,
covars, roi_loc, roi_std, roi_compact) in pinned host memory, as the CLI's
loader leaves it (`data.pipeline.pin_batch`), from a pool drawn at set-up;
the program copies it to the card (`data.pipeline.batch_to_device`), runs
the function the CLI calls (`infer.sliding_window.make_infer_fn`) and
copies the synthesized volume back to a host numpy array, as the CLI's
writer does. A request is timed from hand-over to that array.

Traffic parameters: `volume`, `batch`, `rois`, `pool`, `compute_dtype`,
`warmup` (requests at set-up), `checked_requests` (answers kept for the
check, drawn from the seed over the window), `trace_units` (requests in a
traced window).

The order of the pool's batches is drawn from the seed, so every seed
sends the same sizes in another order. The check runs the reference's
forward on the kept requests' inputs, drawn again from the seed, and
compares each returned volume with it.
"""

from __future__ import annotations

import random
import time

import numpy as np
import torch

from perfbench.harness import Window
from perfbench.reference import compare
from perfbench.reference import model as ref_model
from perfbench.program import build_program, free_program, pool_of

KEYS = ("mri", "covars", "roi_loc", "roi_std", "roi_compact")


def setup(ctx) -> dict:
    from coma_unet_tpu_torch.data.pipeline import pin_batch
    from coma_unet_tpu_torch.infer.sliding_window import make_infer_fn

    model, weights = build_program(ctx)
    del weights
    infer = make_infer_fn(model)
    pool = [{k: b[k].cpu().numpy() for k in KEYS} for b in pool_of(ctx)]
    if ctx.device.type == "cuda":   # pinned, as the CLI's loader hands them over
        pool = [pin_batch(b) for b in pool]
    rng = random.Random(ctx.seed)
    state = {"model": model, "infer": infer, "pool": pool, "rng": rng,
             "kept": [], "seen": 0, "device": ctx.device}
    for i in range(ctx.traffic["warmup"]):
        request(state, i % len(pool))
    return state


def request(state, index: int) -> np.ndarray:
    from coma_unet_tpu_torch.data.pipeline import batch_to_device

    batch = batch_to_device(state["pool"][index], state["device"])
    out = state["infer"](*(batch[k] for k in KEYS))
    return out.float().cpu().numpy()


def window(ctx, state, seconds=None, units=None) -> Window:
    pool, rng = state["pool"], state["rng"]
    keep = ctx.traffic["checked_requests"]
    kept, latencies = state["kept"], []
    order = []
    ctx.sync()
    start = time.perf_counter()
    while True:
        if not order:
            order = list(range(len(pool)))
            rng.shuffle(order)
        index = order.pop()
        t0 = time.perf_counter()
        answer = request(state, index)
        latencies.append(time.perf_counter() - t0)
        # reservoir sample of the answers, drawn from the seed
        seen = state["seen"] = state["seen"] + 1
        if len(kept) < keep:
            kept.append((index, answer))
        else:
            j = rng.randrange(seen)
            if j < keep:
                kept[j] = (index, answer)
        if units is not None and len(latencies) >= units:
            break
        if seconds is not None and time.perf_counter() - start >= seconds:
            break
    ctx.sync()
    return Window(len(latencies), time.perf_counter() - start, latencies)


def end_to_end(ctx, state, win: Window) -> dict:
    lat = sorted(win.latencies)
    p95 = lat[min(len(lat) - 1, int(np.ceil(0.95 * len(lat))) - 1)]
    return {"infer_volumes_per_s": win.units * ctx.traffic["batch"] / win.seconds,
            "infer_p95_ms": p95 * 1e3}


def reference_outs(ctx, indices, prec=ref_model.EXACT) -> dict:
    """The reference's forward (float32, TF32 off) of the pool's batches
    `indices`, drawn again from the seed: index -> out on the host."""
    cfg, model_type = ctx.model_config(), ctx.cell.config["model_type"]
    weights = ref_model.init_params(model_type, cfg, ctx.seed, ctx.device)
    pool = pool_of(ctx)
    want = {}
    with ref_model.float32_exact(), torch.no_grad():
        for index in sorted(set(indices)):
            out, _ = ref_model.forward(
                weights, model_type, cfg, *(pool[index][k] for k in KEYS),
                with_projections=False, prec=prec)
            want[index] = out.cpu()
    return want


def check(ctx, state) -> dict:
    kept = state["kept"]
    free_program(ctx, state, ("model", "infer", "pool"))
    want = reference_outs(ctx, [i for i, _ in kept])
    gaps = [compare.rel_l2(torch.from_numpy(a), want[i]) for i, a in kept]
    return {"out_gap": max(gaps, default=float("inf"))}
