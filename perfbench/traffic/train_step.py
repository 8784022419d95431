"""Generator `train_step`: the program's train step (`train.step.
make_train_step`, AdamW from `train.optim.make_optimizer`) back to back on a
pool of batches drawn on the device at set-up and cycled.

Traffic parameters: `volume` (S, the volume is S^3), `batch`, `rois`,
`pool` (batches in the pool), `compute_dtype`, `loss` (overrides of the
configuration's loss), `verified_steps` (the first steps, which the
reference follows), `trace_units` (steps in a traced window).

Set-up builds the model, loads the reference's weights of the seed, and
drives the step through the first `verified_steps` steps on pool batches
0, 1, 2 (rows that all differ), keeping what the check compares: the
first forward's output (a forward hook, removed after it), each step's
loss, the first gradient's norm by leaf as AdamW's state holds it after
one step, and each leaf's change after the last of them. The same
step object then runs the window, from pool batch `verified_steps` on;
nothing in it waits for the device but the closing synchronize.
"""

from __future__ import annotations

import time

import torch

from perfbench import trace
from perfbench.harness import Window
from perfbench.program import build_program, free_program, pool_of, roi_weights
from perfbench.reference import compare
from perfbench.reference import model as ref_model
from perfbench.reference import train as ref_train


def setup(ctx) -> dict:
    from coma_unet_tpu_torch.config import LossConfig
    from coma_unet_tpu_torch.train.optim import make_optimizer
    from coma_unet_tpu_torch.train.step import make_train_step

    model, weights = build_program(ctx)
    opt_cfg = ctx.cell.config["optimizer"]
    optimizer = make_optimizer(model.parameters(), opt_cfg["lr"],
                               opt_cfg["weight_decay"])
    lcfg = {k: tuple(v) if isinstance(v, list) else v
            for k, v in ctx.loss_config().items()}
    step = make_train_step(model, LossConfig(**lcfg), optimizer, seed=ctx.seed)
    # markers around the optimizer's step, for `adamw_ms.train`
    optimizer.register_step_pre_hook(lambda *args: trace.mark(ctx))
    optimizer.register_step_post_hook(lambda *args: trace.mark(ctx))
    pool = pool_of(ctx)
    rw = roi_weights(ctx)
    names = dict(model.named_parameters())
    losses, grad, outs = [], None, []
    # the first step's forward output, as the timed step produces it
    hook = model.register_forward_hook(
        lambda module, args, kwargs, result: outs.append(
            getattr(result, "out", result).detach().float().cpu()),
        with_kwargs=True)
    for i in range(ctx.traffic["verified_steps"]):
        losses.append(step(pool[i], rw)["loss"])
        if i == 0:
            hook.remove()
            beta1 = optimizer.param_groups[0]["betas"][0]
            grad = compare.leaf_norms({
                n: optimizer.state[p]["exp_avg"] / (1.0 - beta1)
                for n, p in names.items() if "exp_avg" in optimizer.state.get(p, {})})
    change = compare.leaf_norms({n: p.detach() - weights[n]
                                 for n, p in names.items()})
    del weights
    prog = {"losses": torch.stack(losses).cpu().tolist(), "grad": grad,
            "change": change, "out": outs[0]}
    return {"step": step, "model": model, "optimizer": optimizer,
            "pool": pool, "rw": rw, "next": len(losses), "prog": prog}


def window(ctx, state, seconds=None, units=None) -> Window:
    """Steps back to back until `seconds` of host clock have passed (or
    `units` steps), then a synchronize, which the window's time holds."""
    step, pool, rw = state["step"], state["pool"], state["rw"]
    i, done = state["next"], 0
    ctx.sync()
    start = time.perf_counter()
    while True:
        step(pool[i % len(pool)], rw)   # its losses stay on the device
        i, done = i + 1, done + 1
        if units is not None and done >= units:
            break
        if seconds is not None and time.perf_counter() - start >= seconds:
            break
    ctx.sync()
    elapsed = time.perf_counter() - start
    state["next"] = i
    return Window(done, elapsed)


def end_to_end(ctx, state, win: Window) -> dict:
    return {"train_samples_per_s": win.units * ctx.traffic["batch"] / win.seconds}


def reference_side(ctx, prec=ref_model.EXACT) -> dict:
    """The reference's first steps from the seed's weights on the same
    batches (float32 with TF32 off; `prec` rounds the layers' operands
    for the control): losses, first gradient and change by leaf."""
    cfg, model_type = ctx.model_config(), ctx.cell.config["model_type"]
    weights = ref_model.init_params(model_type, cfg, ctx.seed, ctx.device)
    start = {n: w.clone() for n, w in weights.items()}
    batches = pool_of(ctx)[:ctx.traffic["verified_steps"]]
    opt_cfg = ctx.cell.config["optimizer"]
    with ref_model.float32_exact():
        losses, first, out = ref_train.train_steps(
            weights, model_type, cfg, ctx.loss_config(), batches,
            roi_weights(ctx), opt_cfg["lr"], opt_cfg["weight_decay"], prec)
    return {"losses": losses, "grad": compare.leaf_norms(first),
            "change": compare.leaf_norms({n: weights[n] - start[n]
                                          for n in weights}),
            "out": out.float().cpu()}


def check(ctx, state) -> dict:
    """Free the program, then compare its first steps with the
    reference's."""
    free_program(ctx, state, ("step", "model", "optimizer", "pool"))
    return compare.train_readings(state["prog"], reference_side(ctx))
