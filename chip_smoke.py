#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA Hopper GPU.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure raises and exits non-zero):
  1. device:  nvidia-smi's name and power limit, torch and CUDA versions;
              the card must be compute capability 9.0.
  2. build:   compiles the hand-written kernels (coma_unet_tpu_torch/csrc)
              into build/coma_unet_tpu_torch/.
  3. kernels: each kernel on bf16 inputs at the shapes the 128^3 b=2 serving
              forward and train step give it -- the forward kernels K1-K4,
              the weight gradients KB1/KB2 and the norm backward KB3 --
              against its plain PyTorch version on the same inputs upcast to
              f32 (TF32 off), bf16 outputs within KERNEL_TOL and f32 outputs
              within F32_TOL of max|plain|; times both (CUDA events), and
              for KB1/KB2 also the built-in weight gradient on the bf16
              operands (what autograd of a bf16 conv runs).
  4. parity:  the full-width flagship at 64^3, b=2, random weights from a
              seed, run on the GPU through the kernels in bf16 and on the CPU
              in f32 through the plain versions; relative L2 error of `out`.
  5. gradients: one train-step loss and backward of the same model on the
              GPU (kernels, bf16), on the CPU in f32 and on the CPU in bf16
              (plain versions; the rounding baseline): the loss difference
              and, per module group, the relative L2 error of the gradients,
              which may reach GRAD_RATIO x the bf16 route's. Every parameter
              with a CPU gradient must get a finite one on the GPU.
  6. serving: the default ModelConfig at 128^3: three b=2 full-volume
              requests through `make_infer_fn` and one 216^3 sliding-window
              request; every forward kernel family must have launched and no
              plain version may have run on the GPU. Then the median b=2
              forward.
  7. training: the default ModelConfig at 128^3, b=2, `LossConfig()`,
              AdamW(1e-3): six steps of `make_train_step` on one batch; the
              losses must be finite and fall, all seven kernel families must
              have launched and no plain version may have run on the GPU.
              Then the median step time, the peak memory and a
              torch.profiler top-10 of device time for one more step.
The last two lines are a JSON summary of the kernels and
{"ok": true, "device": {...}}. There is no CPU path.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

KERNEL_TOL = 1e-2     # max|kernel - plain| <= KERNEL_TOL * max|plain|: bf16 output rounding
F32_TOL = 1e-4        # the same for f32 outputs (KB1/KB2 dW, KB3 dscale/dshift/dalpha): sums
                      # of the same operands in another order read <= 7.6e-6; one split-K
                      # partial, one halo face or one row chunk left out reads >= 1.6e-2
PARITY_TOL = 5e-2     # relative L2 of `out`, bf16 GPU forward vs f32 CPU forward
LOSS_TOL = 1e-2       # relative loss difference, bf16 GPU step vs f32 CPU step
GRAD_RATIO = 1.25     # a group's gradient error may reach max(GRAD_RATIO x the plain bf16
GRAD_FLOOR = 2e-2     # route's, GRAD_FLOOR): sound kernels read <= 1.14x over four seeds
                      # and targets, half the batch left out of one KB1 call >= 1.44x
TRAIN_STEPS = 6
SOURCES = {
    "s1": ("conv3d_s1", "coma_unet_tpu_torch/csrc/conv3d_s1.cu",
           "coma_unet_tpu/ops/pallas/conv3d_p1.py:231 _p1_fwd; "
           "conv3d.py:260 _pallas_conv3d_fwd; conv3d_packed.py:105 _packed_fwd"),
    "s2": ("conv3d_s2", "coma_unet_tpu_torch/csrc/conv3d_strided.cu",
           "coma_unet_tpu/ops/pallas/conv3d_strided.py:299 _s2_fwd_v2; "
           ":136 _s2_fwd_v1; phase_split.py:86 pallas_hwsplit"),
    "t2": ("conv3d_t2", "coma_unet_tpu_torch/csrc/conv3d_strided.cu",
           "coma_unet_tpu/ops/pallas/conv3d_strided.py:444 _t2_fwd_v1; "
           ":730 _t2_fwd_v2"),
    "norm_act": ("norm_act", "coma_unet_tpu_torch/csrc/norm_act.cu",
                 "coma_unet_tpu/ops/pallas/norm_act.py:185 _norm_act_fwd_impl"),
    "s1_dw": ("conv3d_s1_dw", "coma_unet_tpu_torch/csrc/conv3d_dw.cu",
              "coma_unet_tpu/ops/pallas/conv3d.py:586 _pallas_conv3d_dw; "
              "conv3d_p1.py:319 _p1_dw; conv3d_packed.py:195 _packed_dw"),
    "strided_dw": ("conv3d_strided_dw", "coma_unet_tpu_torch/csrc/conv3d_dw.cu",
                   "coma_unet_tpu/ops/pallas/conv3d_strided.py:579 _dw_dil_v1; "
                   ":830 _dw_v2"),
    "norm_act_bwd": ("norm_act_bwd", "coma_unet_tpu_torch/csrc/norm_act.cu",
                     "coma_unet_tpu/ops/pallas/norm_act.py:220 _norm_act_bwd_impl"),
}


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def median_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    for _ in range(warmup):
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


def phase_device() -> None:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip())  # name, power limit
    cap = torch.cuda.get_device_capability(0)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}, capability {cap}, "
          f"{torch.cuda.device_count()} device(s)")
    check(cap == (9, 0), f"need a Hopper card (9, 0), got {cap}")


def phase_build() -> None:
    from coma_unet_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.library()
    print(f"build: {time.perf_counter() - t0:.1f} s -> {_build.BUILD_DIR}")
    log = _build.BUILD_DIR / "build.log"
    if log.is_file():
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas: {line.strip()}")


def _kernel_cases():
    """(family, site, input shape, weight shape or None, extra) at the
    shapes of the 128^3 b=2 serving forward and train step."""
    v0, v1 = (128,) * 3, (64,) * 3
    s1 = [  # (site, Cin, Cout, k, per_sample, spatial)
        ("head.conv0", 1, 32, 3, True, v0), ("head.conv1", 32, 32, 3, True, v0),
        ("merge0", 64, 32, 3, False, v0),
        ("deep_modulator_3c.conv0", 3, 16, 3, False, v0),
        ("deep_modulator_3c.conv1", 16, 16, 3, False, v0),
        ("deep_modulator_3c.conv2", 16, 1, 3, False, v0),
        ("fusion_layer.conv0", 2, 8, 3, False, v0),
        ("fusion_layer.conv1", 8, 8, 3, False, v0),
        ("fusion_layer.conv2", 8, 1, 3, False, v0),
        ("gate0.W_g", 32, 16, 1, False, v0), ("gate0.psi", 16, 1, 1, False, v0),
        ("reduce", 32, 1, 1, True, v0), ("final_pred_head", 2, 1, 1, False, v0),
        ("down0.conv1", 64, 64, 3, True, v1), ("merge1", 128, 64, 3, False, v1),
        ("gate1.W_g", 64, 32, 1, False, v1), ("gate1.psi", 32, 1, 1, False, v1),
    ]
    cases = [("s1", site, (2, ci) + sp, (co, ci, k, k, k), ps)
             for site, ci, co, k, ps, sp in s1]
    cases.append(("s2", "down0.conv0", (2, 32) + v0, (64, 32, 3, 3, 3), True))
    cases.append(("t2", "up0", (2, 64) + v1, (32, 64, 3, 3, 3), True))
    # KB1: x [2, Cin, ...] and the output cotangent [2, Cout, ...]
    cases += [("s1_dw", site, (2, ci) + sp, (co, k), ps)
              for site, ci, co, k, ps, sp in s1]
    # KB2: full [2, 32, 128^3], half [2, 64, 64^3] in both roles
    cases.append(("strided_dw", "down0.conv0 (s2: full=x, half=g)",
                  (2, 32) + v0, (2, 64) + v1, True))
    cases.append(("strided_dw", "up0 (t2: full=g, half=x)",
                  (2, 32) + v0, (2, 64) + v1, True))
    norms = [("head.conv1", 32, "relu", True, v0), ("merge0", 32, "prelu", False, v0),
             ("deep_modulator_3c.conv0", 16, "leakyrelu", False, v0),
             ("gate0.psi", 1, "none", False, v0),
             ("final_pred_head", 1, "prelu", False, v0),
             ("down0.conv1", 64, "relu", True, v1)]
    for family in ("norm_act", "norm_act_bwd"):
        cases += [(family, site, (2, c) + sp, None, (act, film))
                  for site, c, act, film, sp in norms]
    return cases


def _norm_inputs(xshape, act, film, gen, dev):
    # a mean large against the spread exercises the shifted stats
    x = (3.0 + torch.randn(xshape, generator=gen, device=dev)).bfloat16()
    b, c = xshape[:2]
    alpha = torch.full((1,), 0.25, device=dev)
    scale = shift = None
    if film:
        scale = 1.0 + 0.3 * torch.randn((b, c), generator=gen, device=dev)
        shift = 0.3 * torch.randn((b, c), generator=gen, device=dev)
    return x, alpha, scale, shift


def _case_calls(family, xshape, wshape, extra, gen, dev):
    """(kernel call, plain call on the f32 upcast inputs, plain call on the
    kernel's own inputs, the built-in bf16 weight gradient or None) for one
    phase-3 case; each returns a tensor or a tuple of tensors."""
    from coma_unet_tpu_torch import ops
    from coma_unet_tpu_torch.ops.conv3d import conv3d_weight_ref

    def randn(shape):
        return torch.randn(shape, generator=gen, device=dev).bfloat16()

    if family == "norm_act":
        x, alpha, scale, shift = _norm_inputs(xshape, *extra, gen, dev)
        act = extra[0]
        return (lambda: ops.norm_act(x, alpha, act, scale, shift),
                lambda: ops.norm_act_plain(x.float(), alpha, act, scale, shift),
                lambda: ops.norm_act_plain(x, alpha, act, scale, shift), None)
    if family == "norm_act_bwd":
        x, alpha, scale, shift = _norm_inputs(xshape, *extra, gen, dev)
        act = extra[0]
        g = randn(xshape)
        _, stats = ops.norm_act_forward(x, alpha, act, scale, shift)
        return (lambda: ops.norm_act_bwd(x, g, stats, alpha, act, scale, shift),
                lambda: ops.norm_act_bwd_plain(x.float(), g.float(), alpha, act,
                                               scale, shift),
                lambda: ops.norm_act_bwd_plain(x, g, alpha, act, scale, shift), None)
    if family == "s1_dw":
        (co, k), ps = wshape, extra
        x, g = randn(xshape), randn((xshape[0], co) + xshape[2:])
        return (lambda: ops.conv3d_s1_dw(x, g, k, ps),
                lambda: ops.conv3d_s1_dw_plain(x.float(), g.float(), k, ps),
                lambda: ops.conv3d_s1_dw_plain(x, g, k, ps),
                lambda: conv3d_weight_ref(x, g, k, ps))
    if family == "strided_dw":
        full, half = randn(xshape), randn(wshape)
        return (lambda: ops.conv3d_strided_dw(full, half, extra),
                lambda: ops.conv3d_strided_dw_plain(full.float(), half.float(), extra),
                lambda: ops.conv3d_strided_dw_plain(full, half, extra),
                lambda: conv3d_weight_ref(full, half, 3, extra, 2))
    kernel, plain = {"s1": (ops.conv3d_s1, ops.conv3d_s1_plain),
                     "s2": (ops.conv3d_s2, ops.conv3d_s2_plain),
                     "t2": (ops.conv3d_t2, ops.conv3d_t2_plain)}[family]
    x = randn(xshape)
    if extra:  # per-sample weights
        wshape = (xshape[0],) + wshape
    fan_in = wshape[-4] * wshape[-1] ** 3
    w = (torch.randn(wshape, generator=gen, device=dev) / fan_in ** 0.5).bfloat16()
    bias = 0.1 * torch.randn((wshape[-5],), generator=gen, device=dev)
    return (lambda: kernel(x, w, bias), lambda: plain(x.float(), w.float(), bias),
            lambda: plain(x, w, bias), None)


def phase_kernels(summary: dict) -> None:
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    dev = torch.device("cuda")
    # rel: max error over max|plain| of the bf16 outputs and of the f32 ones;
    # bf16_ms: the built-in weight gradient on the bf16 operands
    print(f"{'family':12s} {'site':34s} {'input':22s} {'max_abs_err':>11s} "
          f"{'rel bf16':>9s} {'rel f32':>9s} {'ms':>9s} {'plain_ms':>9s} {'bf16_ms':>9s}")
    for family, site, xshape, wshape, extra in _kernel_cases():
        kernel, ref_fn, plain, builtin = _case_calls(family, xshape, wshape, extra,
                                                     gen, dev)
        with torch.no_grad():
            got, ref = kernel(), ref_fn()
            torch.cuda.synchronize()
            got = got if isinstance(got, tuple) else (got,)
            ref = ref if isinstance(ref, tuple) else (ref,)
            err, rel = 0.0, {torch.bfloat16: None, torch.float32: None}
            for a, r in zip(got, ref):
                check(a.shape == r.shape, f"{family} {site}: shape "
                      f"{tuple(a.shape)} vs {tuple(r.shape)}")
                check(a.dtype in rel, f"{family} {site}: output dtype {a.dtype}")
                check(bool(torch.isfinite(a).all()), f"{family} {site}: non-finite")
                tol = KERNEL_TOL if a.dtype == torch.bfloat16 else F32_TOL
                e = (a.float() - r.float()).abs().max().item()
                scale_ref = r.abs().max().item()
                check(e <= tol * scale_ref or e == 0.0,
                      f"{family} {site}: {a.dtype} max error {e} > {tol} * {scale_ref}")
                err = max(err, e)
                rel[a.dtype] = max(rel[a.dtype] or 0.0, e / scale_ref if scale_ref else 0.0)
            ms = median_ms(kernel)
            plain_ms = median_ms(plain)
            bf16_ms = median_ms(builtin) if builtin else None
        cols = [f"{v:9.2e}" if v is not None else f"{'-':>9s}" for v in rel.values()]
        cols.append(f"{ms:9.3f} {plain_ms:9.3f}")
        cols.append(f"{bf16_ms:9.3f}" if bf16_ms is not None else f"{'-':>9s}")
        print(f"{family:12s} {site:34s} {str(list(xshape)):22s} {err:11.3e} "
              + " ".join(cols))
        entry = summary.setdefault(family, {"max_abs_err": 0.0, "ms": 0.0,
                                            "plain_ms": 0.0})
        entry["max_abs_err"] = max(entry["max_abs_err"], err)
        entry["ms"] += ms
        entry["plain_ms"] += plain_ms
        if bf16_ms is not None:
            entry["plain_bf16_ms"] = entry.get("plain_bf16_ms", 0.0) + bf16_ms


def _batch(rng: np.random.Generator, b: int, s: int, r: int = 36) -> dict:
    """The bench's random batch (`__graft_entry__._make_batch`), as numpy."""
    def vol():
        return rng.uniform(0, 1, size=(b, 1, s, s, s)).astype(np.float32)

    batch = {"mri": vol(), "tau": vol(),
             "roi_compact": rng.integers(0, r + 1, size=(b, s, s, s)).astype(np.int32),
             "covars": rng.uniform(0, 1, size=(b, 6)).astype(np.float32),
             "abeta": rng.integers(0, 2, size=(b,)).astype(np.float32),
             "roi_loc": rng.uniform(0, 2, size=(b, r)).astype(np.float32),
             "roi_std": rng.uniform(0, 0.2, size=(b, r)).astype(np.float32)}
    return batch


def _args(batch: dict, device) -> tuple:
    return tuple(torch.as_tensor(batch[k], device=device) for k in
                 ("mri", "covars", "roi_loc", "roi_std", "roi_compact"))


def phase_parity() -> float:
    import dataclasses

    from coma_unet_tpu_torch import ContraAttnUNet, ModelConfig

    s = 64
    cfg = ModelConfig(prompt_shape=(s, s, s))
    cpu_cfg = dataclasses.replace(cfg, compute_dtype="float32")
    gen = torch.Generator().manual_seed(0)
    ref_model = ContraAttnUNet(cpu_cfg, generator=gen).eval()
    with torch.no_grad():  # FiLM starts at zero: give it and the routing signal
        for name, p in ref_model.named_parameters():
            if ".film." in name or ".route." in name:
                p.add_(0.5 * torch.randn(p.shape, generator=gen))
    gpu_model = ContraAttnUNet(cfg, device="cuda").eval()
    gpu_model.load_state_dict(ref_model.state_dict())
    # the same bf16 forward through the plain versions on the CPU: the share
    # of the error that bf16 rounding alone explains
    bf16_model = ContraAttnUNet(cfg).eval()
    bf16_model.load_state_dict(ref_model.state_dict())
    batch = _batch(np.random.default_rng(1), b=2, s=s)
    batch["covars"][:, 0] = [1.0, 0.0]  # one abeta+ and one abeta- prompt
    t0 = time.perf_counter()
    with torch.inference_mode():
        got = gpu_model(*_args(batch, "cuda"), with_projections=False).out.cpu()
        gpu_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        ref = ref_model(*_args(batch, "cpu"), with_projections=False).out
        cpu_s = time.perf_counter() - t0
        plain_bf16 = bf16_model(*_args(batch, "cpu"), with_projections=False).out

    def rel_l2(a, b):
        return (torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b)).item()

    rel = rel_l2(got, ref)
    print(f"parity 64^3 b=2: rel L2(out) = {rel:.4e} (tol {PARITY_TOL}); "
          f"plain bf16 on CPU vs f32: {rel_l2(plain_bf16, ref):.4e}; kernels "
          f"vs plain bf16: {rel_l2(got, plain_bf16):.4e}; max|ref| "
          f"{ref.abs().max().item():.4f}; gpu {gpu_s:.2f} s, cpu f32 {cpu_s:.1f} s")
    check(bool(torch.isfinite(got).all()), "parity: non-finite GPU output")
    check(rel <= PARITY_TOL, f"parity: rel L2 {rel} > {PARITY_TOL}")
    return rel


def phase_serving() -> dict:
    from coma_unet_tpu_torch import ContraAttnUNet, ModelConfig
    from coma_unet_tpu_torch import ops
    from coma_unet_tpu_torch.infer import make_infer_fn, sliding_window_inference

    cfg = ModelConfig()
    model = ContraAttnUNet(cfg, device="cuda",
                           generator=torch.Generator().manual_seed(0)).eval()
    batch = _batch(np.random.default_rng(0), b=2, s=128)
    infer = make_infer_fn(model)
    big = _batch(np.random.default_rng(2), b=1, s=216)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    ops.reset_counts()
    request_ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        out = infer(batch["mri"], batch["covars"], batch["roi_loc"],
                    batch["roi_std"], batch["roi_compact"])
        torch.cuda.synchronize()
        request_ms.append((time.perf_counter() - t0) * 1e3)
        check(tuple(out.shape) == (2, 1, 128, 128, 128), f"out {tuple(out.shape)}")
        check(bool(torch.isfinite(out).all()), "non-finite serving output")
    t0 = time.perf_counter()
    vol = sliding_window_inference(
        infer, big["mri"], big["covars"], big["roi_loc"], big["roi_std"],
        big["roi_compact"], patch_size=(128, 128, 128), overlap=0.25,
        batch_size=4)
    sw_ms = (time.perf_counter() - t0) * 1e3
    launches, plain_cuda = dict(ops.LAUNCHES), dict(ops.PLAIN_ON_CUDA)
    check(vol.shape == (1, 1, 216, 216, 216), f"sliding window {vol.shape}")
    check(bool(np.isfinite(vol).all()), "non-finite sliding-window output")
    print(f"requests (b=2, 128^3) ms: {[round(t, 2) for t in request_ms]}")
    print(f"sliding window 216^3 (8 patches of 128^3, batch 4): {sw_ms:.1f} ms")
    print(f"launches: {launches}; plain on cuda: {plain_cuda}")
    for family in ops.FWD_FAMILIES:
        check(launches.get(family, 0) > 0, f"{family}: no kernel launch")
    check(sum(plain_cuda.values()) == 0, f"plain versions ran on the GPU: {plain_cuda}")

    args = _args(batch, "cuda")
    with torch.inference_mode():
        fwd_ms = median_ms(lambda: model(*args, with_projections=False), reps=10)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"forward b=2 128^3: median {fwd_ms:.2f} ms ({fwd_ms / 2:.2f} ms/volume); "
          f"peak memory {peak:.2f} GiB")
    return launches


def _norm_fed_biases(model) -> set:
    """Conv biases that feed an instance norm: the norm removes any constant
    shift, so their true gradient is 0 and every route gives only noise."""
    from coma_unet_tpu_torch.models.blocks import CondConvolution, Convolution

    return {f"{name}.bias" for name, m in model.named_modules()
            if isinstance(m, (Convolution, CondConvolution)) and not m.conv_only
            and m.norm.kind == "instance" and m.bias is not None}


def _group(name: str) -> str:
    parts = name.split(".")
    return ".".join(parts[:2]) if parts[0] == "unet" else parts[0]


def _loss_and_grads(model, batch: dict, device) -> tuple:
    from coma_unet_tpu_torch import LossConfig
    from coma_unet_tpu_torch.train import make_loss_fn

    model.train()
    model.zero_grad(set_to_none=True)
    tb = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
    roi_w = torch.full((36,), 225.0, device=device)
    t0 = time.perf_counter()
    total, _ = make_loss_fn(model, LossConfig())(tb, roi_w)
    total.backward()
    loss = float(total.detach())
    grads = {n: None if p.grad is None else p.grad.detach().float().cpu()
             for n, p in model.named_parameters()}
    return loss, grads, time.perf_counter() - t0


def phase_gradients() -> None:
    import dataclasses

    from coma_unet_tpu_torch import ContraAttnUNet, ModelConfig

    s = 64
    cfg = ModelConfig(prompt_shape=(s, s, s))
    gen = torch.Generator().manual_seed(0)
    ref_model = ContraAttnUNet(dataclasses.replace(cfg, compute_dtype="float32"),
                               generator=gen)
    with torch.no_grad():  # FiLM starts at zero: give it and the routing signal
        for name, p in ref_model.named_parameters():
            if ".film." in name or ".route." in name:
                p.add_(0.5 * torch.randn(p.shape, generator=gen))
    gpu_model = ContraAttnUNet(cfg, device="cuda")
    gpu_model.load_state_dict(ref_model.state_dict())
    bf16_model = ContraAttnUNet(cfg)
    bf16_model.load_state_dict(ref_model.state_dict())
    batch = _batch(np.random.default_rng(1), b=2, s=s)
    batch["covars"][:, 0] = [1.0, 0.0]  # one abeta+ and one abeta- prompt

    loss_gpu, g_gpu, t_gpu = _loss_and_grads(gpu_model, batch, "cuda")
    loss_ref, g_ref, t_ref = _loss_and_grads(ref_model, batch, "cpu")
    loss_bf, g_bf, t_bf = _loss_and_grads(bf16_model, batch, "cpu")
    print(f"gradients 64^3 b=2: loss gpu {loss_gpu:.6f}, cpu f32 {loss_ref:.6f}, "
          f"cpu bf16 {loss_bf:.6f}; gpu {t_gpu:.2f} s, cpu f32 {t_ref:.1f} s, "
          f"cpu bf16 {t_bf:.1f} s")
    for name, g in g_ref.items():
        if g is None:
            continue
        got = g_gpu[name]
        check(got is not None, f"gradients: {name} has a CPU gradient but none on the GPU")
        check(bool(torch.isfinite(got).all()), f"gradients: {name} non-finite on the GPU")
    rel_loss = abs(loss_gpu - loss_ref) / abs(loss_ref)
    check(rel_loss <= LOSS_TOL, f"gradients: loss differs by {rel_loss} > {LOSS_TOL}")

    skip = _norm_fed_biases(ref_model)
    groups: dict = {}
    for name, g in g_ref.items():
        if g is None or name in skip:
            continue
        groups.setdefault(_group(name), []).append(name)

    def rel_l2_to(grads, other, names):
        num = sum(float((grads[n] - other[n]).square().sum()) for n in names)
        den = sum(float(other[n].square().sum()) for n in names)
        return (num / den) ** 0.5 if den > 0 else 0.0

    # columns: each bf16 route against f32, the limit, and the two bf16
    # routes against each other
    print(f"{'group':28s} {'kernels':>10s} {'bf16 plain':>10s} {'limit':>10s} "
          f"{'k vs plain':>10s}")
    failed = []
    for group, names in groups.items():
        err = rel_l2_to(g_gpu, g_ref, names)
        base = rel_l2_to(g_bf, g_ref, names)
        limit = max(GRAD_RATIO * base, GRAD_FLOOR)
        print(f"{group:28s} {err:10.3e} {base:10.3e} {limit:10.3e} "
              f"{rel_l2_to(g_gpu, g_bf, names):10.3e}")
        if err > limit:
            failed.append(group)
    check(not failed, f"gradients: groups over their limit: {failed}")
    print(f"gradients: loss rel diff {rel_loss:.3e}; {len(groups)} groups within "
          f"limits ({len(skip)} norm-fed conv biases excluded)")


def phase_training() -> dict:
    from coma_unet_tpu_torch import ContraAttnUNet, LossConfig, ModelConfig
    from coma_unet_tpu_torch import ops
    from coma_unet_tpu_torch.train import create_train_state, make_train_step

    model = ContraAttnUNet(ModelConfig(), device="cuda",
                           generator=torch.Generator().manual_seed(0))
    state = create_train_state(model, 1e-3)
    step = make_train_step(model, LossConfig(), state.optimizer)
    batch = {k: torch.as_tensor(v, device="cuda")
             for k, v in _batch(np.random.default_rng(0), b=2, s=128).items()}
    roi_w = torch.full((36,), 225.0, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    ops.reset_counts()
    losses, step_ms = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        metrics = step(batch, roi_w)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(metrics["loss"]))
    launches, plain_cuda = dict(ops.LAUNCHES), dict(ops.PLAIN_ON_CUDA)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"train losses: {[round(v, 6) for v in losses]}; grad_norm "
          f"{float(metrics['grad_norm']):.4f}; tcds {float(metrics['tcds_loss'])}")
    print(f"train launches over {TRAIN_STEPS} steps: {launches}; plain on cuda: "
          f"{plain_cuda}")
    check(all(np.isfinite(losses)), f"non-finite train loss: {losses}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    check(state.step == TRAIN_STEPS, f"train state counts {state.step} updates")
    for family in ops.FAMILIES:
        check(launches.get(family, 0) > 0, f"{family}: no kernel launch in training")
    check(sum(plain_cuda.values()) == 0, f"plain versions ran on the GPU: {plain_cuda}")
    med = statistics.median(step_ms[1:])
    print(f"train step b=2 128^3: median {med:.2f} ms over steps 2-{TRAIN_STEPS} "
          f"({med / 2:.2f} ms/volume); all steps ms {[round(t, 2) for t in step_ms]}; "
          f"peak memory {peak:.2f} GiB")

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(batch, roi_w)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3

    def device_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(
            e, "self_cuda_time_total", 0)

    # kernel events only: an autograd Function's range carries the time of
    # the kernels it launches as well, and would count them twice
    kernels = sorted((e for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA),
                     key=device_us, reverse=True)
    total = sum(device_us(e) for e in kernels) / 1e3
    print(f"profiled step: {wall:.2f} ms wall, {total:.2f} ms summed kernel time "
          f"(device idle share {max(0.0, 1 - total / wall):.3f}); top 10 kernels:")
    for e in kernels[:10]:
        print(f"  {device_us(e) / 1e3:9.3f} ms  x{e.count:<5d} {e.key[:100]}")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs a GPU",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    phase_device()
    phase_build()
    summary: dict = {}
    phase_kernels(summary)
    phase_parity()
    phase_gradients()
    serving = phase_serving()
    launches = phase_training()
    kernels = []
    for family, (name, source, replaces) in SOURCES.items():
        entry = summary[family]
        kernel = {"name": name, "route": "cuda", "source": source,
                  "replaces": replaces, "launches": launches.get(family, 0),
                  "max_abs_err": entry["max_abs_err"],
                  "ms": round(entry["ms"], 4),
                  "plain_ms": round(entry["plain_ms"], 4)}
        if "plain_bf16_ms" in entry:
            kernel["plain_bf16_ms"] = round(entry["plain_bf16_ms"], 4)
        if family in serving:
            kernel["serving_launches"] = serving[family]
        kernels.append(kernel)
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
