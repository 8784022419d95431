#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA Hopper GPU.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure raises and exits non-zero):
  1. device:  nvidia-smi's name and power limit, torch and CUDA versions;
              the card must be compute capability 9.0.
  2. build:   compiles the hand-written kernels (coma_unet_tpu_torch/csrc)
              into build/coma_unet_tpu_torch/.
  3. kernels: each kernel on bf16 inputs at the shapes the 128^3 b=2 serving
              forward gives it, against its plain PyTorch version on the same
              inputs upcast to f32 (TF32 off); times both (CUDA events).
  4. parity:  the full-width flagship at 64^3, b=2, random weights from a
              seed, run on the GPU through the kernels in bf16 and on the CPU
              in f32 through the plain versions; relative L2 error of `out`.
  5. serving: the default ModelConfig at 128^3: three b=2 full-volume
              requests through `make_infer_fn` and one 216^3 sliding-window
              request; every kernel family must have launched and no plain
              version may have run on the GPU. Then the median b=2 forward.
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
PARITY_TOL = 5e-2     # relative L2 of `out`, bf16 GPU forward vs f32 CPU forward
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
    shapes of the 128^3 b=2 serving forward."""
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
    for site, c, act, film, sp in [
            ("head.conv1", 32, "relu", True, v0), ("merge0", 32, "prelu", False, v0),
            ("deep_modulator_3c.conv0", 16, "leakyrelu", False, v0),
            ("gate0.psi", 1, "none", False, v0),
            ("final_pred_head", 1, "prelu", False, v0),
            ("down0.conv1", 64, "relu", True, v1)]:
        cases.append(("norm_act", site, (2, c) + sp, None, (act, film)))
    return cases


def phase_kernels(summary: dict) -> None:
    from coma_unet_tpu_torch import ops

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    dev = torch.device("cuda")
    wrappers = {"s1": (ops.conv3d_s1, ops.conv3d_s1_plain),
                "s2": (ops.conv3d_s2, ops.conv3d_s2_plain),
                "t2": (ops.conv3d_t2, ops.conv3d_t2_plain),
                "norm_act": (ops.norm_act, ops.norm_act_plain)}
    print(f"{'family':9s} {'site':26s} {'input':22s} {'max_abs_err':>11s} "
          f"{'rel':>9s} {'ms':>9s} {'plain_ms':>9s}")
    for family, site, xshape, wshape, extra in _kernel_cases():
        kernel, plain = wrappers[family]
        if family == "norm_act":
            act, film = extra
            # a mean large against the spread exercises the shifted stats
            x = (3.0 + torch.randn(xshape, generator=gen, device=dev)).bfloat16()
            b, c = xshape[:2]
            alpha = torch.full((1,), 0.25, device=dev)
            scale = shift = None
            if film:
                scale = 1.0 + 0.3 * torch.randn((b, c), generator=gen, device=dev)
                shift = 0.3 * torch.randn((b, c), generator=gen, device=dev)
            args = (x, alpha, act, scale, shift)
            ref_args = (x.float(), alpha, act, scale, shift)
        else:
            x = torch.randn(xshape, generator=gen, device=dev).bfloat16()
            if extra:  # per-sample weights
                wshape = (xshape[0],) + wshape
            fan_in = wshape[-4] * wshape[-1] ** 3
            w = (torch.randn(wshape, generator=gen, device=dev)
                 / fan_in ** 0.5).bfloat16()
            bias = 0.1 * torch.randn((wshape[-5],), generator=gen, device=dev)
            args = (x, w, bias)
            ref_args = (x.float(), w.float(), bias)
        got = kernel(*args)
        ref = plain(*ref_args)
        torch.cuda.synchronize()
        check(got.shape == ref.shape, f"{family} {site}: shape {tuple(got.shape)} "
              f"vs {tuple(ref.shape)}")
        err = (got.float() - ref).abs().max().item()
        scale_ref = ref.abs().max().item()
        ms = median_ms(lambda: kernel(*args))
        plain_ms = median_ms(lambda: plain(*args))
        print(f"{family:9s} {site:26s} {str(list(xshape)):22s} {err:11.3e} "
              f"{err / scale_ref:9.2e} {ms:9.3f} {plain_ms:9.3f}")
        check(bool(torch.isfinite(got).all()), f"{family} {site}: non-finite")
        check(err <= KERNEL_TOL * scale_ref,
              f"{family} {site}: max error {err} > {KERNEL_TOL} * {scale_ref}")
        entry = summary.setdefault(family, {"max_abs_err": 0.0, "ms": 0.0,
                                            "plain_ms": 0.0})
        entry["max_abs_err"] = max(entry["max_abs_err"], err)
        entry["ms"] += ms
        entry["plain_ms"] += plain_ms


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
    for family in ops.FAMILIES:
        check(launches.get(family, 0) > 0, f"{family}: no kernel launch")
    check(sum(plain_cuda.values()) == 0, f"plain versions ran on the GPU: {plain_cuda}")

    args = _args(batch, "cuda")
    with torch.inference_mode():
        fwd_ms = median_ms(lambda: model(*args, with_projections=False), reps=10)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"forward b=2 128^3: median {fwd_ms:.2f} ms ({fwd_ms / 2:.2f} ms/volume); "
          f"peak memory {peak:.2f} GiB")
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
    launches = phase_serving()
    kernels = []
    for family, (name, source, replaces) in SOURCES.items():
        entry = summary[family]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces,
                        "launches": launches.get(family, 0),
                        "max_abs_err": entry["max_abs_err"],
                        "ms": round(entry["ms"], 4),
                        "plain_ms": round(entry["plain_ms"], 4)})
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
