#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA Hopper GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --parity-seeds N   # phases 1, 2 and 8 alone, at
                                             # seeds 0 .. N-1

Phases (each prints its own lines; any failure raises and exits non-zero):
  1. device:  nvidia-smi's name and power limit, torch and CUDA versions;
              the card must be compute capability 9.0.
  2. build:   compiles the hand-written kernels (coma_unet_tpu_torch/csrc),
              one nvcc per source in parallel, into build/coma_unet_tpu_torch/;
              prints ptxas's registers and spills per kernel, and counts the
              HMMA (tensor-core) instructions of each instantiation of the
              tensor-core kernels, K1's, K2's, KB1's and KB2's, in
              `cuobjdump -sass` of the library: each must have some.
  3. kernels: each kernel on bf16 inputs at the shapes the 128^3 b=2 serving
              forward and train step and the 216^3 template-space path give
              it -- the forward kernels K1-K4, the weight gradients KB1/KB2,
              the norm backward KB3, the entries `instance_norm` (K4) and
              `conv3d_w64` (K1), and the H-parity split KS -- against its
              plain PyTorch version on the same inputs upcast to f32 (TF32
              off), bf16 outputs within KERNEL_TOL and f32 outputs within
              F32_TOL of max|plain|, KS bit for bit; times the kernel, the
              plain version on the kernel's own inputs and, where one
              PyTorch call computes the same function, that call (CUDA
              events), and computes each case's bound: the larger of its
              bytes over 3.35 TB/s and its operations over the H100's peak
              for their type (bf16 tensor cores for the convs, f32 for the
              norms). K1 also runs at the input-gradient shapes of the wide
              sites and of one narrow one (the cotangent through flip_t(w),
              library: cuDNN's dgrad), K2 at up0's input-gradient shapes
              (`conv3d_s2_dx`: the cotangent through flip_t(w); library:
              PyTorch's stride-2 conv on flip_t(w)) and at odd sizes off the
              path, KB2 also at odd sizes and channel counts off the path
              (shared weights). K1, K2, KB1 and KB2 cases run twice and
              must be bit-identical; each prints the cut `s1_plan`,
              `s2_plan`, `dw_plan` or `sdw_plan` chose, and each KB2 case
              its TFLOP/s and the share of its byte bound.
  4. parity:  the full-width flagship at 64^3, b=2, random weights from a
              seed, run on the GPU through the kernels in bf16 and on the CPU
              in f32 through the plain versions; relative L2 error of `out`.
  5. gradients: one train-step loss and backward of the same model on the
              GPU (kernels, bf16), on the CPU in f32 and on the CPU in bf16
              (plain versions; the rounding baseline): the loss difference
              and, per module group, the relative L2 error of the gradients,
              which may reach GRAD_RATIO x the bf16 route's. Every parameter
              with a CPU gradient must get a finite one on the GPU. At b=2,
              then at b=3, where RnC's loss must be non-zero, so its
              gradient reaches the projection heads and, through K2's
              input-gradient role, the encoder.
  6. serving: the default ModelConfig at 128^3: three b=2 full-volume
              requests through `make_infer_fn` and one 216^3 sliding-window
              request; every forward kernel family must have launched and no
              plain version may have run on the GPU. Then the median b=2
              forward.
  7. training: the default ModelConfig at 128^3, b=2, `LossConfig()`,
              AdamW(1e-3): six steps of `make_train_step` on one batch; the
              losses must be finite and fall, all seven kernel families of
              the path must have launched and no plain version may have run
              on the GPU. Then the median step time, the peak memory and a
              torch.profiler top-10 of device time for one more step.
  8. template parity: the full-width template-space model at 88^3, b=1
              (88 mod 32 = 24, the edge tiles of 216; levels 88 -> 44 -> 22
              -> 11 -> 6, so the up 6 -> 12 is cropped to 11), GPU kernels
              in bf16 against the CPU in f32, as phase 4, within
              max(PARITY_RATIO x the plain bf16 CPU route's error,
              PARITY_TOL).
  9. template space: `ExperimentConfig(data=DataConfig(template_space=True),
              loss=LossConfig(roi_weight=1.0)).normalized()` at 216^3 with
              the 8 template ROIs: the median b=1 forward of `make_infer_fn`;
              `make_eval_step` at b=2, whose voxel and ROI metrics must match
              the same metrics computed on the CPU in f64 from the card's
              `pred` within METRIC_TOL, SSIM inside [-1, 1]; four b=1 train
              steps, whose losses must be finite and fall with RnC at its
              n<2 guard and every parameter outside the projection heads
              given a finite gradient. The eval and train steps are the
              slice's main path: every kernel family of the path must launch
              there and no plain version may run on the GPU. Then the peak
              memory and a torch.profiler top-10 for one train step.
The last two lines are a JSON summary of the kernels (`launches` from the
template-space path, phase 9; `launches_by_path` for every path) and
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
PARITY_RATIO = 1.1    # phase 8 may reach max(PARITY_RATIO x the plain bf16 route's, PARITY_TOL):
                      # the kernels read 0.998-1.009x it at three seeds with either K1
                      # kernel; one tap left out of the tensor-core K1 reads 11.5x
LOSS_TOL = 1e-2       # relative loss difference, bf16 GPU step vs f32 CPU step
GRAD_RATIO = 1.25     # a group's gradient error may reach max(GRAD_RATIO x the plain bf16
GRAD_FLOOR = 2e-2     # route's, GRAD_FLOOR): sound kernels read <= 1.14x over four seeds
                      # and targets, half the batch left out of one KB1 call >= 1.44x
METRIC_TOL = 1e-4     # |card - cpu f64| <= METRIC_TOL * |cpu f64| (+ 1e-6 of the key's max)
DEVICE = "cuda"       # every phase runs on the card; there is no CPU path
TRAIN_STEPS = 6
TEMPLATE_STEPS = 4
PEAK_BF16 = 989e12    # H100 SXM dense bf16 tensor-core FLOP/s
PEAK_F32 = 67e12      # H100 SXM f32 FLOP/s outside the tensor cores
HBM_BYTES = 3.35e12   # H100 SXM device memory bytes/s
# the tensor-core kernels, K1 (csrc/conv3d_s1_tc.cu), K2 (csrc/conv3d_s2_tc.cu),
# KB1 (csrc/conv3d_dw_tc.cu) and KB2 (csrc/conv3d_dw_s2_tc.cu)
TC_KERNELS = ("conv3d_s1_tc_kernel", "conv3d_s2_tc_kernel", "conv3d_dw_tc_kernel",
              "conv3d_dw_s2_tc_kernel")
SOURCES = {
    "s1": ("conv3d_s1", "coma_unet_tpu_torch/csrc/conv3d_s1_tc.cu",
           "coma_unet_tpu/ops/pallas/conv3d_p1.py:231 _p1_fwd; "
           "conv3d.py:260 _pallas_conv3d_fwd; conv3d.py:187 "
           "_pallas_conv3d_fwd_htiled; conv3d_packed.py:105 _packed_fwd; "
           "conv3d_packed.py:264 pallas_conv3d_w64"),
    "s2": ("conv3d_s2", "coma_unet_tpu_torch/csrc/conv3d_s2_tc.cu",
           "coma_unet_tpu/ops/pallas/conv3d_strided.py:299 _s2_fwd_v2; "
           ":136 _s2_fwd_v1; phase_split.py:86 pallas_hwsplit"),
    "t2": ("conv3d_t2", "coma_unet_tpu_torch/csrc/conv3d_strided.cu",
           "coma_unet_tpu/ops/pallas/conv3d_strided.py:444 _t2_fwd_v1; "
           ":730 _t2_fwd_v2"),
    "norm_act": ("norm_act", "coma_unet_tpu_torch/csrc/norm_act.cu",
                 "coma_unet_tpu/ops/pallas/norm_act.py:185 _norm_act_fwd_impl; "
                 "instance_norm.py:59 pallas_instance_norm"),
    "s1_dw": ("conv3d_s1_dw", "coma_unet_tpu_torch/csrc/conv3d_dw_tc.cu",
              "coma_unet_tpu/ops/pallas/conv3d.py:586 _pallas_conv3d_dw; "
              "conv3d.py:516 _pallas_conv3d_dw_htiled; "
              "conv3d_p1.py:319 _p1_dw; conv3d_packed.py:195 _packed_dw"),
    "strided_dw": ("conv3d_strided_dw", "coma_unet_tpu_torch/csrc/conv3d_dw_s2_tc.cu",
                   "coma_unet_tpu/ops/pallas/conv3d_strided.py:579 _dw_dil_v1; "
                   ":830 _dw_v2"),
    "norm_act_bwd": ("norm_act_bwd", "coma_unet_tpu_torch/csrc/norm_act.cu",
                     "coma_unet_tpu/ops/pallas/norm_act.py:220 _norm_act_bwd_impl"),
    "phase_split": ("hsplit", "coma_unet_tpu_torch/csrc/phase_split.cu",
                    "coma_unet_tpu/ops/pallas/phase_split.py:65 pallas_hsplit"),
}
# kernels whose device time the profile prints by name, in or below its top
# 8: K2, KB2, K1's (and K2's) weight packing and KB1/KB2's split-K sum
SMALL_KERNELS = ("conv3d_s2_tc_kernel", "conv3d_dw_s2_tc_kernel", "s1_pack_weights",
                 "dw_reduce_kernel")


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
    lib = _build.build()
    _build.library()
    print(f"build: {time.perf_counter() - t0:.1f} s -> {_build.BUILD_DIR}")
    log = _build.BUILD_DIR / "build.log"
    if log.is_file():
        name = ""
        for line in log.read_text().splitlines():
            if "Compiling entry function" in line:
                name = _kernel_name(line.split("'")[1] if "'" in line else line)
            elif "registers" in line or "spill" in line:
                print(f"  ptxas: {name}: {line.split(':', 1)[-1].strip()}")
    for kernel in TC_KERNELS:
        hmma = sass_hmma(lib, kernel)
        print(f"HMMA instructions per {kernel} instantiation (cuobjdump -sass): "
              f"{json.dumps({_kernel_name(k): n for k, n in hmma.items()})}")
        check(len(hmma) > 0, f"no {kernel} in the library")
        check(all(n > 0 for n in hmma.values()), f"{kernel} without HMMA: {hmma}")


def _kernel_name(mangled: str) -> str:
    """A kernel's mangled name from its own name on, with its template
    arguments (`conv3d_dw_tc_kernelILi3ELi16ELi32ELi8E...`): the prefix that
    names the source file's anonymous namespace is dropped."""
    import re

    m = re.search(r"_[0-9a-f]{8}(\d+)(\w+)$", mangled)
    return m.group(2)[:int(m.group(1)) + 24] if m else mangled


def sass_hmma(lib, kernel: str) -> dict:
    """The number of HMMA instructions in each function of `lib` whose
    (mangled) name contains `kernel`, from `cuobjdump -sass`."""
    import shutil
    from pathlib import Path

    from torch.utils.cpp_extension import CUDA_HOME

    tool = Path(CUDA_HOME or "/usr/local/cuda") / "bin" / "cuobjdump"
    tool = str(tool) if tool.is_file() else shutil.which("cuobjdump")
    check(tool is not None, "cuobjdump not found")
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            if kernel in name:
                counts[name] = 0
        elif name in counts and "HMMA" in line:
            counts[name] += 1
    return counts


def _kernel_cases():
    """(family, site, input shape, weight shape or None, extra, entry) at
    the shapes of the 128^3 b=2 serving forward and train step and of the
    216^3 b=1 template-space path; `entry` names a standalone entry point
    (`instance_norm`, `conv3d_w64`, `hsplit`), is "dx" for K1 or K2 as an
    input gradient (input: the cotangent; weights: the forward layer's), or
    is None for the family's own wrapper."""
    v0, v1 = (128,) * 3, (64,) * 3
    t0, t1 = (216,) * 3, (108,) * 3
    s1 = [  # (site, batch, Cin, Cout, k, per_sample, spatial)
        ("head.conv0", 2, 1, 32, 3, True, v0), ("head.conv1", 2, 32, 32, 3, True, v0),
        ("merge0", 2, 64, 32, 3, False, v0),
        ("deep_modulator_3c.conv0", 2, 3, 16, 3, False, v0),
        ("deep_modulator_3c.conv1", 2, 16, 16, 3, False, v0),
        ("deep_modulator_3c.conv2", 2, 16, 1, 3, False, v0),
        ("fusion_layer.conv0", 2, 2, 8, 3, False, v0),
        ("fusion_layer.conv1", 2, 8, 8, 3, False, v0),
        ("fusion_layer.conv2", 2, 8, 1, 3, False, v0),
        ("gate0.W_g", 2, 32, 16, 1, False, v0), ("gate0.psi", 2, 16, 1, 1, False, v0),
        ("reduce", 2, 32, 1, 1, True, v0), ("final_pred_head", 2, 2, 1, 1, False, v0),
        ("down0.conv1", 2, 64, 64, 3, True, v1), ("merge1", 2, 128, 64, 3, False, v1),
        ("gate1.W_g", 2, 64, 32, 1, False, v1), ("gate1.psi", 2, 32, 1, 1, False, v1),
        # the template-space path at 216^3 (rows #3 and #5: H, W = 216 give
        # edge tiles of 24 in K1's 32 x 32 tile)
        ("216 head.conv1", 1, 32, 32, 3, True, t0), ("216 merge0", 1, 64, 32, 3, False, t0),
        ("216 deep_modulator_3c.conv1", 1, 16, 16, 3, False, t0),
        ("216 gate0.psi", 1, 16, 1, 1, False, t0),
        ("216 down0.conv1", 1, 64, 64, 3, True, t1), ("216 merge1", 1, 128, 64, 3, False, t1),
    ]
    cases = [("s1", site, (b, ci) + sp, (co, ci, k, k, k), ps, None)
             for site, b, ci, co, k, ps, sp in s1]
    cases.append(("s1", "conv3d_w64 64->64", (2, 64, 64, 64, 64),
                  (64, 64, 3, 3, 3), False, "conv3d_w64"))
    # K1 as the input gradient (Conv3dS1.backward: the cotangent [B, Cout,
    # ...] through flip_t(w), Cout -> Cin) at the wide sites and one narrow
    dx = [("head.conv1", 2, 32, 32, True, v0), ("merge0", 2, 64, 32, False, v0),
          ("deep_modulator_3c.conv2", 2, 16, 1, False, v0),
          ("down0.conv1", 2, 64, 64, True, v1), ("merge1", 2, 128, 64, False, v1),
          ("216 head.conv1", 1, 32, 32, True, t0), ("216 merge0", 1, 64, 32, False, t0),
          ("216 down0.conv1", 1, 64, 64, True, t1), ("216 merge1", 1, 128, 64, False, t1)]
    cases += [("s1", f"{site} dx {co}->{ci}", (b, co) + sp, (co, ci, 3, 3, 3), ps, "dx")
              for site, b, ci, co, ps, sp in dx]
    cases.append(("s2", "down0.conv0", (2, 32) + v0, (64, 32, 3, 3, 3), True, None))
    cases.append(("s2", "216 down0.conv0", (1, 32) + t0, (64, 32, 3, 3, 3), True, None))
    cases.append(("s2", "216 b=2 down0.conv0 (eval)", (2, 32) + t0, (64, 32, 3, 3, 3), True,
                  None))
    # K2 as up0's input gradient (Conv3dT2.backward: the cotangent [B, 32,
    # ...] through flip_t of up0's per-sample [B, 32, 64, 3^3], 32 -> 64), and
    # odd sizes off the path, whose masks and zero-padded chunk and output
    # tile it exercises
    cases.append(("s2", "up0 dx 32->64", (2, 32) + v0, (32, 64, 3, 3, 3), True, "dx"))
    cases.append(("s2", "216 up0 dx 32->64", (1, 32) + t0, (32, 64, 3, 3, 3), True, "dx"))
    cases.append(("s2", "odd sizes 24->40", (2, 24, 27, 18, 45), (40, 24, 3, 3, 3), True,
                  None))
    cases.append(("t2", "up0", (2, 64) + v1, (32, 64, 3, 3, 3), True, None))
    cases.append(("t2", "216 up0", (1, 64) + t1, (32, 64, 3, 3, 3), True, None))
    # KB1: x [B, Cin, ...] and the output cotangent [B, Cout, ...]; the path's
    # sites, and two off the path whose odd W takes the scalar loads and
    # whose channel counts pad both channel tiles
    odd = [("odd W k=3 (scalar loads)", 2, 24, 40, 3, True, (10, 9, 27)),
           ("odd W k=1 (scalar loads)", 1, 40, 20, 1, False, (5, 6, 45))]
    cases += [("s1_dw", site, (b, ci) + sp, (co, k), ps, None)
              for site, b, ci, co, k, ps, sp in s1 + odd]
    # KB2: full [B, 32, D^3], half [B, 64, (D/2)^3] in both roles; and odd
    # sizes off the path, whose scalar loads, masked bricks and zero-padded
    # channel tiles (24 of 32 of full, 40 of 64 of half) it exercises, with
    # shared weights (the split-K sum over the batch)
    for b, full, half, tag in ((2, v0, v1, ""), (1, t0, t1, "216 ")):
        cases.append(("strided_dw", f"{tag}down0.conv0 (s2: full=x, half=g)",
                      (b, 32) + full, (b, 64) + half, True, None))
        cases.append(("strided_dw", f"{tag}up0 (t2: full=g, half=x)",
                      (b, 32) + full, (b, 64) + half, True, None))
    cases.append(("strided_dw", "odd sizes 24, 40 (shared)", (2, 24, 27, 18, 45),
                  (2, 40, 14, 9, 23), False, None))
    norms = [("head.conv1", 2, 32, "relu", True, v0),
             ("merge0", 2, 32, "prelu", False, v0),
             ("deep_modulator_3c.conv0", 2, 16, "leakyrelu", False, v0),
             ("gate0.psi", 2, 1, "none", False, v0),
             ("final_pred_head", 2, 1, "prelu", False, v0),
             ("down0.conv1", 2, 64, "relu", True, v1),
             ("216 head.conv1", 1, 32, "relu", True, t0)]
    for family in ("norm_act", "norm_act_bwd"):
        cases += [(family, site, (b, c) + sp, None, (act, film), None)
                  for site, b, c, act, film, sp in norms]
    cases += [("norm_act", f"instance_norm {act} 216", (1, 32) + t0, None,
               (act, False), "instance_norm")
              for act in ("none", "relu", "leakyrelu")]
    cases.append(("phase_split", "hsplit 216", (1, 32) + t0, None, None, "hsplit"))
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


def _voxels(shape) -> int:
    return int(np.prod(shape[2:]))


def _case_calls(family, xshape, wshape, extra, entry, gen, dev):
    """One phase-3 case: a dict with the kernel call, the plain call on the
    f32 upcast inputs (`ref`), the plain call on the kernel's own inputs,
    the one PyTorch call that computes the same function (`library`, or
    None), the inputs, and the operations and their peak rate for the
    bound. Each call returns a tensor or a tuple of tensors."""
    import torch.nn.functional as F

    from coma_unet_tpu_torch import ops
    from coma_unet_tpu_torch.ops.conv3d import (
        conv3d_s1_dx,
        conv3d_weight_ref,
        flip_t,
        s1_plan,
    )
    from coma_unet_tpu_torch.ops.conv3d_strided import conv3d_s2_dx, s2_plan

    def randn(shape):
        return torch.randn(shape, generator=gen, device=dev).bfloat16()

    if family == "phase_split":
        x = randn(xshape)
        return dict(kernel=lambda: ops.hsplit(x), ref=lambda: ops.hsplit_plain(x),
                    plain=lambda: ops.hsplit_plain(x), library=None, inputs=(x,),
                    ops=0, rate=PEAK_F32)
    if family == "norm_act":
        x, alpha, scale, shift = _norm_inputs(xshape, *extra, gen, dev)
        act = extra[0]
        common = dict(inputs=(x,), ops=8 * x.numel(), rate=PEAK_F32)
        if entry == "instance_norm":
            return dict(kernel=lambda: ops.instance_norm(x, act=act),
                        ref=lambda: ops.norm_act_plain(x.float(), None, act),
                        plain=lambda: ops.norm_act_plain(x, None, act),
                        library=(lambda: F.instance_norm(x)) if act == "none" else None,
                        **common)
        return dict(kernel=lambda: ops.norm_act(x, alpha, act, scale, shift),
                    ref=lambda: ops.norm_act_plain(x.float(), alpha, act, scale, shift),
                    plain=lambda: ops.norm_act_plain(x, alpha, act, scale, shift),
                    library=None, **common)
    if family == "norm_act_bwd":
        x, alpha, scale, shift = _norm_inputs(xshape, *extra, gen, dev)
        act = extra[0]
        g = randn(xshape)
        _, stats = ops.norm_act_forward(x, alpha, act, scale, shift)
        return dict(kernel=lambda: ops.norm_act_bwd(x, g, stats, alpha, act, scale, shift),
                    ref=lambda: ops.norm_act_bwd_plain(x.float(), g.float(), alpha, act,
                                                       scale, shift),
                    plain=lambda: ops.norm_act_bwd_plain(x, g, alpha, act, scale, shift),
                    library=None, inputs=(x, g), ops=14 * x.numel(), rate=PEAK_F32)
    if family == "s1_dw":
        from coma_unet_tpu_torch.ops.conv3d import dw_plan

        (co, k), ps = wshape, extra
        b, ci = xshape[:2]
        x, g = randn(xshape), randn((b, co) + xshape[2:])
        flops = 2 * b * co * ci * k ** 3 * _voxels(xshape)
        return dict(kernel=lambda: ops.conv3d_s1_dw(x, g, k, ps),
                    ref=lambda: ops.conv3d_s1_dw_plain(x.float(), g.float(), k, ps),
                    plain=lambda: ops.conv3d_s1_dw_plain(x, g, k, ps),
                    library=lambda: conv3d_weight_ref(x, g, k, ps), inputs=(x, g),
                    ops=flops, rate=PEAK_BF16, plan=dw_plan(b, ci, co, *xshape[2:], k))
    if family == "strided_dw":
        from coma_unet_tpu_torch.ops.conv3d_strided import sdw_plan

        full, half = randn(xshape), randn(wshape)
        flops = 2 * xshape[0] * wshape[1] * xshape[1] * 27 * _voxels(wshape)
        return dict(kernel=lambda: ops.conv3d_strided_dw(full, half, extra),
                    ref=lambda: ops.conv3d_strided_dw_plain(full.float(), half.float(),
                                                            extra),
                    plain=lambda: ops.conv3d_strided_dw_plain(full, half, extra),
                    library=lambda: conv3d_weight_ref(full, half, 3, extra, 2),
                    inputs=(full, half), ops=flops, rate=PEAK_BF16,
                    plan=sdw_plan(xshape[0], xshape[1], wshape[1], *xshape[2:]))
    kernel, plain = {"s1": (ops.conv3d_s1, ops.conv3d_s1_plain),
                     "s2": (ops.conv3d_s2, ops.conv3d_s2_plain),
                     "t2": (ops.conv3d_t2, ops.conv3d_t2_plain)}[family]
    x = randn(xshape)
    if extra:  # per-sample weights
        wshape = (xshape[0],) + wshape
    fan_in = wshape[-4] * wshape[-1] ** 3
    w = (torch.randn(wshape, generator=gen, device=dev) / fan_in ** 0.5).bfloat16()
    bias = 0.1 * torch.randn((wshape[-5],), generator=gen, device=dev)
    # the plain version of a forward conv is PyTorch's built-in conv: the
    # library call and the plain version on the kernel's inputs are one call
    library = "plain"
    if entry == "conv3d_w64":
        call, bias = (lambda: ops.conv3d_w64(x, w)), None
    elif entry == "dx" and family == "s2":  # the stride-2 conv of g on flip_t(wf)
        wf, w, bias = w, flip_t(w), None
        call = lambda: conv3d_s2_dx(x, wf)  # noqa: E731
    elif entry == "dx":  # x is the cotangent, wf the forward weights
        wf, w, bias = w, flip_t(w), None
        call = lambda: conv3d_s1_dx(x, wf)  # noqa: E731
        library = lambda: _conv3d_input_ref(wf, x)  # noqa: E731  (cuDNN's dgrad)
    else:
        call = lambda: kernel(x, w, bias)  # noqa: E731
    # output positions: the stride-2 grid for s2; every input position feeds
    # one output per tap for t2 and s1
    positions = (int(np.prod([(n - 1) // 2 + 1 for n in xshape[2:]])) if family == "s2"
                 else _voxels(xshape))
    flops = 2 * xshape[0] * wshape[-5] * wshape[-4] * wshape[-1] ** 3 * positions
    case = dict(kernel=call, ref=lambda: plain(x.float(), w.float(), bias),
                plain=lambda: plain(x, w, bias), library=library,
                inputs=(x, w) + (() if bias is None else (bias,)),
                ops=flops, rate=PEAK_BF16)
    if family == "s1":
        case["plan"] = s1_plan(xshape[0], xshape[1], w.shape[-5], *xshape[2:], w.shape[-1],
                               bool(extra))
    elif family == "s2":
        case["plan"] = s2_plan(xshape[0], xshape[1], w.shape[-5], *xshape[2:], bool(extra))
    return case


def _conv3d_input_ref(w: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The input gradient of the stride-1 SAME conv with weights w (shared
    or per sample) for the output cotangent g, through PyTorch's built-in
    (cuDNN's dgrad)."""
    k = w.shape[-1]
    if w.dim() == 6:
        b, co, ci = w.shape[:3]
        dx = torch.nn.grad.conv3d_input(
            (1, b * ci) + tuple(g.shape[2:]), w.reshape((b * co, ci) + w.shape[3:]),
            g.reshape((1, b * co) + g.shape[2:]), padding=k // 2, groups=b)
        return dx.reshape((b, ci) + g.shape[2:])
    return torch.nn.grad.conv3d_input((g.shape[0], w.shape[1]) + tuple(g.shape[2:]), w, g,
                                      padding=k // 2)


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound_ms(ops_count: float, rate: float, nbytes: int):
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over the peak rate for their type."""
    t_ops, t_bytes = ops_count / rate, nbytes / HBM_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops > t_bytes else "bytes")


def _conv_checks(case: dict, got: torch.Tensor, kernel: str, site: str) -> str:
    """K1 or K2 at one site: a second call must be bit-identical to the
    first. Returns a line with the cut `s1_plan` or `s2_plan` chose."""
    again = case["kernel"]()
    check(bool(torch.equal(again, got)), f"{kernel} {site}: two calls differ")
    plan = case["plan"]
    return (f"  {kernel} {site}: brick={plan.brick} ct={plan.ct} at={plan.at} "
            f"grid={plan.grid}; two calls bit-identical")


def _dw_checks(case: dict, got: torch.Tensor, kernel: str, site: str) -> str:
    """KB1 or KB2 at one site: a second call must be bit-identical to the
    first. Returns a line with the cut `dw_plan` or `sdw_plan` chose."""
    again = case["kernel"]()
    check(bool(torch.equal(again, got)), f"{kernel} {site}: two calls differ")
    plan = case["plan"]
    return (f"  {kernel} {site}: brick={plan.brick} ct={plan.ct} at={plan.at} "
            f"bricks/split={plan.bps} splits={plan.splits}; two calls bit-identical")


def phase_kernels(summary: dict) -> None:
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    dev = torch.device(DEVICE)
    # rel: max error over max|plain| of the bf16 outputs and of the f32 ones
    print(f"{'family':12s} {'site':34s} {'input':24s} {'max_abs_err':>11s} "
          f"{'rel bf16':>9s} {'rel f32':>9s} {'ms':>9s} {'plain_ms':>9s} "
          f"{'lib_ms':>9s} {'bound_ms':>9s} bound_by")
    for family, site, xshape, wshape, extra, entry in _kernel_cases():
        case = _case_calls(family, xshape, wshape, extra, entry, gen, dev)
        exact = family == "phase_split"
        with torch.no_grad():
            got, ref = case["kernel"](), case["ref"]()
            torch.cuda.synchronize()
            got = got if isinstance(got, tuple) else (got,)
            ref = ref if isinstance(ref, tuple) else (ref,)
            err, rel = 0.0, {torch.bfloat16: None, torch.float32: None}
            for a, r in zip(got, ref):
                check(a.shape == r.shape, f"{family} {site}: shape "
                      f"{tuple(a.shape)} vs {tuple(r.shape)}")
                check(a.dtype in rel, f"{family} {site}: output dtype {a.dtype}")
                check(bool(torch.isfinite(a).all()), f"{family} {site}: non-finite")
                if exact:
                    check(a.dtype == r.dtype and bool(torch.equal(a, r)),
                          f"{family} {site}: not bit-equal to the plain version")
                tol = KERNEL_TOL if a.dtype == torch.bfloat16 else F32_TOL
                e = (a.float() - r.float()).abs().max().item()
                scale_ref = r.abs().max().item()
                check(e <= tol * scale_ref or e == 0.0,
                      f"{family} {site}: {a.dtype} max error {e} > {tol} * {scale_ref}")
                err = max(err, e)
                rel[a.dtype] = max(rel[a.dtype] or 0.0, e / scale_ref if scale_ref else 0.0)
            note = None
            if family in ("s1_dw", "strided_dw"):
                note = _dw_checks(case, got[0], {"s1_dw": "KB1", "strided_dw": "KB2"}[family],
                                  site)
            elif family in ("s1", "s2"):
                note = _conv_checks(case, got[0], {"s1": "K1", "s2": "K2"}[family], site)
            ms = median_ms(case["kernel"])
            plain_ms = median_ms(case["plain"])
            library = case["library"]
            lib_ms = (plain_ms if library == "plain"
                      else median_ms(library) if library else None)
        nbytes = _nbytes(case["inputs"]) + _nbytes(got)
        b_ms, b_by = bound_ms(case["ops"], case["rate"], nbytes)
        if family == "strided_dw":
            note += (f"; {case['ops'] / ms / 1e9:.1f} TFLOP/s, "
                     f"{1e3 * nbytes / HBM_BYTES / ms:.1%} of its byte bound")
        del got, ref, case
        cols = [f"{v:9.2e}" if v is not None else f"{'-':>9s}" for v in rel.values()]
        cols.append(f"{ms:9.3f} {plain_ms:9.3f}")
        cols.append(f"{lib_ms:9.3f}" if lib_ms is not None else f"{'-':>9s}")
        cols.append(f"{b_ms:9.3f} {b_by}")
        print(f"{family:12s} {site:34s} {str(list(xshape)):24s} {err:11.3e} "
              + " ".join(cols))
        if note:
            print(note)
        entry_sum = summary.setdefault(family, {
            "max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
            "library_ms": 0.0, "library_all": True, "operations": 0.0,
            "bytes": 0.0})
        entry_sum["max_abs_err"] = max(entry_sum["max_abs_err"], err)
        entry_sum["ms"] += ms
        entry_sum["plain_ms"] += plain_ms
        entry_sum["bound_ms"] += b_ms
        entry_sum[b_by] += b_ms   # which limit carries the family's bound
        if lib_ms is None:
            entry_sum["library_all"] = False
        else:
            entry_sum["library_ms"] += lib_ms


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


def phase_parity(s: int = 64, b: int = 2, template: bool = False, seed: int = 0) -> float:
    """The full-width model at s^3, batch b, on the GPU through the kernels
    in bf16 against the CPU in f32 through the plain versions; weights from
    `seed`, inputs from `seed + 1`. `template` builds the template-space
    configuration (prompts at s^3, 8 ROIs) and holds it to
    max(PARITY_RATIO x the plain bf16 route's error, PARITY_TOL); otherwise
    the limit is PARITY_TOL."""
    import dataclasses

    from coma_unet_tpu_torch import (
        ContraAttnUNet,
        DataConfig,
        ExperimentConfig,
        ModelConfig,
        TEMPLATE_ROI_INDICES,
    )

    cfg = ModelConfig(prompt_shape=(s, s, s))
    r = 36
    if template:
        cfg = ExperimentConfig(data=DataConfig(
            template_space=True, volume_shape=(s, s, s))).normalized().model
        r = len(TEMPLATE_ROI_INDICES)
    check(tuple(cfg.prompt_shape) == (s, s, s), f"prompts {cfg.prompt_shape}")
    cpu_cfg = dataclasses.replace(cfg, compute_dtype="float32")
    gen = torch.Generator().manual_seed(seed)
    ref_model = ContraAttnUNet(cpu_cfg, device="cpu", generator=gen).eval()
    with torch.no_grad():  # FiLM starts at zero: give it and the routing signal
        for name, p in ref_model.named_parameters():
            if ".film." in name or ".route." in name:
                p.add_(0.5 * torch.randn(p.shape, generator=gen))
    gpu_model = ContraAttnUNet(cfg, device=DEVICE).eval()
    gpu_model.load_state_dict(ref_model.state_dict())
    # the same bf16 forward through the plain versions on the CPU: the share
    # of the error that bf16 rounding alone explains
    bf16_model = ContraAttnUNet(cfg, device="cpu").eval()
    bf16_model.load_state_dict(ref_model.state_dict())
    batch = _batch(np.random.default_rng(seed + 1), b=b, s=s, r=r)
    batch["covars"][:, 0] = [1.0, 0.0][:b]  # abeta+ and abeta- prompts
    t0 = time.perf_counter()
    with torch.inference_mode():
        got = gpu_model(*_args(batch, DEVICE), with_projections=False).out.cpu()
        gpu_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        ref = ref_model(*_args(batch, "cpu"), with_projections=False).out
        cpu_s = time.perf_counter() - t0
        plain_bf16 = bf16_model(*_args(batch, "cpu"), with_projections=False).out

    def rel_l2(a, b):
        return (torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b)).item()

    rel, base = rel_l2(got, ref), rel_l2(plain_bf16, ref)
    limit = max(PARITY_RATIO * base, PARITY_TOL) if template else PARITY_TOL
    check(tuple(got.shape) == (b, 1, s, s, s), f"parity: out {tuple(got.shape)}")
    print(f"parity {s}^3 b={b}{' template' if template else ''} seed {seed}: rel L2(out) = "
          f"{rel:.4e} (limit {limit:.4e}); plain bf16 on CPU vs f32: {base:.4e} "
          f"(ratio {rel / base:.4f}); kernels vs plain bf16: {rel_l2(got, plain_bf16):.4e}; "
          f"max|ref| {ref.abs().max().item():.4f}; gpu {gpu_s:.2f} s, cpu f32 {cpu_s:.1f} s")
    check(bool(torch.isfinite(got).all()), "parity: non-finite GPU output")
    check(rel <= limit, f"parity: rel L2 {rel} > {limit}")
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
    total, metrics = make_loss_fn(model, LossConfig())(tb, roi_w)
    total.backward()
    loss = float(total.detach())
    grads = {n: None if p.grad is None else p.grad.detach().float().cpu()
             for n, p in model.named_parameters()}
    return loss, float(metrics["tcds_loss"]), grads, time.perf_counter() - t0


def phase_gradients(b: int = 2) -> None:
    """Phase 5 at batch b: at b=2 RnC is identically 0 (one pair, ranked
    against itself); at b >= 3 it must be non-zero on every route."""
    import dataclasses

    from coma_unet_tpu_torch import ContraAttnUNet, ModelConfig

    s = 64
    cfg = ModelConfig(prompt_shape=(s, s, s))
    gen = torch.Generator().manual_seed(0)
    ref_model = ContraAttnUNet(dataclasses.replace(cfg, compute_dtype="float32"),
                               device="cpu", generator=gen)
    with torch.no_grad():  # FiLM starts at zero: give it and the routing signal
        for name, p in ref_model.named_parameters():
            if ".film." in name or ".route." in name:
                p.add_(0.5 * torch.randn(p.shape, generator=gen))
    gpu_model = ContraAttnUNet(cfg, device="cuda")
    gpu_model.load_state_dict(ref_model.state_dict())
    bf16_model = ContraAttnUNet(cfg, device="cpu")
    bf16_model.load_state_dict(ref_model.state_dict())
    batch = _batch(np.random.default_rng(1), b=b, s=s)
    batch["covars"][:, 0] = [1.0, 0.0, 1.0][:b]  # abeta+ and abeta- prompts

    loss_gpu, rnc_gpu, g_gpu, t_gpu = _loss_and_grads(gpu_model, batch, "cuda")
    loss_ref, rnc_ref, g_ref, t_ref = _loss_and_grads(ref_model, batch, "cpu")
    loss_bf, rnc_bf, g_bf, t_bf = _loss_and_grads(bf16_model, batch, "cpu")
    print(f"gradients 64^3 b={b}: loss gpu {loss_gpu:.6f}, cpu f32 {loss_ref:.6f}, "
          f"cpu bf16 {loss_bf:.6f}; RnC gpu {rnc_gpu:.6f}, cpu f32 {rnc_ref:.6f}, "
          f"cpu bf16 {rnc_bf:.6f}; gpu {t_gpu:.2f} s, cpu f32 {t_ref:.1f} s, "
          f"cpu bf16 {t_bf:.1f} s")
    if b >= 3:
        check(all(np.isfinite(v) and v != 0.0 for v in (rnc_gpu, rnc_ref, rnc_bf)),
              f"gradients b={b}: RnC should be non-zero: {rnc_gpu}, {rnc_ref}, {rnc_bf}")
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
    print(f"gradients b={b}: loss rel diff {rel_loss:.3e}; {len(groups)} groups within "
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
    for family in ops.PATH_FAMILIES:
        check(launches.get(family, 0) > 0, f"{family}: no kernel launch in training")
    check(sum(plain_cuda.values()) == 0, f"plain versions ran on the GPU: {plain_cuda}")
    med = statistics.median(step_ms[1:])
    print(f"train step b=2 128^3: median {med:.2f} ms over steps 2-{TRAIN_STEPS} "
          f"({med / 2:.2f} ms/volume); all steps ms {[round(t, 2) for t in step_ms]}; "
          f"peak memory {peak:.2f} GiB")

    profile_step(lambda: step(batch, roi_w))
    return launches


def profile_step(fn) -> None:
    """torch.profiler over one call of `fn`: wall time, summed kernel time,
    the device's idle share and the top 10 kernels by device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
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
    # every instantiation of a kernel together: its name without namespace,
    # template arguments and parameters
    by_name: dict = {}
    for e in kernels:
        name = e.key.replace("(anonymous namespace)::", "").split("(")[0]
        name = name.split("<")[0].split()[-1].split("::")[-1]
        ms, calls = by_name.get(name, (0.0, 0))
        by_name[name] = (ms + device_us(e) / 1e3, calls + e.count)
    top = sorted(by_name.items(), key=lambda kv: kv[1][0], reverse=True)[:8]
    print("  by kernel name: " + "; ".join(
        f"{name} {ms:.3f} ms x{calls} ({ms / total:.1%})" for name, (ms, calls) in top))
    print("  named kernels: " + "; ".join(
        f"{name} {by_name[name][0]:.3f} ms x{by_name[name][1]} "
        f"({by_name[name][0] / total:.2%})" if name in by_name else f"{name} not run"
        for name in SMALL_KERNELS))


def _check_metrics(name: str, got: dict, want: dict) -> float:
    """Every value of `got` (card) within METRIC_TOL of `want` (CPU f64),
    relative, plus 1e-6 of the key's largest value; SSIM, whose range is
    [-1, 1] and whose value between unrelated volumes is near 0, within
    METRIC_TOL absolute. Returns the worst relative error."""
    worst = 0.0
    check(set(got) == set(want), f"{name}: keys {sorted(got)} vs {sorted(want)}")
    for key, ref in want.items():
        a = got[key].double().cpu()
        check(a.shape == ref.shape, f"{name} {key}: shape {tuple(a.shape)}")
        check(bool(torch.isfinite(a).all()), f"{name} {key}: non-finite")
        err = (a - ref).abs()
        floor = METRIC_TOL if key == "ssim" else 1e-6 * float(ref.abs().max())
        check(bool((err <= METRIC_TOL * ref.abs() + floor).all()),
              f"{name} {key}: card vs cpu f64 differ by {float(err.max())}")
        worst = max(worst, float((err / (ref.abs() + floor + 1e-30)).max()))
    return worst


def phase_template() -> dict:
    """The template-space path at 216^3: forward, eval with the metric
    suite, four train steps."""
    from coma_unet_tpu_torch import (
        ContraAttnUNet,
        DataConfig,
        ExperimentConfig,
        LossConfig,
        TEMPLATE_ROI_INDICES,
    )
    from coma_unet_tpu_torch import ops
    from coma_unet_tpu_torch.infer import make_infer_fn
    from coma_unet_tpu_torch.metrics import roi_metrics, voxel_metrics
    from coma_unet_tpu_torch.train import (
        create_train_state,
        make_eval_step,
        make_train_step,
    )

    cfg = ExperimentConfig(data=DataConfig(template_space=True),
                           loss=LossConfig(roi_weight=1.0)).normalized()
    s = cfg.data.volume_shape[0]
    r = len(TEMPLATE_ROI_INDICES)
    check(tuple(cfg.data.volume_shape) == (216,) * 3, f"{cfg.data.volume_shape}")
    check(tuple(cfg.model.prompt_shape) == (s,) * 3, f"{cfg.model.prompt_shape}")
    model = ContraAttnUNet(cfg.model, generator=torch.Generator().manual_seed(0))
    check(next(model.parameters()).device.type == DEVICE,
          "the model did not build on the GPU")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # (a) the b=1 forward through make_infer_fn
    one = _batch(np.random.default_rng(3), b=1, s=s, r=r)
    infer = make_infer_fn(model)
    args = _args(one, DEVICE)
    ops.reset_counts()
    out = infer(*args)
    torch.cuda.synchronize()
    fwd_launches, fwd_plain = dict(ops.LAUNCHES), dict(ops.PLAIN_ON_CUDA)
    check(tuple(out.shape) == (1, 1, s, s, s), f"template out {tuple(out.shape)}")
    check(bool(torch.isfinite(out).all()), "template: non-finite forward")
    for family in ops.FWD_FAMILIES:
        check(fwd_launches.get(family, 0) > 0, f"{family}: no launch in the forward")
    check(sum(fwd_plain.values()) == 0, f"plain versions ran on the GPU: {fwd_plain}")
    fwd_ms = median_ms(lambda: infer(*args), reps=10)
    print(f"template forward b=1 {s}^3: median {fwd_ms:.2f} ms over 10 calls "
          f"(make_infer_fn, CUDA events)")

    two = _batch(np.random.default_rng(4), b=2, s=s, r=r)
    two["covars"][:, 0] = [1.0, 0.0]
    eval_step = make_eval_step(model, r)
    eval_ms = [_timed(lambda: eval_step(two)) for _ in range(4)]

    # the slice's main path: one eval at b=2, then four train steps at b=1
    ops.reset_counts()
    pred, vox, roi = eval_step(two)
    check(tuple(pred.shape) == (2, 1, s, s, s), f"eval pred {tuple(pred.shape)}")
    check(bool(torch.isfinite(pred).all()), "eval: non-finite pred")
    ssim = vox["ssim"].cpu()
    check(bool(((ssim >= -1.0) & (ssim <= 1.0)).all()), f"ssim outside [-1, 1]: {ssim}")
    t0 = time.perf_counter()
    cpu = {k: torch.as_tensor(v) for k, v in two.items()}
    pred64, tau64 = pred.double().cpu(), cpu["tau"].double()
    want_vox = voxel_metrics(pred64, tau64)
    want_roi = roi_metrics(pred64, tau64, cpu["roi_compact"], r)
    cpu_s = time.perf_counter() - t0
    worst_vox = _check_metrics("eval voxel", vox, want_vox)
    worst_roi = _check_metrics("eval roi", roi, want_roi)
    tau, compact = (torch.as_tensor(two[k], device=DEVICE) for k in ("tau", "roi_compact"))
    metrics_ms = median_ms(lambda: (voxel_metrics(pred, tau),
                                    roi_metrics(pred, tau, compact, r)), reps=5)
    print(f"template eval b=2 {s}^3: median {statistics.median(eval_ms[1:]):.2f} ms "
          f"over calls 2-4 (first {eval_ms[0]:.2f} ms), of which the metric suite "
          f"{metrics_ms:.2f} ms (CUDA events); metrics vs cpu f64 (computed in "
          f"{cpu_s:.1f} s): "
          f"worst rel voxel {worst_vox:.2e}, roi {worst_roi:.2e} (tol {METRIC_TOL}); "
          f"ssim {[round(float(v), 6) for v in ssim]}, mae "
          f"{[round(float(v), 6) for v in vox['mae'].cpu()]}")
    del pred, vox, roi, want_vox, want_roi, pred64, tau, compact

    state = create_train_state(model, cfg.train.lr, cfg.train.weight_decay)
    step = make_train_step(model, cfg.loss, state.optimizer)
    batch = {k: torch.as_tensor(v, device=DEVICE) for k, v in one.items()}
    roi_w = torch.full((r,), cfg.loss.roi_weight, device=DEVICE)
    losses, tcds, step_ms = [], [], []
    for _ in range(TEMPLATE_STEPS):
        t0 = time.perf_counter()
        metrics = step(batch, roi_w)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(metrics["loss"]))
        tcds.append(float(metrics["tcds_loss"]))
    launches, plain_cuda = dict(ops.LAUNCHES), dict(ops.PLAIN_ON_CUDA)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"template train losses: {[round(v, 6) for v in losses]}; tcds {tcds}; "
          f"grad_norm {float(metrics['grad_norm']):.4f}")
    print(f"template path launches (one eval + {TEMPLATE_STEPS} steps): {launches}; "
          f"plain on cuda: {plain_cuda}")
    check(all(np.isfinite(losses)), f"non-finite template loss: {losses}")
    check(losses[-1] < losses[0], f"template loss did not fall: {losses}")
    check(all(v == 0.0 for v in tcds), f"RnC did not take its n<2 guard: {tcds}")
    check(state.step == TEMPLATE_STEPS, f"train state counts {state.step} updates")
    heads = ("proj", "final_proj")
    for name, p in model.named_parameters():
        if name.startswith(heads):  # RnC's guard at b=1 reads no projection
            check(p.grad is None, f"{name}: a gradient through the RnC guard")
        else:
            check(p.grad is not None and bool(torch.isfinite(p.grad).all()),
                  f"{name}: no finite gradient in the template train step")
    for family in ops.PATH_FAMILIES:
        check(launches.get(family, 0) > 0, f"{family}: no launch on the template path")
    check(sum(plain_cuda.values()) == 0, f"plain versions ran on the GPU: {plain_cuda}")
    med = statistics.median(step_ms[1:])
    print(f"template train step b=1 {s}^3: median {med:.2f} ms over steps "
          f"2-{TEMPLATE_STEPS}; all steps ms {[round(t, 2) for t in step_ms]}; "
          f"peak memory {peak:.2f} GiB (forward, eval and train)")
    profile_step(lambda: step(batch, roi_w))
    return launches


def _timed(fn) -> float:
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs a GPU",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    phase_device()
    phase_build()
    if "--parity-seeds" in sys.argv:  # phase 8 alone, at seeds 0 .. n-1
        for seed in range(int(sys.argv[sys.argv.index("--parity-seeds") + 1])):
            phase_parity(s=88, b=1, template=True, seed=seed)
        return 0
    summary: dict = {}
    phase_kernels(summary)
    phase_parity()
    phase_gradients()
    phase_gradients(b=3)
    paths = {"serving": phase_serving(), "training": phase_training()}
    torch.cuda.empty_cache()
    phase_parity(s=88, b=1, template=True)
    paths["template"] = phase_template()
    kernels = []
    for family, (name, source, replaces) in SOURCES.items():
        entry = summary[family]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": paths["template"].get(family, 0),
            "launches_by_path": {p: n.get(family, 0) for p, n in paths.items()},
            "max_abs_err": entry["max_abs_err"],
            "ms": round(entry["ms"], 4), "plain_ms": round(entry["plain_ms"], 4),
            "bound_ms": round(entry["bound_ms"], 4),
            "bound_by": max(("operations", "bytes"), key=lambda k: entry[k]),
            "library_ms": (round(entry["library_ms"], 4) if entry["library_all"]
                           else None)})
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
