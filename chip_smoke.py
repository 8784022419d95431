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
              tensor-core kernels, K1's, K2's, K3's, KB1's, KB2's, F1's, F2's
              two maps' and FB1's, in `cuobjdump -sass` of the library: each
              must have some.
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
              path, K3 at up0 (also at the 216^3 eval's b=2), at
              down0.conv0's input-gradient shapes (`conv3d_t2_dx`: the
              cotangent through flip_t(w); library: cuDNN's dgrad of the
              stride-2 conv) and at odd sizes off the path, KB2 also at odd
              sizes and channel counts off the path (shared weights), K4 also
              at the 216^3 eval's b=2 and K4 and KB3 at odd sizes off the
              path (N % 8 = 6), also with x 2 bytes off 16 (the kernels'
              2-byte loads); K4's two slab halves, `norm_stats` (its f64
              (count, mean, M2) within KERNEL_TOL of max|plain| a column)
              and `norm_apply`, at phase 14's slab shapes [1, 32, 64, 128,
              128], [1, 1, 64, 128, 128] and [1, 64, 32, 64, 64], its
              uneven 216^3 slabs [1, 32, 112 or 104, 216, 216], [1, 1, 104,
              216, 216] and [1, 64, 52, 108, 108] (SP_SLAB_SHAPES lists all
              of phase 14's), an odd slab depth [1, 32, 13, 216, 216] and
              at the odd sizes. K1, K2, K3, KB1, KB2, K4 and KB3 cases run twice and
              must be bit-identical, the slab halves also after a call on
              rows of another shape (A, B, A: the statistics' workspace is
              left clean); each prints the cut `s1_plan`, `s2_plan`,
              `t2_plan`, `dw_plan`, `sdw_plan`, `na_plan` or `slab_plan`
              (segments, grid, waves) chose, and each K3 and KB2 case its
              TFLOP/s and the share of its byte bound. Then the float32 forms (`<family>_f32`:
              F1, csrc/conv3d_s1_f32_tc.cu; F2, csrc/conv3d_s2_f32_tc.cu and
              csrc/conv3d_t2_f32_tc.cu; FB1, csrc/conv3d_dw_f32_tc.cu; K4, KB3,
              the slab halves and KS templated) at the F32_SITES of the same
              shapes, on f32 inputs: within F32_TOL of max|plain| (KS bit for
              bit), two calls bit-identical, each printing the cut `f1_plan`,
              `f2_plan`, `fb1_plan` or `na_plan` at element size 4 chose; the
              library is cuDNN in f32 with TF32 off (`F.instance_norm` for
              `instance_norm`, `torch.var_mean` for `norm_stats`, in both
              dtypes) and the convs' bound counts their operations at the
              3xTF32 rate, PEAK_TF32X3 (each conv case prints its TFLOP/s,
              its share of that bound and cuDNN's time).
  4. parity:  the full-width flagship at 64^3, b=2, random weights from a
              seed, run on the GPU through the kernels in bf16 and on the CPU
              in f32 through the plain versions; relative L2 error of `out`.
              Then the same weights in float32 on the GPU (the float32
              kernels, TF32 off) against the same CPU forward, within
              F32_PARITY_TOL, with three planted faults above it: F1's tap 0
              zeroed, F2's output parity class (1, 1, 1) dropped and F2's
              stride-2 centre tap zeroed.
  5. gradients: one train-step loss and backward of the same model on the
              GPU (kernels, bf16), on the CPU in f32 and on the CPU in bf16
              (plain versions; the rounding baseline): the loss difference
              and, per module group, the relative L2 error of the gradients,
              which may reach GRAD_RATIO x the bf16 route's. Every parameter
              with a CPU gradient must get a finite one on the GPU. At b=2,
              then at b=3, where RnC's loss must be non-zero, so its
              gradient reaches the projection heads and, through K2's
              input-gradient role, the encoder. At b=3 also the float32 route
              on the GPU against the CPU f32: the loss within F32_LOSS_TOL,
              each group within max(F32_GRAD_TOL, F32_GRAD_RATIO x its floor,
              the CPU f32 route moved by an MRI one ulp up), the three planted
              forward faults and FB1's (tap 0 of the stride-1 map's k=3 dW
              zeroed) over a limit; each group's error against the same step
              in f64 on the CPU is printed for the card and for the CPU's
              f32.
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
  10. loop:   the slice's main path, through the CLI's `main([...])` in this
              process: a synthetic cohort of 6 subjects at 128^3 with the 36
              ROIs (`make_synthetic_cohort`, fold 4: 4 train / 2 test) and a
              `--config` JSON with the default ModelConfig and LossConfig,
              epochs 2, batch 2, validation and a checkpoint every epoch.
              `train` must give finite losses, the 3 checkpoints, CSV columns
              epoch_0 and epoch_1, 2 pred/gt NIfTI pairs per validation and
              adapted ROI weights; `-resume_training` to epochs 3 must start at
              epoch 2 from parameters bit-identical to the saved ones, the step
              count going on 4 -> 6; `validate` from that run's epoch-2
              checkpoint must print its epoch-2 CSV values within METRIC_TOL
              (avg_corr's floor is 1e-6 of the largest ROI correlation);
              `infer` must write finite 128^3 volumes. Every kernel family of
              the path must launch and no plain version may run on the GPU.
              Prints the loop's median step beside phase 7's, the loader-wait
              share, the epoch, checkpoint save and restore, validate and
              infer wall times, the checkpoint's size, the peak memory and the
              phase's seconds.
  11. tCDS:   the tCDS loss (`LossConfig(rnc=False)`: anchor, positive and
              negative, three forwards and their backward) and the data
              options of the CLI. Phase 5's check at 64^3 b=2 with partners
              distinct from the anchors, to phase 5's limits, the tCDS term
              non-zero on every route; four synchronized 128^3 b=2 tCDS steps
              of the default ModelConfig (median, peak memory, a profile:
              kernel time and idle share; fresh triplets every step, the
              triplet term non-zero on each; every kernel family launches,
              no plain version on the GPU); a synthetic 10-subject 128^3 cohort
              whose training split (8) holds two subjects or more in every
              (abeta, quartile) cell, so that no anchor is its own positive;
              one b=2 batch's host time by part (read with the numpy and the
              native reader, mask, ROI compaction, collate, pin) for RnC and
              tCDS; the slice's main path, `train --config` with
              "loss": {"rnc": false}, 2 epochs through the CLI (every kernel
              family must launch, no plain version on the GPU, the pos/neg
              CSVs written); `infer --cohort ucsf --cohort_dir <bundle>
              --save_attention` on a synthetic 128^3 bundle, each psi map
              within ATTN_TOL of the forward's attention. Prints the
              loader-wait shares of phases 10 and 11.
  12. baselines: the registry's seven other model types (AttnUNET,
              GenAttnUnet, UNET, GenUNETR, AttnUNETR, SwinUnetr,
              AttnSwinUnetr) at the registry's widths, weights from seed 0.
              (a) Each one's bf16 forward on the card against its f32 CPU
              forward at 32^3 b=2, rel L2 of `out` within PARITY_TOL, or,
              where bf16 rounding alone exceeds it, within PARITY_RATIO x
              the plain bf16 CPU route's error, as phase 8; each
              one with batch norm at 32^3 b=2: a train step moves every
              running statistic and an eval step leaves them as they are.
              (b) At 128^3 b=2: the median of 10 forwards (CUDA events),
              BASELINE_STEPS synchronized train steps (median of steps 2 on,
              finite non-zero losses, every parameter given a finite
              gradient), the peak memory and one profiled step (kernel
              time, idle share). AttnUNET and GenAttnUnet run the flagship's
              backbone: every kernel family of the path must launch there
              (`launches_by_path["baselines"]`); the other five must launch
              none; no plain version may run on the GPU. (c) Through the
              CLI on a synthetic 6-subject 128^3 cohort: `train -model_type
              UNET` 1 epoch; AttnUNET with the config's batch norm 2 epochs
              and a resumed third, `validate` from its epoch-2 checkpoint
              within METRIC_TOL of the run's CSV, `infer`; `train
              -model_type GenUNETR` 1 epoch and `infer` from its checkpoint.
  13. data parallel: `parallel/mesh.py` with two rank processes sharing the
              one card over gloo (NCCL takes one rank a device), each on 2
              rows of a global 128^3 b=4 batch of the default ModelConfig
              (RnC, `valid_mask` [1, 1, 1, 0], cuDNN deterministic on both
              sides), against one process's b=4 steps on the card: the
              sharded eval step's pred bit for bit and its metrics within
              METRIC_TOL of one process's eval of the same rows, the first
              sharded train step's loss within LOSS_TOL, its grad_norm
              within DP_NORM_TOL and every gradient group within its
              DP_GRAD_LIMITS (rel L2, the norm-fed conv biases left out as
              in phase 5), the parameters bit-identical on both ranks after
              two steps; then `train.loop.train` under the mesh for 2 epochs
              on a synthetic 6-subject 128^3 cohort, each rank's loaders
              reading its rows, against the same loop in one process: the
              same files, the validation CSVs within DP_LOOP_TOL, the
              checkpoint loading into a single-process model. Every kernel
              family must launch on rank 0 over the steps and the loop
              (`launches_by_path["data_parallel"]`) and no plain version may
              run on the GPU. A planted gather whose backward drops the
              cross-rank sum must put some gradient group over its limit.
              Prints the second step's time beside one process's b=4 step:
              the cost of two ranks sharing a card, not a data-parallel
              speed.
  14. spatial: `parallel/spatial.py`'s `make_spatial_infer_fn` on two rank
              processes sharing the one card over gloo, each holding a depth
              slab of a b=1 volume -- at 128^3 of the default ModelConfig
              (even slabs, 64 of 128 planes) and at 216^3 of the
              template-space config (uneven slabs: planes 0-111 and
              112-215, then 56/52, 28/26, 14/13 and 7/7; the last rank's
              upsample to level 3 is cut by one plane) -- weights from seed
              0, the volume from `_batch`, against one process's
              `make_infer_fn` at the same size: rank 0's assembled `out`
              within max(SPATIAL_TOL, SPATIAL_RATIO x what the same slab
              route reads on one rank holding the whole volume) rel L2 (in
              bf16 the random-weight model moves `out` by 3e-2 for a
              last-bit change of one statistic, so no route whose
              statistics are summed in another order reads under 1e-2);
              two planted faults (every halo read as zeros; each rank's own
              norm statistics unmerged) above that limit, each with its
              factor; every merged (mean, rstd) bit-identical on both ranks;
              each rank launched K1, K2, K3 and K4's two slab halves
              (`norm_stats`, `norm_apply`) and not the whole-row K4, and no
              plain version on the GPU (`launches_by_path["spatial"]` and
              `["spatial 216"]`); each rank's activation peak (the most
              allocated during the call less what was allocated before it)
              at most SP_PEAK_RATIO x one process's. Prints each rank's
              planes, the median of SP_CALLS sharded forwards beside one
              process's, the share of a call spent in the halo and
              statistics collectives, each rank's peak and the phase's
              seconds. Then all of it again with the model in float32 (TF32
              off): within SPATIAL_TOL_F32, the float32 families launched
              and no bf16 one, and a third planted fault, level 1's halo
              read one plane too far, above the limit.
  15. float32: the default ModelConfig in float32, widths uncut, weights from
              seed 0, TF32 off: the 128^3 b=2 forward (median of
              F32_FWD_CALLS, CUDA events), F32_STEPS RnC train steps at 128^3
              b=2 (median of steps 2 on; finite non-zero losses), the
              template-space 216^3 b=1 forward (`make_infer_fn`), a
              torch.profiler top-10 and idle share of one more train step
              (each float32 kernel's records in it beside the launches the
              counters saw in that step, and any gap between them), and
              `cli.main infer --compute_dtype float32` on a synthetic
              6-subject 128^3 cohort with both TF32 flags set True before it
              (the CLI must turn them off). Each path counted from 0: every
              float32 family it reaches launches, no bf16 family and no plain
              version on the GPU; times, peaks, launches and the flags.
  16. side models: `train_convattn` SIDE_EPOCHS epochs of a `ConvAttn` (36
              ROIs) on a synthetic ROI table read by `ImageDataset`, on the
              card and on the CPU: finite falling losses, the first epoch
              within SIDE_LOSS_TOL; the UQ heads, the weighted, N-pair (on
              quartile templates written and loaded as NIfTI), cluster
              N-pair and heteroscedastic losses on CUDA tensors against the
              CPU within SIDE_TOL of max. No kernel of the port runs there.
  17. analysis: the default ModelConfig flagship (seed 0) through
              `analysis.extract_bottleneck_encodings` over ANALYSIS_BATCHES
              b=2 128^3 batches inside `utils.profiling.trace`: features
              [8, 262144], finite; K1, K2, K3 and K4 launched, no plain
              version on the card; the trace file holds K1 records (their
              count printed beside the launches). Phase 4's 64^3 b=2 model:
              its bottleneck features on the card (bf16) within PARITY_TOL
              rel L2 of the CPU's f32. `probe_abeta_from_embeddings` on the
              card's features (ANALYSIS_FEATURES kept, abeta four 1s and
              four 0s): finite r2 and rfe_r2, its host seconds.
              ANALYSIS_CALLS b=2 extractions timed by `StepTimer` (p50) and
              CUDA events (median). `ops.gaussian_smooth` of a [2, 1, 128^3]
              float32 volume within SMOOTH_TOL of the CPU's (TF32 off),
              `ops.resize_nearest_device` bit-equal to the CPU's.
Each phase's seconds follow it ("phase <name>: <s> s").
The last two lines are a JSON summary of the kernels, each with its
`dtype` (`launches` from the tCDS train of phase 11 for bf16 and from phase
15's train steps for float32, and for K4's slab halves from phase 14 in
each dtype; `launches_by_path` for every path) and {"ok": true, "device":
{...}}. There is no CPU path.
"""

from __future__ import annotations

import contextlib
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
# float32 on the card against float32 on the CPU: the CPU parity limits of
# tests/test_e2e_torch_parity.py (the port against JAX), since both sides sum
# in f32 and differ only in order
F32_PARITY_TOL = 1e-4  # rel L2 of `out` (phase 4)
F32_LOSS_TOL = 1e-5    # relative loss difference (phase 5)
F32_GRAD_TOL = 2e-3    # rel L2 of each gradient group (phase 5), or F32_GRAD_RATIO x the
F32_GRAD_RATIO = 6.0   # group's floor where that is larger: the CPU f32 route moved by an
                       # MRI one ulp up, which moves every activation by f32 rounding, as
                       # the kernels' other summation orders do at every layer (sound
                       # kernels read 1.3-2.8x the floor where it sets the limit; F1's
                       # zeroed tap and F2's dropped class >= 100x the limit)
DEVICE = "cuda"       # every phase runs on the card; there is no CPU path
READINGS: dict = {}   # numbers one phase prints beside another's
TRAIN_STEPS = 6
TEMPLATE_STEPS = 4
TCDS_STEPS = 4
BASELINE_STEPS = 4
# the registry's baselines; the first two run the flagship's backbone, whose
# levels 0-1 go through the kernels, the other five PyTorch's built-ins
BASELINE_TYPES = ("AttnUNET", "GenAttnUnet", "UNET", "GenUNETR", "AttnUNETR",
                  "SwinUnetr", "AttnSwinUnetr")
KERNEL_BASELINES = ("AttnUNET", "GenAttnUnet")
ATTN_TOL = 1e-2       # |psi written by `infer --save_attention` - psi of the forward|: the
                      # same bf16 forward twice, where cuDNN's transposed convs may add in
                      # another order
PEAK_BF16 = 989e12    # H100 SXM dense bf16 tensor-core FLOP/s
PEAK_F32 = 67e12      # H100 SXM f32 FLOP/s outside the tensor cores
# H100 SXM f32-accurate FLOP/s on the tensor cores: three TF32 products a
# product (3xTF32) at the dense TF32 rate. A float32 conv's least time is its
# operations at this rate, the fastest way the card has to f32-accurate sums
PEAK_TF32X3 = 495e12 / 3
HBM_BYTES = 3.35e12   # H100 SXM device memory bytes/s
# the tensor-core kernels, K1 (csrc/conv3d_s1_tc.cu), K2 (csrc/conv3d_s2_tc.cu),
# K3 (csrc/conv3d_t2_tc.cu), KB1 (csrc/conv3d_dw_tc.cu), KB2
# (csrc/conv3d_dw_s2_tc.cu), F1 (csrc/conv3d_s1_f32_tc.cu), F2's two maps
# (csrc/conv3d_s2_f32_tc.cu, csrc/conv3d_t2_f32_tc.cu) and FB1
# (csrc/conv3d_dw_f32_tc.cu)
TC_KERNELS = ("conv3d_s1_tc_kernel", "conv3d_s2_tc_kernel", "conv3d_t2_tc_kernel",
              "conv3d_dw_tc_kernel", "conv3d_dw_s2_tc_kernel", "conv3d_s1_f32_tc_kernel",
              "conv3d_s2_f32_tc_kernel", "conv3d_t2_f32_tc_kernel",
              "conv3d_dw_f32_tc_kernel")
SOURCES = {
    "s1": ("conv3d_s1", "coma_unet_tpu_torch/csrc/conv3d_s1_tc.cu",
           "coma_unet_tpu/ops/pallas/conv3d_p1.py:231 _p1_fwd; "
           "conv3d.py:260 _pallas_conv3d_fwd; conv3d.py:187 "
           "_pallas_conv3d_fwd_htiled; conv3d_packed.py:105 _packed_fwd; "
           "conv3d_packed.py:264 pallas_conv3d_w64"),
    "s2": ("conv3d_s2", "coma_unet_tpu_torch/csrc/conv3d_s2_tc.cu",
           "coma_unet_tpu/ops/pallas/conv3d_strided.py:299 _s2_fwd_v2; "
           ":136 _s2_fwd_v1; phase_split.py:86 pallas_hwsplit"),
    "t2": ("conv3d_t2", "coma_unet_tpu_torch/csrc/conv3d_t2_tc.cu",
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
    "norm_stats": ("norm_stats", "coma_unet_tpu_torch/csrc/norm_act.cu",
                   "coma_unet_tpu/ops/pallas/norm_act.py:105 _stats_kernel "
                   "(launched at :191)"),
    "norm_apply": ("norm_apply", "coma_unet_tpu_torch/csrc/norm_act.cu",
                   "coma_unet_tpu/ops/pallas/norm_act.py:120 _apply_kernel "
                   "(launched at :207)"),
}
# the float32 forms (`<family>_f32`): F1, F2's two maps and FB1's two maps
# tensor-core kernels in 3xTF32; K4, KB3, their slab halves and KS are
# templated
F32_SOURCES = {"s1": "coma_unet_tpu_torch/csrc/conv3d_s1_f32_tc.cu",
               "s2": "coma_unet_tpu_torch/csrc/conv3d_s2_f32_tc.cu",
               "t2": "coma_unet_tpu_torch/csrc/conv3d_t2_f32_tc.cu",
               "s1_dw": "coma_unet_tpu_torch/csrc/conv3d_dw_f32_tc.cu",
               "strided_dw": "coma_unet_tpu_torch/csrc/conv3d_dw_f32_tc.cu"}
SOURCES.update({family + "_f32": (name, F32_SOURCES.get(family, source), replaces)
                for family, (name, source, replaces) in list(SOURCES.items())})
# the sites of `_kernel_cases` that phase 3 also runs in float32
F32_SITES = {
    "s1": ("head.conv0", "head.conv1", "merge0", "deep_modulator_3c.conv1",
           "deep_modulator_3c.conv2", "gate0.W_g", "gate0.psi", "final_pred_head",
           "down0.conv1", "merge1", "216 head.conv1", "216 merge0", "216 gate0.psi",
           "216 down0.conv1", "conv3d_w64 64->64", "head.conv1 dx 32->32",
           "merge0 dx 32->64", "merge1 dx 64->128", "216 head.conv1 dx 32->32",
           "216 slab r0 head.conv1", "216 slab r1 head.conv1", "216 window head.conv1",
           "216 slab r1 down0.conv1", "216 window down0.conv1"),
    "s2": ("down0.conv0", "216 down0.conv0", "up0 dx 32->64", "odd sizes 24->40",
           "216 slab r0 down0.conv0", "216 slab r1 down0.conv0", "216 window down0.conv0"),
    "t2": ("up0", "216 up0", "down0.conv0 dx 64->32", "odd sizes 24->40",
           "216 slab r0 up0", "216 slab r1 up0", "216 window up0"),
    "s1_dw": ("head.conv0", "head.conv1", "merge0", "deep_modulator_3c.conv2",
              "gate0.W_g", "gate0.psi", "down0.conv1", "merge1", "216 head.conv1",
              "216 merge0", "odd W k=3 (scalar loads)", "odd W k=1 (scalar loads)"),
    "strided_dw": ("down0.conv0 (s2: full=x, half=g)", "up0 (t2: full=g, half=x)",
                   "216 down0.conv0 (s2: full=x, half=g)", "216 up0 (t2: full=g, half=x)",
                   "odd sizes 24, 40 (shared)"),
    "norm_act": ("head.conv1", "merge0", "gate0.psi", "final_pred_head", "down0.conv1",
                 "216 head.conv1", "odd sizes", "odd sizes, x 2 bytes off 16",
                 "instance_norm none 216"),
    "norm_act_bwd": ("head.conv1", "merge0", "gate0.psi", "down0.conv1", "216 head.conv1",
                     "odd sizes", "odd sizes, x 2 bytes off 16"),
    "norm_stats": ("half slab head.conv1", "half slab gate0.psi",
                   "half slab final_pred_head", "half slab down0.conv1",
                   "216 slab r0 head.conv1", "216 slab r1 head.conv1",
                   "odd slab depth 13", "odd sizes",
                   "odd sizes, x 2 bytes off 16"),
    "norm_apply": ("half slab head.conv1", "half slab gate0.psi",
                   "half slab final_pred_head", "half slab down0.conv1",
                   "216 slab r1 head.conv1", "odd slab depth 13", "odd sizes",
                   "odd sizes, x 2 bytes off 16"),
    "phase_split": ("hsplit 216",),
}
# kernels whose device time the profile prints by name, in or below its top
# 8: K2, K3, KB2, K1's (and K2's and K3's) weight packing, KB1/KB2's
# split-K sum, K4 and KB3
SMALL_KERNELS = ("conv3d_s2_tc_kernel", "conv3d_t2_tc_kernel", "conv3d_dw_s2_tc_kernel",
                 "s1_pack_weights", "dw_reduce_kernel", "norm_act_kernel",
                 "norm_act_bwd_kernel")
# the same for the float32 step: F1, F2's two maps and their weight packing,
# FB1 and its split-K sum, K4 and KB3
F32_KERNELS = ("conv3d_s1_f32_tc_kernel", "conv3d_s2_f32_tc_kernel", "conv3d_t2_f32_tc_kernel",
               "tf32_pack_weights", "conv3d_dw_f32_tc_kernel", "dw_reduce_kernel",
               "norm_act_kernel", "norm_act_bwd_kernel")


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


# Every slab shape phase 14 sends each of K4's slab halves, per rank and
# forward, with its count: level 0 head and merge0, the modulator, gate0.psi
# with the modulator's and fusion's last layers and final_pred_head, fusion;
# level 1 down0 and merge1, gate1, gate1.psi. At 128^3 both ranks hold 64 of
# 128 planes at level 0 and 32 of 64 at level 1; at 216^3 rank 0 holds 112
# and 56, rank 1 104 and 52 (`plan_slabs`: the boundary is the multiple of
# 16 nearest 108).
def _sp_slab_shapes(d0: int, d1: int, s: int) -> tuple:
    return (((1, 32, d0, s, s), 4), ((1, 16, d0, s, s), 4), ((1, 1, d0, s, s), 4),
            ((1, 8, d0, s, s), 2), ((1, 64, d1, s // 2, s // 2), 3),
            ((1, 32, d1, s // 2, s // 2), 2), ((1, 1, d1, s // 2, s // 2), 1))


SP_SLAB_SHAPES = (_sp_slab_shapes(64, 32, 128) + _sp_slab_shapes(112, 56, 216)
                  + _sp_slab_shapes(104, 52, 216))


def _kernel_cases():
    """(family, site, input shape, weight shape or None, extra, entry) at
    the shapes of the 128^3 b=2 serving forward and train step and of the
    216^3 b=1 template-space path; `entry` names a standalone entry point
    (`instance_norm`, `conv3d_w64`, `hsplit`), is "dx" for K1, K2 or K3 as
    an input gradient (input: the cotangent; weights: the forward layer's),
    or is None for the family's own wrapper."""
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
    cases.append(("t2", "216 b=2 up0 (eval)", (2, 64) + t1, (32, 64, 3, 3, 3), True, None))
    # K3 as down0.conv0's input gradient (Conv3dS2.backward: the cotangent
    # [B, 64, ...] through flip_t of down0.conv0's per-sample [B, 64, 32,
    # 3^3], 64 -> 32), and odd sizes off the path, whose masks, scalar loads,
    # 4-byte stores, zero-padded chunk and ragged second output-channel tile
    # it exercises
    cases.append(("t2", "down0.conv0 dx 64->32", (2, 64) + v1, (64, 32, 3, 3, 3), True,
                  "dx"))
    cases.append(("t2", "216 down0.conv0 dx 64->32", (1, 64) + t1, (64, 32, 3, 3, 3), True,
                  "dx"))
    cases.append(("t2", "odd sizes 24->40", (2, 24, 13, 9, 23), (40, 24, 3, 3, 3), True,
                  None))
    # the depth-sharded forward at 216^3 on two ranks (phase 14): K1, K2 and
    # K3 on each rank's slab of levels 0 and 1 (112 and 104 of 216 planes,
    # 56 and 52 of 108) and on the boundary windows `Slab.conv` reruns: 3
    # planes for a stride-1 conv's outer output plane, 4 for the stride-2
    # conv's first, 2 coarse planes for the transposed conv's last (K1's
    # bricks masked along depth as well as at the 24-wide edge tiles)
    sp_convs = [("s1", "head.conv1", 32, 32, (112, 104, 3), t0),
                ("s1", "down0.conv1", 64, 64, (52, 3), t1),
                ("s2", "down0.conv0", 32, 64, (112, 104, 4), t0),
                ("t2", "up0", 64, 32, (56, 52, 2), t1)]
    for family, site, ci, co, depths, sp in sp_convs:
        for d in depths:
            tag = {112: "slab r0", 56: "slab r0", 104: "slab r1", 52: "slab r1"}.get(
                d, "window")
            cases.append((family, f"216 {tag} {site}", (1, ci, d) + sp[1:],
                          (co, ci, 3, 3, 3), True, None))
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
             ("216 head.conv1", 1, 32, "relu", True, t0),
             # off the path: N % 8 = 6, so rows start off 16 bytes; then x
             # itself 2 bytes off 16, which takes the 2-byte loads everywhere
             ("odd sizes", 2, 24, "prelu", True, (27, 18, 45)),
             ("odd sizes, x 2 bytes off 16", 2, 24, "prelu", True, (27, 18, 45))]
    eval_norm = [("216 b=2 head.conv1 (eval)", 2, 32, "relu", True, t0)]
    for family, sites in (("norm_act", norms + eval_norm), ("norm_act_bwd", norms)):
        cases += [(family, site, (b, c) + sp, None, (act, film, int("off 16" in site)), None)
                  for site, b, c, act, film, sp in sites]
    cases += [("norm_act", f"instance_norm {act} 216", (1, 32) + t0, None,
               (act, False, 0), "instance_norm")
              for act in ("none", "relu", "leakyrelu")]
    cases.append(("phase_split", "hsplit 216", (1, 32) + t0, None, None, "hsplit"))
    # K4's slab halves at the shapes of phase 14's slabs (SP_SLAB_SHAPES
    # lists all of them): at 128^3 a rank's 64 of 128 planes at level 0, 32
    # of 64 at level 1; at 216^3 the uneven slabs, 112 and 104 of 216 planes,
    # 56 and 52 of 108; an odd slab depth of 216^2 planes (the last rank's
    # tail of a volume of odd depth); and off the path at odd sizes (rows
    # start off 16 bytes), also with x 2 bytes off 16
    half, half1 = (64, 128, 128), (32, 64, 64)
    slabs = [("half slab head.conv1", 1, 32, "relu", True, half),
             ("half slab gate0.psi", 1, 1, "none", False, half),
             ("half slab final_pred_head", 1, 1, "prelu", False, half),
             ("half slab down0.conv1", 1, 64, "relu", True, half1),
             ("216 slab r0 head.conv1", 1, 32, "relu", True, (112, 216, 216)),
             ("216 slab r1 head.conv1", 1, 32, "relu", True, (104, 216, 216)),
             ("216 slab r1 gate0.psi", 1, 1, "none", False, (104, 216, 216)),
             ("216 slab r1 down0.conv1", 1, 64, "relu", True, (52, 108, 108)),
             ("odd slab depth 13", 1, 32, "relu", True, (13, 216, 216)),
             # the longest segments of the spatial path: phase 14's one-rank
             # slab route at 216^3 holds all 216 planes
             ("216 one-rank slab head.conv1", 1, 32, "relu", True, t0),
             ("odd sizes", 2, 24, "prelu", True, (27, 18, 45)),
             ("odd sizes, x 2 bytes off 16", 2, 24, "prelu", True, (27, 18, 45))]
    for family in ("norm_stats", "norm_apply"):
        cases += [(family, site, (b, c) + sp, None, (act, film, int("off 16" in site)), None)
                  for site, b, c, act, film, sp in slabs]
    return cases


def _kernel_cases_f32():
    """Phase 3's float32 cases: the sites of F32_SITES at `_kernel_cases`'
    shapes, each family as its float32 form (`<family>_f32`). The off-16
    cases start x one f32 element, 4 bytes, into its allocation."""
    return [(family + "_f32", site.replace("2 bytes off", "4 bytes off"), xshape, wshape,
             extra, entry)
            for family, site, xshape, wshape, extra, entry in _kernel_cases()
            if site in F32_SITES.get(family, ())]


def _base(family: str) -> tuple:
    """(the bf16 family, the dtype) of a phase-3 family."""
    if family.endswith("_f32"):
        return family[:-4], torch.float32
    return family, torch.bfloat16


NORM_MEAN = 3.0 + 2.0 ** -7   # the norm cases' mean of x (`_norm_inputs`)


def _norm_inputs(xshape, act, film, offset, gen, dev, dtype=torch.bfloat16):
    # a mean large against the spread exercises the shifted stats; x starts
    # `offset` elements into its allocation. x holds bf16 values in either
    # dtype: two f32 computations of u differ in the last bits, and where u
    # lies that close to an activation's kink (u = 0) they take act'(u) from
    # its two sides; on bf16's coarser grid of x no voxel lies that close,
    # unless a row's mean (the kink without FiLM) lies within an f32 step of
    # a grid value. So the mean is 3 + 2^-7, half of bf16's step of 2^-6
    # past the grid value 3: around 3 a 2.1 M-voxel row's mean, 3 + 9.2e-8,
    # rounded to 3.0 in f32, and KB3 took act' = 1 at its voxels x = 3
    # where f64 (and the plain version's f32 mean) take 0.01
    size = int(np.prod(xshape))
    x = (NORM_MEAN + torch.randn(size + offset, generator=gen, device=dev)).bfloat16().to(
        dtype)
    x = x[offset:].view(xshape)
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
    bound. Each call returns a tensor or a tuple of tensors. A float32
    family (`<family>_f32`) takes f32 inputs, its plain version on the
    kernel's own inputs is its reference, and its convs' operations count
    at the 3xTF32 rate (PEAK_TF32X3)."""
    import torch.nn.functional as F

    from coma_unet_tpu_torch import ops
    from coma_unet_tpu_torch.ops.conv3d import (
        conv3d_s1_dx,
        conv3d_weight_ref,
        f1_plan,
        fb1_plan,
        flip_t,
        s1_plan,
    )
    from coma_unet_tpu_torch.ops.conv3d_strided import (
        conv3d_s2_dx,
        conv3d_t2_dx,
        f2_plan,
        s2_plan,
        t2_plan,
    )

    family, dtype = _base(family)
    f32 = dtype == torch.float32
    conv_rate = PEAK_TF32X3 if f32 else PEAK_BF16

    def randn(shape):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    if family == "phase_split":
        x = randn(xshape)
        return dict(kernel=lambda: ops.hsplit(x), ref=lambda: ops.hsplit_plain(x),
                    plain=lambda: ops.hsplit_plain(x), library=None, inputs=(x,),
                    ops=0, rate=PEAK_F32)
    if family in ("norm_stats", "norm_apply"):
        from coma_unet_tpu_torch.ops.norm_act import mean_rstd, row_partials, slab_plan_of

        x, alpha, scale, shift = _norm_inputs(xshape, *extra, gen, dev, dtype)
        act = extra[0]
        # B of the A, B, A check: the same half on rows of another shape
        other_shape = (1, 8, 24, 40, 40) if xshape[1] != 8 else (2, 3, 16, 16, 16)
        xb = _norm_inputs(other_shape, "none", False, 0, gen, dev, dtype)[0]
        if family == "norm_stats":  # (count, mean, M2) of each row, f64
            rows = xshape[0] * xshape[1]
            return dict(kernel=lambda: ops.norm_stats(x).unbind(1),
                        ref=lambda: ops.norm_stats_plain(x.float()).unbind(1),
                        plain=lambda: ops.norm_stats_plain(x),
                        library=lambda: torch.var_mean(x.reshape(rows, -1), dim=1),
                        inputs=(x,), ops=3 * x.numel(), rate=PEAK_F32,
                        plan=slab_plan_of(x, 0), other=lambda: ops.norm_stats(xb))
        stats = mean_rstd(row_partials(x))
        stats_b = mean_rstd(row_partials(xb))
        film = tuple(t for t in (scale, shift) if t is not None)
        return dict(kernel=lambda: ops.norm_apply(x, stats, alpha, act, scale, shift),
                    ref=lambda: ops.norm_apply_plain(x.float(), stats, alpha, act, scale,
                                                     shift),
                    plain=lambda: ops.norm_apply_plain(x, stats, alpha, act, scale, shift),
                    library=None, inputs=(x, stats) + film, ops=6 * x.numel(),
                    rate=PEAK_F32, plan=slab_plan_of(x, 1, act),
                    other=lambda: ops.norm_apply(xb, stats_b, None, "none"))
    if family in ("norm_act", "norm_act_bwd"):
        from coma_unet_tpu_torch.ops.norm_act import na_plan

        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        elem = 4 if f32 else 2
        plan = na_plan(xshape[0] * xshape[1], _voxels(xshape),
                       elem * (1 if family == "norm_act" else 2), sms, elem=elem)
    if family == "norm_act":
        x, alpha, scale, shift = _norm_inputs(xshape, *extra, gen, dev, dtype)
        act = extra[0]
        common = dict(inputs=(x,), ops=8 * x.numel(), rate=PEAK_F32, plan=plan)
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
        x, alpha, scale, shift = _norm_inputs(xshape, *extra, gen, dev, dtype)
        act = extra[0]
        g = randn(xshape)
        _, stats = ops.norm_act_forward(x, alpha, act, scale, shift)
        return dict(kernel=lambda: ops.norm_act_bwd(x, g, stats, alpha, act, scale, shift),
                    ref=lambda: ops.norm_act_bwd_plain(x.float(), g.float(), alpha, act,
                                                       scale, shift),
                    plain=lambda: ops.norm_act_bwd_plain(x, g, alpha, act, scale, shift),
                    library=None, inputs=(x, g), ops=14 * x.numel(), rate=PEAK_F32,
                    plan=plan)
    if family == "s1_dw":
        from coma_unet_tpu_torch.ops.conv3d import dw_plan

        (co, k), ps = wshape, extra
        b, ci = xshape[:2]
        x, g = randn(xshape), randn((b, co) + xshape[2:])
        flops = 2 * b * co * ci * k ** 3 * _voxels(xshape)
        plan = (fb1_plan("s1", b, ci, co, *xshape[2:], k) if f32
                else dw_plan(b, ci, co, *xshape[2:], k))
        return dict(kernel=lambda: ops.conv3d_s1_dw(x, g, k, ps),
                    ref=lambda: ops.conv3d_s1_dw_plain(x.float(), g.float(), k, ps),
                    plain=lambda: ops.conv3d_s1_dw_plain(x, g, k, ps),
                    library=lambda: conv3d_weight_ref(x, g, k, ps), inputs=(x, g),
                    ops=flops, rate=conv_rate, plan=plan)
    if family == "strided_dw":
        from coma_unet_tpu_torch.ops.conv3d_strided import sdw_plan

        full, half = randn(xshape), randn(wshape)
        flops = 2 * xshape[0] * wshape[1] * xshape[1] * 27 * _voxels(wshape)
        return dict(kernel=lambda: ops.conv3d_strided_dw(full, half, extra),
                    ref=lambda: ops.conv3d_strided_dw_plain(full.float(), half.float(),
                                                            extra),
                    plain=lambda: ops.conv3d_strided_dw_plain(full, half, extra),
                    library=lambda: conv3d_weight_ref(full, half, 3, extra, 2),
                    inputs=(full, half), ops=flops, rate=conv_rate,
                    plan=(fb1_plan("s2", xshape[0], xshape[1], wshape[1], *xshape[2:]) if f32
                          else sdw_plan(xshape[0], xshape[1], wshape[1], *xshape[2:])))
    kernel, plain = {"s1": (ops.conv3d_s1, ops.conv3d_s1_plain),
                     "s2": (ops.conv3d_s2, ops.conv3d_s2_plain),
                     "t2": (ops.conv3d_t2, ops.conv3d_t2_plain)}[family]
    x = randn(xshape)
    if extra:  # per-sample weights
        wshape = (xshape[0],) + wshape
    fan_in = wshape[-4] * wshape[-1] ** 3
    w = (torch.randn(wshape, generator=gen, device=dev) / fan_in ** 0.5).to(dtype)
    bias = 0.1 * torch.randn((wshape[-5],), generator=gen, device=dev)
    # the plain version of a forward conv is PyTorch's built-in conv: the
    # library call and the plain version on the kernel's inputs are one call
    library = "plain"
    if entry == "conv3d_w64":
        call, bias = (lambda: ops.conv3d_w64(x, w)), None
    elif entry == "dx" and family == "s2":  # the stride-2 conv of g on flip_t(wf)
        wf, w, bias = w, flip_t(w), None
        call = lambda: conv3d_s2_dx(x, wf)  # noqa: E731
    elif entry == "dx" and family == "t2":  # the transposed conv of g on flip_t(wf)
        wf, w, bias = w, flip_t(w), None
        call = lambda: conv3d_t2_dx(x, wf)  # noqa: E731
        library = lambda: _conv3d_input_ref(wf, x, stride=2)  # noqa: E731  (cuDNN's dgrad)
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
                ops=flops, rate=conv_rate)
    if f32:
        cout = w.shape[-5]
        case["plan"] = (f1_plan(xshape[0], xshape[1], cout, *xshape[2:], w.shape[-1],
                                bool(extra))
                        if family == "s1" else f2_plan(family, xshape[0], xshape[1], cout,
                                                        *xshape[2:], bool(extra)))
    elif family == "s1":
        case["plan"] = s1_plan(xshape[0], xshape[1], w.shape[-5], *xshape[2:], w.shape[-1],
                               bool(extra))
    elif family == "s2":
        case["plan"] = s2_plan(xshape[0], xshape[1], w.shape[-5], *xshape[2:], bool(extra))
    else:
        case["plan"] = t2_plan(xshape[0], xshape[1], w.shape[-5], *xshape[2:], bool(extra))
    return case


def _conv3d_input_ref(w: torch.Tensor, g: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """The input gradient of the SAME conv of stride 1 or 2 with weights w
    (shared or per sample) for the output cotangent g, to an input of
    stride x g's size, through PyTorch's built-in (cuDNN's dgrad)."""
    k = w.shape[-1]
    size = tuple(stride * n for n in g.shape[2:])
    if w.dim() == 6:
        b, co, ci = w.shape[:3]
        dx = torch.nn.grad.conv3d_input(
            (1, b * ci) + size, w.reshape((b * co, ci) + w.shape[3:]),
            g.reshape((1, b * co) + g.shape[2:]), stride=stride, padding=k // 2, groups=b)
        return dx.reshape((b, ci) + size)
    return torch.nn.grad.conv3d_input((g.shape[0], w.shape[1]) + size, w, g, stride=stride,
                                      padding=k // 2)


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound_ms(ops_count: float, rate: float, nbytes: int):
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over the peak rate for their type."""
    t_ops, t_bytes = ops_count / rate, nbytes / HBM_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops > t_bytes else "bytes")


def _conv_checks(case: dict, got: torch.Tensor, kernel: str, site: str) -> str:
    """K1, K2 or K3 (F1, F2) at one site: a second call must be
    bit-identical to the first. Returns a line with the cut `s1_plan`,
    `s2_plan` or `t2_plan` (`f1_plan`, `f2_plan`) chose."""
    again = case["kernel"]()
    check(bool(torch.equal(again, got)), f"{kernel} {site}: two calls differ")
    plan = case["plan"]
    return (f"  {kernel} {site}: brick={plan.brick} ct={plan.ct} at={plan.at} "
            f"grid={plan.grid}; two calls bit-identical")


def _dw_checks(case: dict, got: torch.Tensor, kernel: str, site: str) -> str:
    """KB1 or KB2 (FB1) at one site: a second call must be bit-identical to
    the first. Returns a line with the cut `dw_plan` or `sdw_plan`
    (`fb1_plan`) chose."""
    again = case["kernel"]()
    check(bool(torch.equal(again, got)), f"{kernel} {site}: two calls differ")
    plan = case["plan"]
    extra = (f" swap={int(plan.swap)} mt={plan.mt} nt={plan.nt} threads={plan.threads} "
             f"per_sm={plan.per_sm} smem={plan.smem}" if hasattr(plan, "threads") else "")
    return (f"  {kernel} {site}: brick={plan.brick} ct={plan.ct} at={plan.at} "
            f"bricks/split={plan.bps} splits={plan.splits}{extra}; two calls bit-identical")


def _norm_checks(case: dict, got: tuple, kernel: str, site: str) -> str:
    """K4 or KB3 at one site: a second call must be bit-identical to the
    first in every output. Returns a line with the cut `na_plan` chose."""
    again = case["kernel"]()
    again = again if isinstance(again, tuple) else (again,)
    check(all(bool(torch.equal(a, b)) for a, b in zip(again, got)),
          f"{kernel} {site}: two calls differ")
    plan = case["plan"]
    return (f"  {kernel} {site}: segs={plan.segs} rows/round={plan.rows_per_round} "
            f"rounds={plan.rounds} seg={plan.seg} keep={plan.keep} grid={plan.grid} "
            f"bulk={plan.bulk}; two calls bit-identical")


def _slab_checks(case: dict, got: tuple, kernel: str, site: str, rows: int) -> str:
    """One of K4's slab halves at one site: a second call, and a third after
    a call on rows of another shape (A, B, A: the statistics' kept workspace
    is left clean), must be bit-identical to the first in every output.
    Returns a line with the cut `slab_plan` chose: segments, grid, waves."""
    for calls in ((case["kernel"],), (case["other"], case["kernel"])):
        for call in calls:
            again = call()
        again = again if isinstance(again, tuple) else (again,)
        check(all(bool(torch.equal(a, b)) for a, b in zip(again, got)),
              f"{kernel} {site}: calls differ ({len(calls) + 1} calls, A, ..., A)")
    plan = case["plan"]
    sms = torch.cuda.get_device_properties(DEVICE).multi_processor_count
    return (f"  {kernel} {site}: segs={plan.segs} seg={plan.seg} grid=({plan.segs}, "
            f"{min(rows, 65535)}) ctas={plan.ctas} waves={plan.waves:.3f} of "
            f"{plan.ctas / plan.waves / sms:.0f} an SM; A, A and A, B, A bit-identical")


def phase_kernels(summary: dict, families=None) -> None:
    """Phase 3, over the cases of `families` (every family when None)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    dev = torch.device(DEVICE)
    # rel: max error over max|plain| of the bf16 outputs and of the f32 ones
    print(f"{'family':12s} {'site':34s} {'input':24s} {'max_abs_err':>11s} "
          f"{'rel bf16':>9s} {'rel f32':>9s} {'rel f64':>9s} {'ms':>9s} {'plain_ms':>9s} "
          f"{'lib_ms':>9s} {'bound_ms':>9s} bound_by")
    for family, site, xshape, wshape, extra, entry in _kernel_cases() + _kernel_cases_f32():
        if families is not None and family not in families:
            continue
        case = _case_calls(family, xshape, wshape, extra, entry, gen, dev)
        base, dtype = _base(family)
        exact = base == "phase_split"
        with torch.no_grad():
            got, ref = case["kernel"](), case["ref"]()
            torch.cuda.synchronize()
            got = got if isinstance(got, tuple) else (got,)
            ref = ref if isinstance(ref, tuple) else (ref,)
            err = 0.0
            rel = {torch.bfloat16: None, torch.float32: None, torch.float64: None}
            for a, r in zip(got, ref):
                check(a.shape == r.shape, f"{family} {site}: shape "
                      f"{tuple(a.shape)} vs {tuple(r.shape)}")
                check(a.dtype in rel, f"{family} {site}: output dtype {a.dtype}")
                check(bool(torch.isfinite(a).all()), f"{family} {site}: non-finite")
                if exact:
                    check(a.dtype == r.dtype and bool(torch.equal(a, r)),
                          f"{family} {site}: not bit-equal to the plain version")
                # K4's slab statistics (f64) are held to their input's limit
                tol = (F32_TOL if torch.float32 in (a.dtype, dtype) else KERNEL_TOL)
                e = (a.float() - r.float()).abs().max().item()
                scale_ref = r.abs().max().item()
                check(e <= tol * scale_ref or e == 0.0,
                      f"{family} {site}: {a.dtype} max error {e} > {tol} * {scale_ref}")
                err = max(err, e)
                rel[a.dtype] = max(rel[a.dtype] or 0.0, e / scale_ref if scale_ref else 0.0)
            note = None
            f32 = dtype == torch.float32
            if base in ("s1_dw", "strided_dw"):
                name = "FB1" if f32 else {"s1_dw": "KB1", "strided_dw": "KB2"}[base]
                note = _dw_checks(case, got[0], name, site)
            elif base in ("norm_act", "norm_act_bwd"):
                name = {"norm_act": "K4", "norm_act_bwd": "KB3"}[base] + (" f32" if f32 else "")
                note = _norm_checks(case, got, name, site)
            elif base in ("norm_stats", "norm_apply"):
                note = _slab_checks(case, got, f"K4 slab {family}", site,
                                    xshape[0] * xshape[1])
            elif base in ("s1", "s2", "t2"):
                name = ({"s1": "F1", "s2": "F2", "t2": "F2"} if f32
                        else {"s1": "K1", "s2": "K2", "t2": "K3"})[base]
                note = _conv_checks(case, got[0], name, site)
            ms = median_ms(case["kernel"])
            plain_ms = median_ms(case["plain"])
            library = case["library"]
            lib_ms = (plain_ms if library == "plain"
                      else median_ms(library) if library else None)
        nbytes = _nbytes(case["inputs"]) + _nbytes(got)
        b_ms, b_by = bound_ms(case["ops"], case["rate"], nbytes)
        if dtype == torch.float32 and base in ("s1", "s2", "t2", "s1_dw", "strided_dw"):
            note += (f"; {case['ops'] / ms / 1e9:.1f} TFLOP/s, {b_ms / ms:.1%} of its "
                     f"bound ({b_by} at 3xTF32's {PEAK_TF32X3 / 1e12:.0f} TFLOP/s or "
                     f"{HBM_BYTES / 1e12:.2f} TB/s); cuDNN f32 {lib_ms:.3f} ms, "
                     f"{lib_ms / ms:.2f}x the kernel's time")
        elif base in ("t2", "strided_dw"):
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


@contextlib.contextmanager
def _no_tf32():
    """TF32 off in cuDNN and in matmul, as the CLI sets it for float32 on
    the card (the reference's Precision.HIGHEST); restored after."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


F32_FAULTS = ("F1 tap 0 zeroed", "F2 parity class 7 dropped", "F2 stride-2 centre tap zeroed")
# a fault no forward sees, planted in phase 5 only
F32_DW_FAULTS = ("FB1 tap 0 zeroed",)


@contextlib.contextmanager
def _planted(fault: str):
    """A planted fault in the float32 convs: F1's forward with tap 0 of its
    k=3 weights zeroed, F2's transposed map with the output's parity class
    (1, 1, 1) dropped (zeroed), F2's stride-2 forward with its centre tap
    (1, 1, 1) zeroed, or FB1's stride-1 map at k = 3 with tap 0 of its dW
    zeroed; each through the wrapper's launcher, so the kernels run."""
    import coma_unet_tpu_torch.ops.conv3d as conv
    import coma_unet_tpu_torch.ops.conv3d_strided as strided

    if fault == F32_DW_FAULTS[0]:
        module, name = conv, "dw_f32"
        good = conv.dw_f32

        def bad(plan, x, g, per_sample):
            out = good(plan, x, g, per_sample)
            if plan.mode == 0 and plan.k == 3:
                out[..., 0, 0, 0] = 0.0
            return out
    else:
        module, name = (conv, "conv_f32") if fault == F32_FAULTS[0] else (strided, "conv_f2")
        good = getattr(module, name)

        def bad(plan, x, w, bias32, per_sample, flip):
            tap = (0 if fault == F32_FAULTS[0] and plan.k == 3
                   else 1 if fault == F32_FAULTS[2] and plan.mode == "s2" else None)
            if tap is not None and not flip:
                w = w.clone()
                w[..., tap, tap, tap] = 0.0
            y = good(plan, x, w, bias32, per_sample, flip)
            if fault == F32_FAULTS[1] and plan.mode == "t2" and not flip:
                y[..., 1::2, 1::2, 1::2] = 0.0
            return y

    setattr(module, name, bad)
    try:
        yield
    finally:
        setattr(module, name, good)


def phase_parity(s: int = 64, b: int = 2, template: bool = False, seed: int = 0,
                 f32: bool = False) -> float:
    """The full-width model at s^3, batch b, on the GPU through the kernels
    in bf16 against the CPU in f32 through the plain versions; weights from
    `seed`, inputs from `seed + 1`. `template` builds the template-space
    configuration (prompts at s^3, 8 ROIs) and holds it to
    max(PARITY_RATIO x the plain bf16 route's error, PARITY_TOL); otherwise
    the limit is PARITY_TOL. With `f32`, the same model in float32 on the
    GPU through the float32 kernels (TF32 off) against the same CPU
    forward, within F32_PARITY_TOL, and with each of F32_FAULTS planted
    above it."""
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
    _film_signal(ref_model, gen)
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
    if f32:
        _parity_f32(ref_model, cpu_cfg, batch, ref, rel_l2)
    return rel


def _parity_f32(ref_model, cpu_cfg, batch: dict, ref: torch.Tensor, rel_l2) -> None:
    """Phase 4 in float32: the CPU f32 model's weights in a float32 model
    on the card, its `out` against the CPU's `ref`; then each planted
    fault."""
    from coma_unet_tpu_torch import ContraAttnUNet
    from coma_unet_tpu_torch import ops

    model = ContraAttnUNet(cpu_cfg, device=DEVICE).eval()
    model.load_state_dict(ref_model.state_dict())
    args = _args(batch, DEVICE)

    def forward():
        with torch.inference_mode():
            return model(*args, with_projections=False).out.float().cpu()

    with _no_tf32():
        ops.reset_counts()
        got = forward()
        launches, plain_cuda = dict(ops.LAUNCHES), dict(ops.PLAIN_ON_CUDA)
        faults = {}
        for fault in F32_FAULTS:
            with _planted(fault):
                faults[fault] = rel_l2(forward(), ref)
    rel = rel_l2(got, ref)
    s, b = ref.shape[-1], ref.shape[0]
    print(f"parity {s}^3 b={b} float32: rel L2(out) = {rel:.4e} (limit {F32_PARITY_TOL}); "
          f"planted faults: " + ", ".join(f"{k} {v:.4e} ({v / F32_PARITY_TOL:.1f}x)"
                                          for k, v in faults.items())
          + f"; launches {launches}; plain on cuda {plain_cuda}")
    check(bool(torch.isfinite(got).all()), "parity float32: non-finite GPU output")
    check(rel <= F32_PARITY_TOL, f"parity float32: rel L2 {rel} > {F32_PARITY_TOL}")
    for fault, e in faults.items():
        check(e > F32_PARITY_TOL, f"parity float32: the planted fault {fault} reads {e}")
    for family in ops.FWD_FAMILIES_F32:
        check(launches.get(family, 0) > 0, f"parity float32: {family} did not launch")
    check(not any(launches.get(f, 0) for f in ops.FWD_FAMILIES),
          f"parity float32: a bf16 kernel launched: {launches}")
    check(sum(plain_cuda.values()) == 0, f"parity float32: plain on the GPU: {plain_cuda}")
    del model


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


def _loss_and_grads(model, batch: dict, device, loss_config=None) -> tuple:
    from coma_unet_tpu_torch import LossConfig
    from coma_unet_tpu_torch.train import make_loss_fn

    model.train()
    model.zero_grad(set_to_none=True)
    tb = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
    roi_w = torch.full((36,), 225.0, device=device)
    t0 = time.perf_counter()
    total, metrics = make_loss_fn(model, loss_config or LossConfig())(tb, roi_w)
    total.backward()
    loss = float(total.detach())
    grads = {n: None if p.grad is None else p.grad.detach().float().cpu()
             for n, p in model.named_parameters()}
    return loss, float(metrics["tcds_loss"]), grads, time.perf_counter() - t0


def _with_partners(batch: dict, rng: np.random.Generator) -> dict:
    """`batch` with pos_*/neg_* partners (the tCDS triplets): volumes and
    covariates of their own, distinct from the anchors'."""
    b, s = batch["mri"].shape[0], batch["mri"].shape[-1]
    for role in ("pos_", "neg_"):
        other = _batch(rng, b=b, s=s)
        for k in ("mri", "covars", "roi_loc", "roi_std", "roi_compact"):
            batch[role + k] = other[k]
    return batch


def phase_gradients(b: int = 2, tcds: bool = False, f32: bool = False) -> None:
    """Phase 5 at batch b: at b=2 RnC is identically 0 (one pair, ranked
    against itself); at b >= 3 it must be non-zero on every route. With
    `tcds` (phase 11), the tCDS loss on (anchor, positive, negative)
    triplets whose partners differ from the anchors: three forwards and
    their backward, the tCDS term non-zero on every route. With `f32`, also
    the float32 route on the card (the float32 kernels, TF32 off) against
    the CPU f32: the loss within F32_LOSS_TOL, each gradient group within
    max(F32_GRAD_TOL, F32_GRAD_RATIO x its floor), and each of F32_FAULTS
    and F32_DW_FAULTS above one of them."""
    import dataclasses

    from coma_unet_tpu_torch import ContraAttnUNet, LossConfig, ModelConfig

    s = 64
    cfg = ModelConfig(prompt_shape=(s, s, s))
    gen = torch.Generator().manual_seed(0)
    ref_model = ContraAttnUNet(dataclasses.replace(cfg, compute_dtype="float32"),
                               device="cpu", generator=gen)
    _film_signal(ref_model, gen)
    gpu_model = ContraAttnUNet(cfg, device="cuda")
    gpu_model.load_state_dict(ref_model.state_dict())
    bf16_model = ContraAttnUNet(cfg, device="cpu")
    bf16_model.load_state_dict(ref_model.state_dict())
    rng = np.random.default_rng(1)
    batch = _batch(rng, b=b, s=s)
    batch["covars"][:, 0] = [1.0, 0.0, 1.0][:b]  # abeta+ and abeta- prompts
    loss_config = LossConfig(rnc=not tcds)
    if tcds:
        batch = _with_partners(batch, rng)
    tag = f"gradients 64^3 b={b}{' tCDS' if tcds else ''}"
    term = "tCDS" if tcds else "RnC"

    loss_gpu, rnc_gpu, g_gpu, t_gpu = _loss_and_grads(gpu_model, batch, "cuda",
                                                      loss_config)
    loss_ref, rnc_ref, g_ref, t_ref = _loss_and_grads(ref_model, batch, "cpu",
                                                      loss_config)
    loss_bf, rnc_bf, g_bf, t_bf = _loss_and_grads(bf16_model, batch, "cpu",
                                                  loss_config)
    print(f"{tag}: loss gpu {loss_gpu:.6f}, cpu f32 {loss_ref:.6f}, "
          f"cpu bf16 {loss_bf:.6f}; {term} gpu {rnc_gpu:.6f}, cpu f32 {rnc_ref:.6f}, "
          f"cpu bf16 {rnc_bf:.6f}; gpu {t_gpu:.2f} s, cpu f32 {t_ref:.1f} s, "
          f"cpu bf16 {t_bf:.1f} s")
    if b >= 3 or tcds:
        check(all(np.isfinite(v) and v != 0.0 for v in (rnc_gpu, rnc_ref, rnc_bf)),
              f"{tag}: {term} should be non-zero: {rnc_gpu}, {rnc_ref}, {rnc_bf}")
    for name, g in g_ref.items():
        if g is None:
            continue
        got = g_gpu[name]
        check(got is not None, f"gradients: {name} has a CPU gradient but none on the GPU")
        check(bool(torch.isfinite(got).all()), f"gradients: {name} non-finite on the GPU")
    rel_loss = abs(loss_gpu - loss_ref) / abs(loss_ref)
    check(rel_loss <= LOSS_TOL, f"{tag}: loss differs by {rel_loss} > {LOSS_TOL}")

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
    check(not failed, f"{tag}: groups over their limit: {failed}")
    print(f"{tag}: loss rel diff {rel_loss:.3e}; {len(groups)} groups within "
          f"limits ({len(skip)} norm-fed conv biases excluded)")
    if f32:
        _gradients_f32(ref_model, batch, loss_config, loss_ref, rnc_ref, g_ref, groups,
                       rel_l2_to, tag)


def _gradients_f32(ref_model, batch: dict, loss_config, loss_ref: float, rnc_ref: float,
                   g_ref: dict, groups: dict, rel_l2_to, tag: str) -> None:
    """Phase 5 in float32: the CPU f32 model's weights in a float32 model on
    the card, one loss and backward against the CPU f32's, then each planted
    fault. Each group's error against the same step computed in f64 on the
    CPU is printed for the card and for the CPU's f32, so that a reading
    over its limit can be told apart from a fault: a sound route reads about
    as far from f64 as the CPU's f32 does."""
    import dataclasses

    from coma_unet_tpu_torch import ContraAttnUNet
    from coma_unet_tpu_torch import ops

    cfg = dataclasses.replace(ref_model.config, compute_dtype="float32")
    model = ContraAttnUNet(cfg, device=DEVICE)
    model.load_state_dict(ref_model.state_dict())

    def reading():
        loss, rnc, grads, _ = _loss_and_grads(model, batch, DEVICE, loss_config)
        errs = {group: rel_l2_to(grads, g_ref, names) for group, names in groups.items()}
        return abs(loss - loss_ref) / abs(loss_ref), rnc, grads, errs

    # the floor: the CPU f32 route with the MRI one ulp up
    nudged = dict(batch, mri=np.nextafter(batch["mri"], np.float32(np.inf)))
    _, _, g_nudge, _ = _loss_and_grads(ref_model, nudged, "cpu", loss_config)
    floors = {group: rel_l2_to(g_nudge, g_ref, names) for group, names in groups.items()}
    limits = {group: max(F32_GRAD_TOL, F32_GRAD_RATIO * f) for group, f in floors.items()}
    # the same step in f64 on the CPU (the parameters' f32 values, every
    # operation in f64)
    f64_model = ContraAttnUNet(dataclasses.replace(ref_model.config, compute_dtype="float64"),
                               device="cpu")
    f64_model.load_state_dict(ref_model.state_dict())
    _, _, g_f64, t_f64 = _loss_and_grads(f64_model, batch, "cpu", loss_config)
    del f64_model
    cpu_f64 = {group: rel_l2_to(g_ref, g_f64, names) for group, names in groups.items()}

    with _no_tf32():
        ops.reset_counts()
        rel_loss, rnc, grads, errs = reading()
        launches, plain_cuda = dict(ops.LAUNCHES), dict(ops.PLAIN_ON_CUDA)
        faults = {}
        for fault in F32_FAULTS + F32_DW_FAULTS:
            with _planted(fault):
                f_loss, _, _, f_errs = reading()
            worst = max(f_errs, key=f_errs.get)
            faults[fault] = (f_loss, worst, f_errs[worst])
    worst = max(errs, key=lambda g: errs[g] / limits[g])
    print(f"{tag} float32: loss rel diff {rel_loss:.3e} (limit {F32_LOSS_TOL}), RnC "
          f"{rnc:.6f} vs cpu f32 {rnc_ref:.6f}; worst of {len(errs)} gradient groups "
          f"against its limit {worst} {errs[worst]:.3e} (limit {limits[worst]:.3e}, floor "
          f"{floors[worst]:.3e}); planted faults: "
          + "; ".join(f"{k}: loss {v[0]:.3e} ({v[0] / F32_LOSS_TOL:.1f}x), {v[1]} "
                      f"{v[2]:.3e} ({v[2] / limits[v[1]]:.1f}x its limit)"
                      for k, v in faults.items()))
    # columns: the card against the CPU f32, the floor and the limit; then
    # the card and the CPU f32 each against the CPU f64
    print(f"{'group':28s} {'kernels':>10s} {'floor':>10s} {'limit':>10s} "
          f"{'card-f64':>10s} {'cpu32-f64':>10s}  (f64 step {t_f64:.1f} s)")
    for group, e in errs.items():
        print(f"{group:28s} {e:10.3e} {floors[group]:10.3e} {limits[group]:10.3e} "
              f"{rel_l2_to(grads, g_f64, groups[group]):10.3e} {cpu_f64[group]:10.3e}")
    for name, g in g_ref.items():
        if g is not None:
            check(grads[name] is not None and bool(torch.isfinite(grads[name]).all()),
                  f"{tag} float32: {name} has no finite gradient on the GPU")
    check(rel_loss <= F32_LOSS_TOL, f"{tag} float32: loss differs by {rel_loss}")
    over = [g for g, e in errs.items() if e > limits[g]]
    check(not over, f"{tag} float32: groups over their limits: {over}")
    for fault, (f_loss, group, f_err) in faults.items():
        check(f_loss > F32_LOSS_TOL or f_err > limits[group],
              f"{tag} float32: the planted fault {fault} reads within the limits")
    for family in ops.PATH_FAMILIES_F32:
        check(launches.get(family, 0) > 0, f"{tag} float32: {family} did not launch")
    check(not any(launches.get(f, 0) for f in ops.PATH_FAMILIES),
          f"{tag} float32: a bf16 kernel launched: {launches}")
    check(sum(plain_cuda.values()) == 0, f"{tag} float32: plain on the GPU: {plain_cuda}")
    del model


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
    med = READINGS["train_step_ms"] = statistics.median(step_ms[1:])
    print(f"train step b=2 128^3: median {med:.2f} ms over steps 2-{TRAIN_STEPS} "
          f"({med / 2:.2f} ms/volume); all steps ms {[round(t, 2) for t in step_ms]}; "
          f"peak memory {peak:.2f} GiB")

    profile_step(lambda: step(batch, roi_w))
    return launches


PROFILE_SPINS = 16  # spin kernels a profile runs before the call it profiles


def profile_step(fn, detail: bool = True, names=SMALL_KERNELS, by_name=None) -> tuple:
    """torch.profiler over one call of `fn`: wall time, summed kernel time,
    the device's idle share and, with `detail`, the top 10 kernels by device
    time and the time of each kernel of `names`; `by_name`, a dict, is
    filled with each kernel name's (ms, records). Returns (wall ms, kernel
    ms)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        # spin kernels first, left out of the counts below: a profile that
        # follows others in the process can miss the first kernels of its
        # call, and misses fewer after them (phase 15 prints any gap)
        for _ in range(PROFILE_SPINS):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
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
                      if e.device_type == torch.autograd.DeviceType.CUDA
                      and "spin_kernel" not in e.key),
                     key=device_us, reverse=True)
    total = sum(device_us(e) for e in kernels) / 1e3
    if not detail:
        return wall, total
    print(f"profiled step: {wall:.2f} ms wall, {total:.2f} ms summed kernel time "
          f"(device idle share {max(0.0, 1 - total / wall):.3f}); top 10 kernels:")
    for e in kernels[:10]:
        print(f"  {device_us(e) / 1e3:9.3f} ms  x{e.count:<5d} {e.key[:100]}")
    # every instantiation of a kernel together: its name without namespace,
    # template arguments and parameters
    by_name = {} if by_name is None else by_name
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
        for name in names))
    return wall, total


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


def _cli(argv, peaks: dict, name: str = "") -> tuple:
    """The CLI's `main(argv)` in this process, as if in its own: (return
    code, standard output, seconds), the output echoed; its peak device
    memory goes into `peaks` under `name` (default: the command's), and
    what it left behind is collected before the next."""
    import contextlib
    import gc
    import io

    from coma_unet_tpu_torch.cli import main as cli_main

    out = io.StringIO()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = cli_main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    name = name or argv[0] + (" (resume)" if "-resume_training" in argv else "")
    peaks[name] = torch.cuda.max_memory_allocated() / 2**30
    gc.collect()
    torch.cuda.empty_cache()
    print(out.getvalue(), end="")
    return rc, out.getvalue(), seconds


def _validate_matches_csv(got: dict, run: str, tag: str) -> float:
    """`validate`'s printed overall metrics (`got`) against the epoch-2 column
    of the training run's CSVs, within METRIC_TOL plus a floor of 1e-6 of the
    key's largest value. avg_corr averages ROI correlations near +-1 that may
    cancel to 0, so its floor is 1e-6 of the largest ROI correlation, not of
    the mean. Returns the worst relative error."""
    import os

    from coma_unet_tpu_torch.data.table import read_csv, to_numeric

    def csv(key):
        return to_numeric(read_csv(os.path.join(
            run, "validation_metric_results", f"{key}.csv"))["epoch_2"])

    worst = 0.0
    for key in ("mae", "mape", "avg_corr", "roi_maes", "roi_mapes"):
        want = csv(key)
        have = np.atleast_1d(np.asarray(got[key], np.float64))
        scale = np.nan_to_num(csv("roi_corr")) if key == "avg_corr" else want
        floor = 1e-6 * float(np.abs(scale).max())
        err = np.abs(have - want)
        check(bool((err <= METRIC_TOL * np.abs(want) + floor).all()),
              f"{tag}: validate {key} {have} vs the run's epoch-2 CSV {want}")
        worst = max(worst, float((err / (np.abs(want) + floor + 1e-30)).max()))
    return worst


def phase_loop() -> dict:
    """The slice's main path: train, resume, validate and infer through the
    CLI on a synthetic 128^3 cohort, the flagship at full width."""
    import gc
    import importlib.util
    import os
    import shutil
    import tempfile

    from coma_unet_tpu_torch import ExperimentConfig, ROI_INDICES, TrainConfig
    from coma_unet_tpu_torch import ops
    from coma_unet_tpu_torch.data.synthetic import make_synthetic_cohort
    from coma_unet_tpu_torch.data.table import read_csv, write_rows
    from coma_unet_tpu_torch.io import load_nifti_vol
    from coma_unet_tpu_torch.models.contra import ContraAttnUNet
    from coma_unet_tpu_torch.train import create_train_state
    from coma_unet_tpu_torch.train import loop
    from coma_unet_tpu_torch.train.checkpoint import CheckpointManager, load_checkpoint

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="coma_loop_")
    try:
        free_gb = shutil.disk_usage(tmp).free / 1e9
        print(f"loop: temp dir {tmp}, {free_gb:.1f} GB free; pandas "
              f"{'present' if importlib.util.find_spec('pandas') else 'absent'}, "
              f"matplotlib "
              f"{'present' if importlib.util.find_spec('matplotlib') else 'absent'}")
        t0 = time.perf_counter()
        cohort = make_synthetic_cohort(os.path.join(tmp, "cohort"), n_subjects=6,
                                       size=128, num_rois=len(ROI_INDICES))
        rows = read_csv(cohort["lookup"]).rows()
        splits = os.path.join(tmp, "splits")
        os.makedirs(splits)
        test_csv = os.path.join(splits, "test_lookup_4.csv")
        write_rows(os.path.join(splits, "training_lookup_4.csv"), rows[:4])
        write_rows(test_csv, rows[4:])
        cohort_s = time.perf_counter() - t0

        def config_file(epochs):
            cfg = ExperimentConfig(train=TrainConfig(epochs=epochs, batch_size=2,
                                                     val_iter=1, checkpoint_iter=1),
                                   save_path=os.path.join(tmp, "results"))
            path = os.path.join(tmp, f"config_{epochs}.json")
            with open(path, "w") as f:
                f.write(cfg.to_json())
            return path

        tables = ["--covariate_csv", cohort["cov"], "--quartile_csv", cohort["quart"],
                  "--predictions_json", cohort["preds"]]
        peaks: dict = {}

        # the main path: counts from 0 before train, read after infer
        ops.reset_counts()
        rc, _, train_s = _cli(["train", "--config", config_file(2), "--splits_dir",
                               splits, "--fold", "4"] + tables, peaks)
        check(rc == 0, f"loop: train returned {rc}")
        run1 = dict(loop.LAST_RUN)
        train_launches = dict(ops.LAUNCHES)
        (run_name,) = os.listdir(os.path.join(tmp, "results"))
        run = os.path.join(tmp, "results", run_name)
        ckpts = os.path.join(run, "checkpoints")
        names = sorted(os.listdir(ckpts))
        check(names == ["checkpoint_epoch_0", "checkpoint_epoch_1",
                        "checkpoint_latest_epoch"], f"loop: checkpoints {names}")
        losses = [v for e in run1["epochs"] for v in e["losses"]]
        check(len(losses) == 4 and all(np.isfinite(losses)),
              f"loop: losses {losses}")
        for name in ("mae", "mape", "roi_mapes", "roi_corr"):
            cols = read_csv(os.path.join(run, "validation_metric_results",
                                         f"{name}.csv")).columns
            check(cols == ["epoch_0", "epoch_1"], f"loop: {name}.csv columns {cols}")
        for epoch in (0, 1):
            files = os.listdir(os.path.join(run, f"{epoch}_output_samples"))
            for kind in ("_pred.nii", "_gt.nii"):
                check(sum(f.endswith(kind) for f in files) == 2,
                      f"loop: epoch {epoch} samples {sorted(files)}")
        latest = os.path.join(ckpts, "checkpoint_latest_epoch")
        saved = load_checkpoint(latest)
        weights = saved["roi_weights"]
        check(saved["step"] == 4 and saved["epoch"] == 1,
              f"loop: step {saved['step']}, epoch {saved['epoch']}")
        check(bool(torch.isfinite(weights).all()) and float(weights.std()) > 0
              and not bool((weights == 225.0).any()),
              f"loop: ROI weights not adapted: {weights}")
        ckpt_mb = os.path.getsize(latest) / 1e6

        # restore: the checkpoint's parameters, bit for bit
        cfg2 = ExperimentConfig.from_json(open(config_file(2)).read()).normalized()
        model = ContraAttnUNet(cfg2.model, device=DEVICE)
        t0 = time.perf_counter()
        state, epoch, _ = CheckpointManager(run).restore(
            create_train_state(model, cfg2.train.lr), latest)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        for name, value in model.state_dict().items():
            check(torch.equal(value.cpu(), saved["model"][name]),
                  f"loop: restored {name} differs from the checkpoint")
        check(state.step == 4 and epoch == 1, f"loop: restored step {state.step}")
        del model, state, saved
        gc.collect()  # the optimizer holds cycles: free its device state now
        torch.cuda.empty_cache()

        rc, _, resume_s = _cli(["train", "--config", config_file(3), "--splits_dir",
                                splits, "--fold", "4", "-resume_training",
                                "-checkpoint_path", latest] + tables, peaks)
        check(rc == 0, f"loop: resume returned {rc}")
        run2 = dict(loop.LAST_RUN)
        check([e["epoch"] for e in run2["epochs"]] == [2],
              f"loop: resumed epochs {[e['epoch'] for e in run2['epochs']]}")
        resumed = os.path.join(tmp, "results", f"native_target_finetune_{run_name}")
        epoch2 = os.path.join(resumed, "checkpoints", "checkpoint_epoch_2")
        payload = load_checkpoint(epoch2)
        check(payload["step"] == 6, f"loop: step after the resume {payload['step']}")
        losses2 = run2["epochs"][0]["losses"]
        check(all(np.isfinite(losses2)), f"loop: resumed losses {losses2}")
        del payload
        os.remove(os.path.join(ckpts, "checkpoint_epoch_0"))  # disk

        rc, out, validate_s = _cli(["validate", "--config", config_file(3),
                                    "--test_lookup", test_csv, "-checkpoint_path",
                                    epoch2, "-save_path", os.path.join(tmp, "val")]
                                   + tables, peaks)
        check(rc == 0, f"loop: validate returned {rc}")
        got = next(json.loads(line) for line in out.splitlines()
                   if line.startswith('{"validate"'))["validate"]
        worst = _validate_matches_csv(got, resumed, "loop")

        rc, _, infer_s = _cli(["infer", "--config", config_file(3), "--input_lookup",
                               test_csv, "-checkpoint_path", epoch2, "--out_dir",
                               os.path.join(tmp, "synth")] + tables, peaks)
        check(rc == 0, f"loop: infer returned {rc}")
        synth = sorted(os.listdir(os.path.join(tmp, "synth")))
        check(len(synth) == 2 and all(f.endswith("_synth_tau.nii") for f in synth),
              f"loop: infer wrote {synth}")
        for f in synth:
            vol = load_nifti_vol(os.path.join(tmp, "synth", f), resize=False)
            check(vol.shape == (1, 128, 128, 128) and bool(np.isfinite(vol).all()),
                  f"loop: {f} {vol.shape}")
        launches, plain_cuda = dict(ops.LAUNCHES), dict(ops.PLAIN_ON_CUDA)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    print(f"loop launches (train, resume, validate, infer): {launches}; "
          f"in the first train alone: {train_launches}; plain on cuda: {plain_cuda}")
    for family in ops.PATH_FAMILIES:
        check(train_launches.get(family, 0) > 0, f"{family}: no launch in the loop")
    check(sum(plain_cuda.values()) == 0, f"plain versions ran on the GPU: {plain_cuda}")
    print(f"loop losses: {[round(v, 4) for v in losses]}, resumed {[round(v, 4) for v in losses2]}; "
          f"ROI weights after epoch 1: mean {float(weights.mean()):.3f}, "
          f"min {float(weights.min()):.3f}, max {float(weights.max()):.3f}")
    steps = [t for e in run1["epochs"] + run2["epochs"] for t in e["step_ms"]]
    for e in run1["epochs"] + run2["epochs"]:
        busy = e["wait_s"] + e["step_s"]
        print(f"loop epoch {e['epoch']}: {e['seconds']:.2f} s; steps ms "
              f"{[round(t, 2) for t in e['step_ms']]}; loader wait {e['wait_s']:.3f} s "
              f"of {busy:.3f} s ({e['wait_s'] / busy:.1%}); validate "
              f"{e['validate_s']:.2f} s; checkpoint saves {e['checkpoint_s']:.2f} s")
    epochs = run1["epochs"] + run2["epochs"]
    READINGS["loop_wait_share"] = [e["wait_s"] / (e["wait_s"] + e["step_s"])
                                   for e in epochs]
    per_step = [1e3 * (e["wait_s"] + e["step_s"]) / len(e["step_ms"]) for e in epochs]
    print(f"loop step b=2 128^3: median {statistics.median(steps[1:]):.2f} ms over "
          f"steps 2-{len(steps)} (from a batch's arrival to the request for the next); "
          f"with the loader's wait {[round(t, 2) for t in per_step]} ms a step by "
          f"epoch; phase 7's synchronized step "
          f"{READINGS.get('train_step_ms', float('nan')):.2f} ms")
    print(f"loop: cohort {cohort_s:.2f} s; train {train_s:.2f} s; checkpoint "
          f"{ckpt_mb:.1f} MB, restore {restore_s:.2f} s (the resume's own "
          f"{run2['restore_s']:.2f} s); resume {resume_s:.2f} s; validate "
          f"{validate_s:.2f} s (worst rel {worst:.2e} against the CSV, tol "
          f"{METRIC_TOL}); infer {infer_s:.2f} s; peak memory GiB "
          f"{ {k: round(v, 2) for k, v in peaks.items()} }; "
          f"phase {time.perf_counter() - t_phase:.1f} s")
    return launches


def _loader_split(ds, predictions, triplets: bool) -> dict:
    """The host time of one b=2 batch of `ds` (samples 0 and 1), part by
    part on this thread, ms: reading (read, resample to 2 mm, center
    pad/crop) with the numpy reader and with the native one (a subject's 3
    files in one call, as the dataset reads them), masking the MRI by its
    ROI, ROI compaction, the rest of `collate` and pinning; then the
    loader's own time a batch (4 workers, partners drawn, prefetch 2) over
    one pass."""
    from coma_unet_tpu_torch.data import DataLoader, collate, compact_roi_np, pin_batch
    from coma_unet_tpu_torch.io import load_nifti_vol
    from coma_unet_tpu_torch.ops.preprocess import center_pad_crop
    from coma_unet_tpu_torch.runtime import load_batch_native, native

    native.library()  # built before the clock starts
    drawn = [(i, ds.draw(i) if triplets else None) for i in (0, 1)]
    subjects = [j for i, d in drawn for j in ([i] + ([d["pos"], d["negs"][0]] if d else []))]
    paths = [p for j in subjects for p in ds._paths(j)]
    ms = {}

    def timed(key, fn):
        t0 = time.perf_counter()
        out = fn()
        ms[key] = ms.get(key, 0.0) + (time.perf_counter() - t0) * 1e3
        return out

    plain = timed("read numpy", lambda: [center_pad_crop(load_nifti_vol(p), ds.pad_dims)
                                         for p in paths])
    vols = timed("read native", lambda: [v[None] for k in range(0, len(paths), 3)
                                         for v in load_batch_native(
                                             paths[k:k + 3], ds.pad_dims, num_threads=3)])
    check(all(np.array_equal(a, b) for a, b in zip(vols, plain)),
          "loader split: the native reader differs from the numpy reader")
    t0 = time.perf_counter()
    for k in range(0, len(vols), 3):
        mri = vols[k].copy()
        mri[vols[k + 2] == 0] = 0
    ms["mask"] = (time.perf_counter() - t0) * 1e3
    rois = np.stack([vols[k + 2][0] for k in range(0, len(vols), 3)])
    timed("ROI compaction", lambda: compact_roi_np(rois))
    samples = [ds.load(i, d) for i, d in drawn]
    batch = timed("collate", lambda: collate(samples, predictions, triplets))
    ms["collate"] -= ms["ROI compaction"]  # collate compacts the ROIs too
    timed("pin", lambda: pin_batch(batch))
    loader = DataLoader(ds, 2, predictions=predictions, with_triplets=triplets,
                        num_workers=4, device_put=pin_batch)
    t0 = time.perf_counter()
    n = sum(1 for _ in loader)
    ms["loader a batch"] = (time.perf_counter() - t0) * 1e3 / n
    ms["files"] = len(paths)
    return ms


def phase_tcds() -> dict:
    """Phase 11: the tCDS loss and the data options of the CLI on the card.
    Returns the launches of its main path, the CLI's tCDS `train`."""
    import gc
    import os
    import shutil
    import tempfile
    from collections import Counter

    from coma_unet_tpu_torch import (
        ContraAttnUNet,
        ExperimentConfig,
        LossConfig,
        ModelConfig,
        ROI_INDICES,
        TrainConfig,
    )
    from coma_unet_tpu_torch import data as pdata
    from coma_unet_tpu_torch import ops
    from coma_unet_tpu_torch.data.cohorts import load_cohort_dataset
    from coma_unet_tpu_torch.data.synthetic import (
        make_synthetic_cohort,
        make_synthetic_cohort_bundle,
    )
    from coma_unet_tpu_torch.data.table import read_csv, write_rows
    from coma_unet_tpu_torch.io import read_nifti
    from coma_unet_tpu_torch.train import create_train_state, loop, make_train_step

    t_phase = time.perf_counter()
    phase_gradients(b=2, tcds=True)
    grad_s = time.perf_counter() - t_phase

    # the synchronized tCDS step at 128^3 b=2: three forwards and their backward
    model = ContraAttnUNet(ModelConfig(), device="cuda",
                           generator=torch.Generator().manual_seed(0))
    state = create_train_state(model, 1e-3)
    step = make_train_step(model, LossConfig(rnc=False), state.optimizer)
    rng = np.random.default_rng(0)
    roi_w = torch.full((36,), 225.0, device="cuda")
    # every step takes fresh triplets, so the hinge cannot fit one batch and
    # must stay live on all of them
    batches = [_with_partners(_batch(rng, b=2, s=128), rng) for _ in range(TCDS_STEPS)]
    batch = None
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_counts()
    losses, terms, step_ms = [], [], []
    for host_batch in batches:
        del batch
        batch = {k: torch.as_tensor(v, device="cuda") for k, v in host_batch.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = step(batch, roi_w)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(metrics["loss"]))
        terms.append(float(metrics["tcds_loss"]))
    step_launches, plain_cuda = dict(ops.LAUNCHES), dict(ops.PLAIN_ON_CUDA)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"tCDS train losses: {[round(v, 6) for v in losses]}; tCDS terms "
          f"{[round(v, 6) for v in terms]}")
    print(f"tCDS launches over {TCDS_STEPS} steps: {step_launches}; plain on cuda: "
          f"{plain_cuda}")
    check(all(np.isfinite(losses)) and all(np.isfinite(terms)),
          f"tCDS: non-finite loss {losses} {terms}")
    check(all(v != 0.0 for v in terms), f"tCDS: the triplet term is 0: {terms}")
    for family in ops.PATH_FAMILIES:
        check(step_launches.get(family, 0) > 0, f"{family}: no launch in the tCDS step")
    check(sum(plain_cuda.values()) == 0, f"plain versions ran on the GPU: {plain_cuda}")
    med = statistics.median(step_ms[1:])
    wall, kernel = profile_step(lambda: step(batch, roi_w))
    print(f"tCDS train step b=2 128^3: median {med:.2f} ms over steps 2-{TCDS_STEPS} "
          f"(phase 7's RnC step {READINGS.get('train_step_ms', float('nan')):.2f} ms); "
          f"all steps ms {[round(t, 2) for t in step_ms]}; profiled {wall:.2f} ms wall, "
          f"{kernel:.2f} ms kernel time, idle share {max(0.0, 1 - kernel / wall):.3f} "
          f"(against the median step {max(0.0, 1 - kernel / med):.3f}); "
          f"peak memory {peak:.2f} GiB")
    del model, state, step, batch, batches, metrics
    gc.collect()  # the optimizer holds cycles: free its device state now
    torch.cuda.empty_cache()

    tmp = tempfile.mkdtemp(prefix="coma_tcds_")
    try:
        t0 = time.perf_counter()
        cohort = make_synthetic_cohort(os.path.join(tmp, "cohort"), n_subjects=10,
                                       size=128, num_rois=len(ROI_INDICES))
        rows = read_csv(cohort["lookup"]).rows()
        splits = os.path.join(tmp, "splits")
        os.makedirs(splits)
        train_csv = os.path.join(splits, "training_lookup_4.csv")
        write_rows(train_csv, rows[:8])
        write_rows(os.path.join(splits, "test_lookup_4.csv"), rows[8:])
        cohort_s = time.perf_counter() - t0
        tables = [pdata.CovariateTable(cohort["cov"]), pdata.QuartileTable(cohort["quart"]),
                  pdata.PredictionTable(cohort["preds"])]

        def dataset():
            return pdata.PredictedMetaTauDataset(train_csv, *tables[:2],
                                                 meta_tau_table=tables[2])

        # every (abeta, quartile) cell of the training split holds two
        # subjects or more: no anchor is its own positive over the 3
        # passes a 2-epoch run draws
        ds = dataset()
        cells = Counter(ds._key)
        self_pos = sum(ds.draw(i)["pos"] == i for _ in range(3) for i in range(len(ds)))
        print(f"tCDS cohort: {len(ds)} training subjects in cells {dict(cells)}; "
              f"anchors drawn as their own positive: {self_pos}")
        check(min(cells.values()) >= 2 and self_pos == 0,
              f"tCDS: cells {dict(cells)}, {self_pos} self-positives")
        splits_ms = {kind: _loader_split(dataset(), tables[2], kind == "tcds")
                     for kind in ("rnc", "tcds")}
        for kind, ms in splits_ms.items():
            print(f"loader split, one b=2 batch ({kind}, {ms.pop('files')} files of "
                  f"128^3), ms: " + "; ".join(f"{k} {v:.2f}" for k, v in ms.items()))

        cfg = ExperimentConfig(loss=LossConfig(rnc=False),
                               train=TrainConfig(epochs=2, batch_size=2, val_iter=1),
                               save_path=os.path.join(tmp, "results"))
        cfg_path = os.path.join(tmp, "config.json")
        with open(cfg_path, "w") as f:
            f.write(cfg.to_json())
        peaks: dict = {}
        # the main path: counts from 0 before train, read after it
        ops.reset_counts()
        rc, _, train_s = _cli(["train", "--config", cfg_path, "--splits_dir", splits,
                               "--fold", "4", "--covariate_csv", cohort["cov"],
                               "--quartile_csv", cohort["quart"], "--predictions_json",
                               cohort["preds"]], peaks)
        launches, plain_cuda = dict(ops.LAUNCHES), dict(ops.PLAIN_ON_CUDA)
        check(rc == 0, f"tCDS: train returned {rc}")
        run = dict(loop.LAST_RUN)
        cli_losses = [v for e in run["epochs"] for v in e["losses"]]
        check(len(run["epochs"]) == 2 and len(cli_losses) == 8
              and all(np.isfinite(cli_losses)), f"tCDS: losses {cli_losses}")
        (run_name,) = os.listdir(os.path.join(tmp, "results"))
        for sub in ("", "pos_metrics", "neg_metrics"):
            cols = read_csv(os.path.join(tmp, "results", run_name, sub,
                                         "validation_metric_results", "mape.csv")).columns
            check(cols == ["epoch_0", "epoch_1"], f"tCDS: {sub} mape.csv {cols}")
        print(f"tCDS loop launches (train): {launches}; plain on cuda: {plain_cuda}")
        for family in ops.PATH_FAMILIES:
            check(launches.get(family, 0) > 0, f"{family}: no launch in the tCDS loop")
        check(sum(plain_cuda.values()) == 0, f"plain versions ran on the GPU: {plain_cuda}")

        # infer --cohort --save_attention: each psi map against the forward's
        bundle = make_synthetic_cohort_bundle(os.path.join(tmp, "bundle"), "ucsf",
                                              n_subjects=2, size=128)
        out = os.path.join(tmp, "synth")
        rc, _, infer_s = _cli(["infer", "--config", cfg_path, "--cohort", "ucsf",
                               "--cohort_dir", bundle, "--out_dir", out,
                               "--save_attention"], peaks)
        check(rc == 0, f"tCDS: infer --cohort returned {rc}")
        ref = ExperimentConfig.from_json(open(cfg_path).read()).normalized()
        model = ContraAttnUNet(ref.model, device="cuda",
                               generator=torch.Generator().manual_seed(ref.train.seed))
        cohort_ds = load_cohort_dataset("ucsf", bundle, pad_dims=ref.data.volume_shape)
        worst, maps = 0.0, 0
        for b in pdata.DataLoader(cohort_ds, 1, predictions=cohort_ds.meta_tau_table):
            sid = b["sample_ids"][0]
            synth = read_nifti(os.path.join(out, f"{sid}_synth_tau.nii")).data_zyx
            check(synth.shape == (128, 128, 128) and bool(np.isfinite(synth).all()),
                  f"tCDS: infer wrote {synth.shape} for {sid}")
            with torch.inference_mode():
                outs = model(*_args(b, "cuda"), with_projections=False)
            for level, psi in enumerate(outs.attention):
                got = read_nifti(os.path.join(out, "attention",
                                              f"{sid}_attn_level{level}.nii")).data_zyx
                want = psi[0, 0].float().cpu().numpy()
                check(got.shape == want.shape, f"tCDS: {sid} level {level} {got.shape}")
                worst = max(worst, float(np.abs(got - want).max()))
                maps += 1
        written = len(os.listdir(os.path.join(out, "attention")))
        check(written == maps and maps > 0, f"tCDS: {written} maps written, {maps} levels")
        check(worst <= ATTN_TOL, f"tCDS: psi maps differ from the forward's by {worst}")
        del model
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    for e in run["epochs"]:
        busy = e["wait_s"] + e["step_s"]
        print(f"tCDS loop epoch {e['epoch']}: {e['seconds']:.2f} s; steps ms "
              f"{[round(t, 2) for t in e['step_ms']]}; loader wait {e['wait_s']:.3f} s "
              f"of {busy:.3f} s ({e['wait_s'] / busy:.1%}); validate "
              f"{e['validate_s']:.2f} s; checkpoint saves {e['checkpoint_s']:.2f} s")
    steps = [t for e in run["epochs"] for t in e["step_ms"]]
    shares = [e["wait_s"] / (e["wait_s"] + e["step_s"]) for e in run["epochs"]]
    print(f"loader-wait share by epoch: phase 10 (RnC) "
          f"{[round(v, 3) for v in READINGS.get('loop_wait_share', [])]}, phase 11 "
          f"(tCDS) {[round(v, 3) for v in shares]}; tCDS loop step median "
          f"{statistics.median(steps[1:]):.2f} ms over steps 2-{len(steps)}")
    print(f"tCDS: gradient check {grad_s:.1f} s; cohort {cohort_s:.2f} s; train "
          f"{train_s:.2f} s; infer --cohort --save_attention {infer_s:.2f} s ({maps} psi "
          f"maps within {worst:.2e} of the forward's, tol {ATTN_TOL}); peak memory GiB "
          f"{ {k: round(v, 2) for k, v in peaks.items()} }; "
          f"phase {time.perf_counter() - t_phase:.1f} s")
    return launches


def _film_signal(model, gen: torch.Generator) -> None:
    """FiLM starts at zero: give it and the routing a signal."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            if ".film." in name or ".route." in name:
                p.add_(0.5 * torch.randn(p.shape, generator=gen).to(p.device))


def _baseline_parity(name: str, s: int = 32, b: int = 2) -> float:
    """Phase 12 (a): the bf16 forward of `name` on the card against its f32
    forward on the CPU, same weights, at s^3 batch b: rel L2 of `out`
    within PARITY_TOL (5e-2), as phase 4 holds the flagship, unless bf16
    rounding alone exceeds it; then, as phase 8 holds the template model,
    within PARITY_RATIO x the error of the same weights run in bf16 through
    the plain versions on the CPU. That happens here: the instance norms of
    the transformer decoders subtract their mean in bf16, and
    AttnSwinUnetr's plain bf16 CPU route read 8.42e-2 at 32^3 on the H100's
    host, the card 7.14e-2."""
    import dataclasses

    from coma_unet_tpu_torch import ModelConfig, apply_model, build_model

    cfg = ModelConfig(prompt_shape=(s, s, s))
    gen = torch.Generator().manual_seed(0)
    ref = build_model(name, dataclasses.replace(cfg, compute_dtype="float32"),
                      device="cpu", generator=gen).eval()
    _film_signal(ref, gen)
    model = build_model(name, cfg, device=DEVICE).eval()
    model.load_state_dict(ref.state_dict())
    plain_bf16 = build_model(name, cfg, device="cpu").eval()
    plain_bf16.load_state_dict(ref.state_dict())
    batch = _batch(np.random.default_rng(1), b=b, s=s)
    with torch.inference_mode():
        got = apply_model(model, *_args(batch, DEVICE),
                          with_projections=False).out.float().cpu()
        want = apply_model(ref, *_args(batch, "cpu"), with_projections=False).out
        base_out = apply_model(plain_bf16, *_args(batch, "cpu"),
                               with_projections=False).out.float()
    norm = torch.linalg.vector_norm(want).item()
    rel = torch.linalg.vector_norm(got - want).item() / norm
    base = torch.linalg.vector_norm(base_out - want).item() / norm
    limit = max(PARITY_RATIO * base, PARITY_TOL)
    params = sum(p.numel() for p in ref.parameters())
    print(f"baseline parity {name} {s}^3 b={b}: rel L2(out) = {rel:.4e} (limit "
          f"{limit:.4e}); plain bf16 on CPU vs f32: {base:.4e} (ratio "
          f"{rel / base:.4f}); {params / 1e6:.2f} M parameters; max|ref| "
          f"{want.abs().max().item():.4f}")
    check(tuple(got.shape) == (b, 1, s, s, s), f"{name}: out {tuple(got.shape)}")
    check(bool(torch.isfinite(got).all()) and norm > 0, f"{name}: degenerate output")
    check(rel <= limit, f"{name}: parity rel L2 {rel} > {limit}")
    return rel


def _baseline_batch_norm(name: str, s: int = 32, b: int = 2) -> None:
    """Phase 12 (a): `name` with batch norm on the card: a train step moves
    every running statistic, an eval step leaves them as they are."""
    from coma_unet_tpu_torch import LossConfig, ModelConfig, build_model
    from coma_unet_tpu_torch.train import (
        create_train_state,
        make_eval_step,
        make_train_step,
    )

    model = build_model(name, ModelConfig(prompt_shape=(s, s, s), norm="batch"),
                        device=DEVICE, generator=torch.Generator().manual_seed(0))
    _film_signal(model, torch.Generator().manual_seed(1))

    def running():
        return {k: v.clone() for k, v in model.state_dict().items()
                if k.endswith((".bnorm.mean", ".bnorm.var"))}

    state = create_train_state(model, 1e-3)
    step = make_train_step(model, LossConfig(), state.optimizer)
    batch = {k: torch.as_tensor(v, device=DEVICE)
             for k, v in _batch(np.random.default_rng(2), b=b, s=s).items()}
    before = running()
    loss = float(step(batch, torch.full((36,), 225.0, device=DEVICE))["loss"])
    trained = running()
    make_eval_step(model, 36)(batch)
    after = running()
    moved = sum(not torch.equal(before[k], trained[k]) for k in before)
    kept = sum(torch.equal(trained[k], after[k]) for k in before)
    print(f"baseline batch norm {name} {s}^3 b={b}: loss {loss:.6f}; {moved} of "
          f"{len(before)} running statistics moved in the train step, {kept} "
          f"unchanged by the eval step")
    check(np.isfinite(loss) and loss != 0.0, f"{name} batch norm: loss {loss}")
    check(len(before) > 0 and moved == len(before),
          f"{name}: {len(before) - moved} running statistics did not move")
    check(kept == len(before), f"{name}: the eval step moved running statistics")


def _baseline_times(name: str, s: int = 128, b: int = 2) -> tuple:
    """Phase 12 (b): `name` at s^3 batch b on the card: forward, train
    steps, peak memory and a profiled step. Returns the launches and the
    plain calls on CUDA of its forwards and steps."""
    from coma_unet_tpu_torch import (
        LossConfig,
        ModelConfig,
        apply_model,
        build_model,
        ops,
    )
    from coma_unet_tpu_torch.train import create_train_state, make_train_step

    model = build_model(name, ModelConfig(prompt_shape=(s, s, s)), device=DEVICE,
                        generator=torch.Generator().manual_seed(0))
    batch = {k: torch.as_tensor(v, device=DEVICE)
             for k, v in _batch(np.random.default_rng(0), b=b, s=s).items()}
    args = _args(batch, DEVICE)
    roi_w = torch.full((36,), 225.0, device=DEVICE)
    state = create_train_state(model, 1e-3)
    step = make_train_step(model, LossConfig(), state.optimizer)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    ops.reset_counts()
    model.eval()
    with torch.inference_mode():
        fwd_ms = median_ms(lambda: apply_model(model, *args, with_projections=False),
                           reps=10)
    losses, step_ms = [], []
    for _ in range(BASELINE_STEPS):
        t0 = time.perf_counter()
        metrics = step(batch, roi_w)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(metrics["loss"]))
    launches, plain_cuda = dict(ops.LAUNCHES), dict(ops.PLAIN_ON_CUDA)
    peak = torch.cuda.max_memory_allocated() / 2**30
    missing = [n for n, p in model.named_parameters()
               if p.grad is None or not bool(torch.isfinite(p.grad).all())]
    wall, kernel_ms = profile_step(lambda: step(batch, roi_w), detail=False)
    med = statistics.median(step_ms[1:])
    params = sum(p.numel() for p in model.parameters())
    print(f"baseline {name} {s}^3 b={b}: forward median {fwd_ms:.2f} ms; train "
          f"step median {med:.2f} ms over steps 2-{BASELINE_STEPS} (all "
          f"{[round(t, 2) for t in step_ms]}); profiled step {wall:.2f} ms wall, "
          f"{kernel_ms:.2f} ms kernel time, idle share "
          f"{max(0.0, 1 - kernel_ms / wall):.3f}; peak memory {peak:.2f} GiB; "
          f"losses {[round(v, 4) for v in losses]}; {params / 1e6:.2f} M parameters")
    print(f"baseline {name} launches: {launches}; plain on cuda: {plain_cuda}")
    check(all(np.isfinite(v) and v != 0.0 for v in losses),
          f"{name}: train losses {losses}")
    check(not missing, f"{name}: parameters without a finite gradient: {missing[:8]}")
    READINGS.setdefault("baselines", {})[name] = dict(
        forward_ms=fwd_ms, step_ms=med, kernel_ms=kernel_ms,
        idle=max(0.0, 1 - kernel_ms / wall), peak_gib=peak)
    return launches, plain_cuda


def phase_baselines(s: int = 128, parity_s: int = 32) -> dict:
    """Phase 12: the registry's baselines on the card, timed and driven
    through the CLI at s^3 (parity and batch norm at parity_s^3). Returns
    the launches of AttnUNET's and GenAttnUnet's forwards and train steps,
    the baselines that run the kernels."""
    import gc
    import os
    import shutil
    import tempfile

    from coma_unet_tpu_torch import (
        DataConfig,
        ExperimentConfig,
        ModelConfig,
        ROI_INDICES,
        TrainConfig,
        ops,
    )
    from coma_unet_tpu_torch.data.synthetic import make_synthetic_cohort
    from coma_unet_tpu_torch.data.table import read_csv, write_rows
    from coma_unet_tpu_torch.io import load_nifti_vol
    from coma_unet_tpu_torch.train import loop
    from coma_unet_tpu_torch.train.checkpoint import load_checkpoint

    t_phase = time.perf_counter()
    for name in BASELINE_TYPES:
        _baseline_parity(name, s=parity_s)
        _baseline_batch_norm(name, s=parity_s)
        gc.collect()
        torch.cuda.empty_cache()
    parity_s = time.perf_counter() - t_phase

    # the main path: the kernels' counts from 0 before AttnUNET, read after
    # GenAttnUnet; each of the other five must launch none
    path: dict = {}
    for name in BASELINE_TYPES:
        launches, plain_cuda = _baseline_times(name, s=s)
        check(sum(plain_cuda.values()) == 0,
              f"{name}: plain versions ran on the GPU: {plain_cuda}")
        if name in KERNEL_BASELINES:
            for family in ops.PATH_FAMILIES:
                check(launches.get(family, 0) > 0, f"{name}: no {family} launch")
            for family, n in launches.items():
                path[family] = path.get(family, 0) + n
        else:
            check(sum(launches.values()) == 0,
                  f"{name}: launched kernels off its path: {launches}")
        gc.collect()
        torch.cuda.empty_cache()
    times_s = time.perf_counter() - t_phase - parity_s

    tmp = tempfile.mkdtemp(prefix="coma_baselines_")
    try:
        cohort = make_synthetic_cohort(os.path.join(tmp, "cohort"), n_subjects=6,
                                       size=s, num_rois=len(ROI_INDICES))
        rows = read_csv(cohort["lookup"]).rows()
        splits = os.path.join(tmp, "splits")
        os.makedirs(splits)
        test_csv = os.path.join(splits, "test_lookup_4.csv")
        write_rows(os.path.join(splits, "training_lookup_4.csv"), rows[:4])
        write_rows(test_csv, rows[4:])
        tables = ["--covariate_csv", cohort["cov"], "--quartile_csv", cohort["quart"],
                  "--predictions_json", cohort["preds"], "--device", DEVICE]
        peaks: dict = {}
        seconds: dict = {}

        def config_file(tag, epochs, norm="instance"):
            cfg = ExperimentConfig(model=ModelConfig(norm=norm),
                                   train=TrainConfig(epochs=epochs, batch_size=2,
                                                     val_iter=1, checkpoint_iter=1),
                                   data=DataConfig(volume_shape=(s, s, s)),
                                   save_path=os.path.join(tmp, tag))
            path_ = os.path.join(tmp, f"{tag}_{epochs}.json")
            with open(path_, "w") as f:
                f.write(cfg.to_json())
            return path_

        def train(tag, model_type, epochs, norm="instance", extra=()):
            what = f"train {model_type}{' (resume)' if extra else ''}"
            rc, _, secs = _cli(["train", "--config", config_file(tag, epochs, norm),
                                "--splits_dir", splits, "--fold", "4", "-model_type",
                                model_type, *extra] + tables, peaks, what)
            check(rc == 0, f"baselines: {what} returned {rc}")
            seconds[what] = secs
            losses = [v for e in loop.LAST_RUN["epochs"] for v in e["losses"]]
            check(len(losses) > 0 and all(np.isfinite(losses)),
                  f"baselines: {model_type} losses {losses}")
            return sorted(os.listdir(os.path.join(tmp, tag)))

        def infer(model_type, tag, ckpt, norm="instance"):
            out_dir = os.path.join(tmp, f"synth_{tag}")
            what = f"infer {model_type}"
            rc, _, secs = _cli(["infer", "--config", config_file(tag, 1, norm),
                                "-model_type", model_type, "--input_lookup", test_csv,
                                "-checkpoint_path", ckpt, "--out_dir", out_dir]
                               + tables, peaks, what)
            check(rc == 0, f"baselines: {what} returned {rc}")
            seconds[what] = secs
            synth = sorted(os.listdir(out_dir))
            check(len(synth) == 2, f"baselines: infer {model_type} wrote {synth}")
            for f in synth:
                vol = load_nifti_vol(os.path.join(out_dir, f), resize=False)
                check(vol.shape == (1, s, s, s) and bool(np.isfinite(vol).all()),
                      f"baselines: {model_type} {f} {vol.shape}")

        (run,) = train("unet", "UNET", 1)
        check(os.path.isfile(os.path.join(tmp, "unet", run, "train_UNET.log")),
              "baselines: no train_UNET.log")
        shutil.rmtree(os.path.join(tmp, "unet"))

        # AttnUNET with batch norm: 2 epochs, a resumed third, validate, infer
        (run,) = train("attn", "AttnUNET", 2, norm="batch")
        latest = os.path.join(tmp, "attn", run, "checkpoints", "checkpoint_latest_epoch")
        saved = load_checkpoint(latest)
        stats = [k for k in saved["model"] if k.endswith((".bnorm.mean", ".bnorm.var"))]
        check(len(stats) > 0 and saved["step"] == 4,
              f"baselines: {len(stats)} running statistics, step {saved['step']}")
        del saved
        os.remove(os.path.join(tmp, "attn", run, "checkpoints", "checkpoint_epoch_0"))
        train("attn", "AttnUNET", 3, norm="batch",
              extra=("-resume_training", "-checkpoint_path", latest))
        check([e["epoch"] for e in loop.LAST_RUN["epochs"]] == [2],
              f"baselines: resumed epochs {loop.LAST_RUN['epochs']}")
        resumed = os.path.join(tmp, "attn", f"native_target_finetune_{run}")
        epoch2 = os.path.join(resumed, "checkpoints", "checkpoint_epoch_2")
        check(load_checkpoint(epoch2)["step"] == 6, "baselines: step after the resume")
        rc, out, secs = _cli(["validate", "--config", config_file("attn", 3, "batch"),
                              "-model_type", "AttnUNET", "--test_lookup", test_csv,
                              "-checkpoint_path", epoch2, "-save_path",
                              os.path.join(tmp, "val")] + tables, peaks,
                             "validate AttnUNET")
        check(rc == 0, f"baselines: validate returned {rc}")
        seconds["validate AttnUNET"] = secs
        got = next(json.loads(line) for line in out.splitlines()
                   if line.startswith('{"validate"'))["validate"]
        worst = _validate_matches_csv(got, resumed, "baselines")
        infer("AttnUNET", "attn", epoch2, norm="batch")
        shutil.rmtree(os.path.join(tmp, "attn"))

        (run,) = train("unetr", "GenUNETR", 1)
        infer("GenUNETR", "unetr", os.path.join(
            tmp, "unetr", run, "checkpoints", "checkpoint_latest_epoch"))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"baselines CLI: validate within {worst:.2e} of the run's epoch-2 CSV "
          f"(tol {METRIC_TOL}); seconds "
          f"{ {k: round(v, 2) for k, v in seconds.items()} }; peak memory GiB "
          f"{ {k: round(v, 2) for k, v in peaks.items()} }")
    print(f"baselines launches (AttnUNET and GenAttnUnet at {s}^3): {path}")
    print(f"baselines: parity and batch norm {parity_s:.1f} s, times {times_s:.1f} s, "
          f"phase {time.perf_counter() - t_phase:.1f} s")
    return path


DP_RANKS = 2
DP_SEED = 13
DP_VALID = (1.0, 1.0, 1.0, 0.0)  # rank 0 holds two valid rows, rank 1 one
# phase 13's limits on the rel L2 of each gradient group, the 2-rank step
# against one process's b=4 step (both bf16 through the kernels, cuDNN
# deterministic): 3x what a sound run read on the H100, at least 1e-2. The
# two differ only by bf16 rounding where the kernels and cuDNN see a batch of
# 2 rather than 4. A gather whose backward drops the cross-rank sum halves
# the gradient that only the batch-coupled RnC term feeds (proj4: 0.5).
DP_GRAD_LIMITS = {
    "pos_dynamic_prompt": 0.28, "neg_dynamic_prompt": 0.29,
    "general_dynamic_prompt": 0.28, "unet.head": 0.13, "unet.down0": 0.15,
    "unet.down1": 0.15, "unet.down2": 0.15, "unet.down3": 0.14,
    "unet.up3": 0.14, "unet.gate3": 0.08, "unet.merge3": 0.13,
    "unet.up2": 0.10, "unet.gate2": 0.045, "unet.merge2": 0.062,
    "unet.up1": 0.035, "unet.gate1": 0.035, "unet.merge1": 0.018,
    "unet.up0": 0.01, "unet.gate0": 0.01, "unet.merge0": 0.01,
    "unet.reduce": 0.01, "deep_modulator_3c": 0.19, "fusion_layer": 0.02,
    "final_pred_head": 0.01, "proj4": 0.01,
}
DP_NORM_TOL = 1e-3   # |grad_norm ratio - 1|, the 2-rank step against one process's
# the 2-epoch loop on 2 ranks against one process: the validation CSVs' mae
# and mape within DP_LOOP_TOL relative, avg_corr within DP_LOOP_TOL absolute
DP_LOOP_TOL = 2e-2


class _LocalOnlyGather(torch.autograd.Function):
    """A faulty all-gather for phase 13's planted fault: its backward keeps
    this rank's rows of the cotangent without summing it over the ranks."""

    @staticmethod
    def forward(ctx, x, mesh):
        from coma_unet_tpu_torch.parallel.mesh import gather_all

        ctx.mesh = mesh
        return gather_all([x], mesh)[0]

    @staticmethod
    def backward(ctx, grad):
        return grad[ctx.mesh.rows(grad.shape[0])].clone(), None


def _dp_model():
    """Phase 13's model: the default ModelConfig, weights from seed 0."""
    from coma_unet_tpu_torch import ContraAttnUNet, ModelConfig

    return ContraAttnUNet(ModelConfig(), device=DEVICE,
                          generator=torch.Generator().manual_seed(0))


def _dp_inputs():
    """Phase 13's model, its global b=4 128^3 batch (RnC) and the ROI
    weights, on the card."""
    model = _dp_model()
    batch = _batch(np.random.default_rng(DP_SEED), b=4, s=128)
    batch["covars"][:, 0] = batch["abeta"] = np.asarray([1.0, 0.0, 1.0, 0.0],
                                                        np.float32)
    batch["valid_mask"] = np.asarray(DP_VALID, np.float32)
    return model, batch, torch.full((36,), 225.0, device=DEVICE)


def _dp_cohort(tmp: str) -> dict:
    """Phase 13's synthetic 128^3 cohort: 4 training subjects (one global
    batch of 4), 2 validation subjects (wrap-padded to 4: rank 1 holds only
    padding)."""
    import os

    from coma_unet_tpu_torch import ROI_INDICES
    from coma_unet_tpu_torch.data.synthetic import make_synthetic_cohort
    from coma_unet_tpu_torch.data.table import read_csv, write_rows

    cohort = make_synthetic_cohort(os.path.join(tmp, "cohort"), n_subjects=6,
                                   size=128, num_rois=len(ROI_INDICES))
    rows = read_csv(cohort["lookup"]).rows()
    cohort["train"] = os.path.join(tmp, "train.csv")
    cohort["test"] = os.path.join(tmp, "test.csv")
    write_rows(cohort["train"], rows[:4])
    write_rows(cohort["test"], rows[4:])
    return cohort


def _dp_loop(cohort: dict, save_path: str, mesh=None) -> float:
    """`train.loop.train` for 2 epochs at a global batch of 4 on `cohort`,
    in one process or on this rank of `mesh` (its loaders reading its rows),
    the model from seed 0; returns the seconds."""
    from coma_unet_tpu_torch import ContraAttnUNet, ExperimentConfig, TrainConfig
    from coma_unet_tpu_torch.data import (
        CovariateTable, DataLoader, PredictedMetaTauDataset, PredictionTable,
        QuartileTable,
    )
    from coma_unet_tpu_torch.train import loop

    shard = (0, 1) if mesh is None else (mesh.rank, mesh.size)
    cfg = ExperimentConfig(train=TrainConfig(
        epochs=2, batch_size=4, val_iter=1, checkpoint_iter=100,
        data_parallel=shard[1])).normalized()
    cov, quart = CovariateTable(cohort["cov"]), QuartileTable(cohort["quart"])
    preds = PredictionTable(cohort["preds"])
    train_ds, test_ds = (PredictedMetaTauDataset(cohort[k], cov, quart,
                                                 meta_tau_table=preds,
                                                 pad_dims=cfg.data.volume_shape)
                         for k in ("train", "test"))
    model = ContraAttnUNet(cfg.model, device=DEVICE,
                           generator=torch.Generator().manual_seed(0))
    t0 = time.perf_counter()
    loop.train(model, cfg,
               DataLoader(train_ds, 4, predictions=preds, shuffle=True,
                          shard=shard),
               val_loader=DataLoader(test_ds, 4, predictions=preds, shard=shard),
               save_path=save_path, device=DEVICE, mesh=mesh)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def _dp_rank(rank: int, init_method: str, tmp: str, cohort: dict) -> None:
    """One rank of phase 13 on the one card (gloo): the main path -- the
    sharded eval step, two sharded train steps on its rows of the global
    batch, and the 2-epoch loop on the cohort -- with the launches counted
    from 0; then the planted fault, one step whose gather drops the
    cross-rank sum. Every rank compares its parameters after the two steps
    with rank 0's, bit for bit; rank 0 saves those verdicts, the launches,
    the first step's metrics and summed gradients, the eval's metrics, the
    second step's time and the fault's gradients and grad_norm."""
    import gc
    import os

    from coma_unet_tpu_torch import LossConfig, ops
    from coma_unet_tpu_torch.parallel import mesh as pmesh
    from coma_unet_tpu_torch.train import create_train_state

    torch.set_num_threads(max(1, torch.get_num_threads() // DP_RANKS))
    torch.backends.cudnn.deterministic = True
    mesh = pmesh.make_mesh(rank, DP_RANKS, f"{DEVICE}:0", init_method)

    def sharded(model):
        state = pmesh.replicate_state(create_train_state(model, 1e-3), mesh)
        return pmesh.make_sharded_train_step(model, LossConfig(),
                                             state.optimizer, mesh)

    def grads_of(model):
        return {n: p.grad.detach().float().cpu() for n, p in model.named_parameters()
                if p.grad is not None}

    try:
        model, batch, roi_w = _dp_inputs()
        step = sharded(model)
        eval_step = pmesh.make_sharded_eval_step(model, 36, mesh)
        local = pmesh.shard_batch(
            {k: torch.as_tensor(v, device=DEVICE) for k, v in batch.items()}, mesh)
        torch.cuda.synchronize()
        ops.reset_counts()
        pred, vox, roi = eval_step({k: v for k, v in local.items()
                                    if k != "valid_mask"})
        metrics = step(local, roi_w)
        grads = grads_of(model)
        step_ms = _timed(lambda: step(local, roi_w))
        # rank 0's parameters on every rank, compared bit for bit
        copies = [p.detach().clone() for p in model.parameters()]
        pmesh.broadcast_(copies, mesh)
        same = all(torch.equal(c, p) for c, p in zip(copies, model.parameters()))
        params_same = pmesh.gather_objects(same, mesh)
        del model, step, eval_step, copies
        gc.collect()
        torch.cuda.empty_cache()
        loop_s = _dp_loop(cohort, os.path.join(tmp, "loop_dp"), mesh)
        launches, plain_cuda = dict(ops.LAUNCHES), dict(ops.PLAIN_ON_CUDA)
        gc.collect()
        torch.cuda.empty_cache()

        model = _dp_model()
        good = pmesh.gather_rows
        pmesh.gather_rows = lambda x, m: _LocalOnlyGather.apply(x, m)
        try:
            fault_norm = float(sharded(model)(local, roi_w)["grad_norm"])
        finally:
            pmesh.gather_rows = good
        if rank == 0:
            torch.save({"launches": launches, "plain_cuda": plain_cuda,
                        "metrics": {k: v.detach().cpu() for k, v in metrics.items()},
                        "params_same": params_same, "fault_norm": fault_norm,
                        "grads": grads, "fault_grads": grads_of(model),
                        "step_ms": step_ms, "loop_s": loop_s, "pred": pred.cpu(),
                        "vox": {k: v.cpu() for k, v in vox.items()},
                        "roi": {k: v.cpu() for k, v in roi.items()}},
                       os.path.join(tmp, "rank0.pt"))
    finally:
        pmesh.destroy_mesh()


def _dp_groups(g: dict, g_one: dict, groups: dict) -> dict:
    """rel L2 of each gradient group of `g` against `g_one`."""
    out = {}
    for group, names in groups.items():
        num = sum(float((g[n] - g_one[n]).square().sum()) for n in names)
        den = sum(float(g_one[n].square().sum()) for n in names)
        out[group] = (num / den) ** 0.5 if den > 0 else 0.0
    return out


def _dp_check_loop(single: str, dp: str) -> float:
    """The data-parallel loop's run directory against one process's: the
    same files (charts aside), the validation CSVs within DP_LOOP_TOL, and
    its checkpoint at step 2, loading into a single-process model. Returns
    the worst difference."""
    import os

    from coma_unet_tpu_torch import ContraAttnUNet, ModelConfig
    from coma_unet_tpu_torch.data.table import read_csv
    from coma_unet_tpu_torch.train.checkpoint import load_checkpoint

    def tree(root):
        return sorted(os.path.relpath(os.path.join(d, f), root)
                      for d, _, fs in os.walk(root) for f in fs
                      if not f.endswith(".png"))

    check(tree(dp) == tree(single), f"data parallel loop: files {tree(dp)} vs "
          f"one process's {tree(single)}")
    worst = 0.0
    for key in ("mae", "mape", "avg_corr"):
        want = read_csv(os.path.join(single, "validation_metric_results",
                                     f"{key}.csv"))
        got = read_csv(os.path.join(dp, "validation_metric_results", f"{key}.csv"))
        check(got.columns == want.columns == ["epoch_0", "epoch_1"],
              f"data parallel loop: {key}.csv columns {got.columns}")
        for col in want.columns:
            w, g = np.asarray(want[col], np.float64), np.asarray(got[col], np.float64)
            err = np.abs(g - w) / (1.0 if key == "avg_corr" else np.abs(w))
            check(bool(np.all(err <= DP_LOOP_TOL)), f"data parallel loop: {key} "
                  f"{col} {g} vs one process's {w} (> {DP_LOOP_TOL})")
            worst = max(worst, float(err.max()))
    payload = load_checkpoint(os.path.join(dp, "checkpoints",
                                           "checkpoint_latest_epoch"))
    check(payload["step"] == 2 and payload["epoch"] == 1,
          f"data parallel loop: checkpoint step {payload['step']}")
    model = ContraAttnUNet(ModelConfig(), device=DEVICE)
    model.load_state_dict(payload["model"])  # strict: no `module.` prefix
    del model, payload
    torch.cuda.empty_cache()
    return worst


def phase_data_parallel() -> dict:
    """Phase 13: the data-parallel train and eval steps and the loop, two
    gloo ranks on the one card, against one process's b=4 steps and loop.
    Returns rank 0's launches over its eval, two train steps and the loop."""
    import gc
    import os
    import shutil
    import tempfile

    import torch.multiprocessing as mp

    from coma_unet_tpu_torch import LossConfig, ops
    from coma_unet_tpu_torch.metrics import roi_metrics, voxel_metrics
    from coma_unet_tpu_torch.train import (
        create_train_state,
        make_eval_step,
        make_train_step,
    )

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dp_")
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        try:
            model, batch, roi_w = _dp_inputs()
            state = create_train_state(model, 1e-3)
            step = make_train_step(model, LossConfig(), state.optimizer)
            tb = {k: torch.as_tensor(v, device=DEVICE) for k, v in batch.items()}
            eval_step = make_eval_step(model, 36)
            pred_one = eval_step({k: v for k, v in tb.items() if k != "valid_mask"})[0]
            pred_one = pred_one.float().cpu()
            # one process's eval of each rank's rows, at the rank's batch size
            halves = [eval_step({k: v[i:i + 2] for k, v in tb.items()
                                 if k != "valid_mask"}) for i in (0, 2)]
            want_vox, want_roi = ({k: torch.cat([h[j][k] for h in halves]).double().cpu()
                                   for k in halves[0][j]} for j in (1, 2))
            pred_halves = torch.cat([h[0] for h in halves]).cpu()
            del halves
            want = step(tb, roi_w)
            want = {k: v.detach().cpu() for k, v in want.items()}
            g_one = {n: p.grad.detach().float().cpu()
                     for n, p in model.named_parameters() if p.grad is not None}
            one_ms = _timed(lambda: step(tb, roi_w))
            torch.backends.cudnn.deterministic = False
            one_free_ms = _timed(lambda: step(tb, roi_w))
            torch.backends.cudnn.deterministic = True
            skip = _norm_fed_biases(model)
            del model, state, step, tb, eval_step
            gc.collect()
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            cohort = _dp_cohort(tmp)
            cohort_s = time.perf_counter() - t0
            single_loop_s = _dp_loop(cohort, os.path.join(tmp, "loop_single"))
            gc.collect()
            torch.cuda.empty_cache()
        finally:
            torch.backends.cudnn.deterministic = deterministic

        t_ranks = time.perf_counter()
        mp.start_processes(_dp_rank, args=("file://" + os.path.join(tmp, "store"),
                                           tmp, cohort),
                           nprocs=DP_RANKS, join=True, start_method="spawn")
        ranks_s = time.perf_counter() - t_ranks
        got = torch.load(os.path.join(tmp, "rank0.pt"), weights_only=True)
        loop_worst = _dp_check_loop(os.path.join(tmp, "loop_single"),
                                    os.path.join(tmp, "loop_dp"))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    launches, plain_cuda = got["launches"], got["plain_cuda"]
    print(f"data parallel launches on rank 0 (eval, 2 steps, 2-epoch loop): "
          f"{launches}; plain on cuda: {plain_cuda}")
    for family in ops.PATH_FAMILIES:
        check(launches.get(family, 0) > 0, f"{family}: no launch on rank 0 of the "
              f"data-parallel path")
    check(sum(plain_cuda.values()) == 0, f"plain versions ran on the GPU: {plain_cuda}")
    check(got["params_same"] == [True] * DP_RANKS, f"data parallel: the parameters "
          f"differ from rank 0's after 2 steps (equal on {got['params_same']})")
    metrics = got["metrics"]
    loss, loss_one = float(metrics["loss"]), float(want["loss"])
    rel_loss = abs(loss - loss_one) / abs(loss_one)
    check(rel_loss <= LOSS_TOL, f"data parallel: loss {loss} vs one process's "
          f"{loss_one} ({rel_loss} > {LOSS_TOL})")
    check(float(metrics["tcds_loss"]) != 0.0, "data parallel: RnC is 0 at b=4")
    check(metrics["gen_loss"].shape == want["gen_loss"].shape,
          f"data parallel: gen_loss {tuple(metrics['gen_loss'].shape)}")
    norm_ratio = float(metrics["grad_norm"]) / float(want["grad_norm"])
    check(abs(norm_ratio - 1.0) <= DP_NORM_TOL, f"data parallel: grad_norm "
          f"{float(metrics['grad_norm'])} vs one process's "
          f"{float(want['grad_norm'])} (ratio {norm_ratio})")
    check(set(got["grads"]) == set(g_one),
          "data parallel: other parameters have gradients")
    groups: dict = {}
    for name in g_one:
        if name not in skip:
            groups.setdefault(_group(name), []).append(name)
    check(set(groups) == set(DP_GRAD_LIMITS), f"data parallel: groups "
          f"{sorted(groups)} vs {sorted(DP_GRAD_LIMITS)}")
    sound = _dp_groups(got["grads"], g_one, groups)
    fault = _dp_groups(got["fault_grads"], g_one, groups)
    print(f"{'group':28s} {'dp vs one':>10s} {'fault':>10s} {'limit':>10s}")
    for group in groups:
        print(f"{group:28s} {sound[group]:10.3e} {fault[group]:10.3e} "
              f"{DP_GRAD_LIMITS[group]:10.3e}")
    over = [(g, e) for g, e in sound.items() if e > DP_GRAD_LIMITS[g]]
    check(not over, f"data parallel: gradient groups over their limits: {over}")
    caught = [g for g, e in fault.items() if e > DP_GRAD_LIMITS[g]]
    check(bool(caught), "data parallel: the planted gather without the "
          "cross-rank sum passes the gradient check")
    worst = max(e / DP_GRAD_LIMITS[g] for g, e in sound.items())
    head = max(g for g in groups if g.startswith("proj"))  # fed by RnC alone
    # the sharded eval: its pred and metrics against one process's eval of
    # the same rows, its metrics against the f64 recomputation from its own
    # pred (phase 9's check), its pred beside one process's at b=4, where
    # cuDNN and the kernels' cuts see another batch
    check(torch.equal(got["pred"], pred_halves),
          "data parallel: the sharded eval's pred differs from one process's "
          "eval of the same rows")
    worst_vox = _check_metrics("data-parallel eval voxel", got["vox"], want_vox)
    worst_roi = _check_metrics("data-parallel eval roi", got["roi"], want_roi)
    pred64 = got["pred"].double()
    tau64 = torch.as_tensor(batch["tau"]).double()
    worst_f64 = max(
        _check_metrics("data-parallel eval voxel vs f64", got["vox"],
                       voxel_metrics(pred64, tau64)),
        _check_metrics("data-parallel eval roi vs f64", got["roi"],
                       roi_metrics(pred64, tau64,
                                   torch.as_tensor(batch["roi_compact"]), 36)))
    pred_rel = float((got["pred"].float() - pred_one).norm() / pred_one.norm())
    check(pred_rel <= PARITY_TOL, f"data parallel: pred differs from one process's "
          f"b=4 pred by {pred_rel} > {PARITY_TOL}")
    print(f"data parallel 128^3, global b=4 on {DP_RANKS} gloo ranks sharing the one "
          f"card (valid {list(DP_VALID)}, RnC {float(metrics['tcds_loss']):.6f}): loss "
          f"{loss:.6f} vs one process's b=4 {loss_one:.6f} (rel {rel_loss:.2e}, tol "
          f"{LOSS_TOL}); {len(groups)} gradient groups within their limits (worst at "
          f"{worst:.2f} of its limit), grad_norm ratio {norm_ratio:.6f} (tol "
          f"{DP_NORM_TOL}); planted gather without the cross-rank sum caught by "
          f"{len(caught)} groups ({head} {fault[head]:.3e}, worst "
          f"{max(fault[g] / DP_GRAD_LIMITS[g] for g in fault):.1f}x its limit, "
          f"grad_norm ratio {got['fault_norm'] / float(want['grad_norm']):.6f}); eval "
          f"pred bit-identical to one process's eval of the same rows, metrics within "
          f"{max(worst_vox, worst_roi):.2e} of it and {worst_f64:.2e} of f64 (tol "
          f"{METRIC_TOL}), pred rel L2 {pred_rel:.3e} from one process's b=4 (tol "
          f"{PARITY_TOL}); parameters bit-identical across the ranks after 2 steps; "
          f"2-epoch loop's validation CSVs within {loop_worst:.2e} of one process's "
          f"(tol {DP_LOOP_TOL})")
    print(f"data parallel step {got['step_ms']:.2f} ms (rank 0, second step; two "
          f"ranks sharing one card over gloo: the cost of sharing, not a "
          f"data-parallel speed) vs one process's b=4 step {one_ms:.2f} ms, both with "
          f"cuDNN deterministic ({one_free_ms:.2f} ms without); loop (2 epochs, cohort "
          f"{cohort_s:.1f} s) {got['loop_s']:.1f} s on the ranks vs {single_loop_s:.1f} s "
          f"in one process; ranks {ranks_s:.1f} s, phase "
          f"{time.perf_counter() - t_phase:.1f} s")
    return launches


SPATIAL_TOL = 1e-2   # rel L2 of the depth-sharded `out` against one process's, or
SPATIAL_RATIO = 1.25  # SPATIAL_RATIO x what the same slab route reads on one rank, where
                      # that is larger: the random-weight flagship in bf16 moves `out` by
                      # 3.1e-2 when one statistic of its first norm moves by 2^-22
SPATIAL_TOL_F32 = 1e-4  # the same in float32, where the CPU reads 3e-6 (no floor: f32
                        # moves `out` by about 1e-6 for a last-bit change of a statistic)
SP_RANKS = 2
SP_PEAK_RATIO = 0.65  # a rank's activation peak against one process's
SP_CALLS = 3
SP_SIZES = (128, 216)  # 128^3: even slabs of 64 planes; 216^3 (template space):
                       # uneven, 112 and 104, then 56/52, 28/26, 14/13, 7/7


def _sp_setup(dtype: str = "bfloat16", s: int = 128):
    """Phase 14's model in `dtype` (weights from seed 0) and its b=1 s^3
    inputs, as numpy: at 128 the default ModelConfig with 36 ROIs, at 216
    the template-space config with its 8 ROIs."""
    import dataclasses

    from coma_unet_tpu_torch import (
        ContraAttnUNet,
        DataConfig,
        ExperimentConfig,
        ModelConfig,
        TEMPLATE_ROI_INDICES,
    )

    cfg, rois = ModelConfig(compute_dtype=dtype), 36
    if s == 216:
        cfg = dataclasses.replace(ExperimentConfig(data=DataConfig(
            template_space=True)).normalized().model, compute_dtype=dtype)
        rois = len(TEMPLATE_ROI_INDICES)
    model = ContraAttnUNet(cfg, device=DEVICE,
                           generator=torch.Generator().manual_seed(0)).eval()
    batch = _batch(np.random.default_rng(0), b=1, s=s, r=rois)
    return model, tuple(batch[k] for k in ("mri", "covars", "roi_loc", "roi_std",
                                           "roi_compact"))


def _peak_call(fn) -> tuple:
    """fn()'s result and its activation peak: the most memory allocated
    during the call less what was allocated before it, in bytes."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated() - base


def _sp_rank(rank: int, init_method: str, tmp: str, dtype: str = "bfloat16") -> None:
    """One rank of phase 14 on the one card (gloo), at each of SP_SIZES: a
    warm-up call, then the main path -- one depth-sharded forward with the
    launches counted from 0, its activation peak and every merged (mean,
    rstd) recorded -- then SP_CALLS timed calls, one call with the halo and
    statistics collectives timed, and the planted faults (in float32 also
    the off-by-one halo at level 1). Saves what it saw to rank<r>_<s>.pt."""
    import gc
    import os

    from coma_unet_tpu_torch import ops
    from coma_unet_tpu_torch.ops.norm_act import mean_rstd
    from coma_unet_tpu_torch.parallel import mesh as pmesh
    from coma_unet_tpu_torch.parallel import spatial

    torch.set_num_threads(max(1, torch.get_num_threads() // SP_RANKS))
    if dtype == "float32":
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    mesh = pmesh.make_mesh(rank, SP_RANKS, f"{DEVICE}:0", init_method)
    good_halo, good_merge = spatial.Slab.halo, spatial.Slab.merge
    try:
        for size in SP_SIZES:
            model, args = _sp_setup(dtype, size)
            infer = spatial.make_spatial_infer_fn(model, mesh)
            infer(*args)
            seen = []

            def recording(self, partials):
                merged = good_merge(self, partials)
                seen.append(mean_rstd(merged).cpu())
                return merged

            spatial.Slab.merge = recording
            ops.reset_counts()
            out, peak = _peak_call(lambda: infer(*args))
            launches, plain_cuda = dict(ops.LAUNCHES), dict(ops.PLAIN_ON_CUDA)
            spatial.Slab.merge = good_merge
            times = []
            for _ in range(SP_CALLS):
                times.append(_timed(lambda: infer(*args)))
            spent = [0.0]

            def timed(fn):
                def call(*a):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    result = fn(*a)
                    torch.cuda.synchronize()
                    spent[0] += time.perf_counter() - t0
                    return result
                return call

            spatial.Slab.halo, spatial.Slab.merge = timed(good_halo), timed(good_merge)
            timed_ms = _timed(lambda: infer(*args))
            spatial.Slab.halo, spatial.Slab.merge = good_halo, good_merge

            def zeros(self, x, below, above):
                lower, upper = good_halo(self, x, below, above)
                return torch.zeros_like(lower), torch.zeros_like(upper)

            def off_by_one(self, x, below, above):
                # at level 1 only (its width, the same on every rank): the
                # plane one further from the slab
                if x.shape[-1] != size // 2:
                    return good_halo(self, x, below, above)
                lower, upper = good_halo(self, x, 2 * below, 2 * above)
                return lower[:, :, :below], upper[:, :, above:2 * above]

            spatial.Slab.halo = zeros
            zero_halo = infer(*args)
            spatial.Slab.halo = good_halo
            spatial.Slab.merge = lambda self, partials: partials
            unmerged = infer(*args)
            spatial.Slab.merge = good_merge
            off_halo = None
            if dtype == "float32":
                spatial.Slab.halo = off_by_one
                off_halo = infer(*args)
                spatial.Slab.halo = good_halo
            cpu = (lambda t: None if t is None else t.float().cpu())
            torch.save({"out": cpu(out), "zero_halo": cpu(zero_halo),
                        "unmerged": cpu(unmerged), "off_by_one_halo": cpu(off_halo),
                        "stats": seen, "peak": peak,
                        "planes": _planes(spatial.plan_slabs(size, spatial.level_strides(
                            model.config), SP_RANKS), rank),
                        "launches": launches, "plain_cuda": plain_cuda, "times": times,
                        "collective_ms": 1e3 * spent[0], "timed_ms": timed_ms},
                       os.path.join(tmp, f"rank{rank}_{size}.pt"))
            del model, infer, out, zero_halo, unmerged, off_halo
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        spatial.Slab.halo, spatial.Slab.merge = good_halo, good_merge
        pmesh.destroy_mesh()


def _planes(plan, rank: int) -> tuple:
    """Rank `rank`'s (first, last) plane at level 0 of a `SlabPlan`."""
    planes = plan.planes(rank)
    return (planes.start, planes.stop - 1)


def _rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).norm() / b.double().norm())


def phase_spatial(dtype: str = "bfloat16") -> dict:
    """Phase 14: `make_spatial_infer_fn` on two gloo ranks sharing the one
    card, each on a depth slab of a 128^3 volume (even slabs) and of a
    216^3 template-space volume (uneven slabs, the last rank's odd from
    level 3), against one process's `make_infer_fn`; the model in `dtype`.
    Returns each size's launches on rank 0 over its main-path call. In
    float32 (TF32 off) the limit is SPATIAL_TOL_F32, and a third planted
    fault, level 1's halo off by one plane, must read above it."""
    t_phase = time.perf_counter()
    f32 = dtype == "float32"
    guard = _no_tf32() if f32 else contextlib.nullcontext()
    with guard:
        return _spatial(dtype, f32, t_phase)


def _sp_reference(dtype: str, size: int, tag: str, tmp: str) -> dict:
    """One process's `make_infer_fn` at `size` (its out, activation peak
    and median time) and, in bf16, the floor: the slab route (K4's two
    halves, the merged f64 statistics) on one rank that holds the whole
    volume."""
    import gc
    import os

    from coma_unet_tpu_torch.infer import make_infer_fn
    from coma_unet_tpu_torch.parallel import mesh as pmesh
    from coma_unet_tpu_torch.parallel.spatial import make_spatial_infer_fn

    model, args = _sp_setup(dtype, size)
    infer = make_infer_fn(model)
    infer(*args)
    want, peak_one = _peak_call(lambda: infer(*args))
    want = want.float().cpu()
    one_ms = statistics.median(_timed(lambda: infer(*args)) for _ in range(SP_CALLS))
    check(tuple(want.shape) == (1, 1) + (size,) * 3 and bool(torch.isfinite(want).all()),
          f"{tag}: one process's out {tuple(want.shape)}")
    floor = None
    if dtype != "float32":
        mesh = pmesh.make_mesh(0, 1, f"{DEVICE}:0",
                               "file://" + os.path.join(tmp, f"one{size}"))
        try:
            floor = _rel_l2(make_spatial_infer_fn(model, mesh)(*args).float().cpu(), want)
        finally:
            pmesh.destroy_mesh()
    del model, infer
    gc.collect()
    torch.cuda.empty_cache()
    return dict(want=want, peak_one=peak_one, one_ms=one_ms, floor=floor)


def _spatial(dtype: str, f32: bool, t_phase: float) -> dict:
    import os
    import shutil
    import tempfile

    import torch.multiprocessing as mp

    tag = "spatial float32" if f32 else "spatial"
    tmp = tempfile.mkdtemp(prefix="chip_smoke_sp_")
    try:
        refs = {size: _sp_reference(dtype, size, f"{tag} {size}^3", tmp)
                for size in SP_SIZES}
        t_ranks = time.perf_counter()
        mp.start_processes(_sp_rank, args=("file://" + os.path.join(tmp, "store"), tmp, dtype),
                           nprocs=SP_RANKS, join=True, start_method="spawn")
        ranks_s = time.perf_counter() - t_ranks
        got = {size: [torch.load(os.path.join(tmp, f"rank{r}_{size}.pt"),
                                 weights_only=True) for r in range(SP_RANKS)]
               for size in SP_SIZES}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    launches = {}
    for size in SP_SIZES:
        launches[size] = _sp_check(f"{tag} {size}^3", f32, refs[size], got[size])
    print(f"{tag}: ranks {ranks_s:.1f} s, phase {time.perf_counter() - t_phase:.1f} s")
    return launches


def _sp_check(tag: str, f32: bool, ref: dict, got: list) -> dict:
    """Phase 14's checks and lines at one size. Returns rank 0's launches."""
    from coma_unet_tpu_torch import ops

    want, floor = ref["want"], ref["floor"]
    limit = SPATIAL_TOL_F32 if f32 else max(SPATIAL_TOL, SPATIAL_RATIO * floor)
    out = got[0]["out"]
    check(all(g["out"] is None for g in got[1:]), f"{tag}: a rank other than 0 holds out")
    check(tuple(out.shape) == tuple(want.shape) and bool(torch.isfinite(out).all()),
          f"{tag}: out {tuple(out.shape)}")
    err = _rel_l2(out, want)
    rule = (f"{SPATIAL_TOL_F32}" if f32 else
            f"max({SPATIAL_TOL}, {SPATIAL_RATIO} x the one-rank slab route's {floor})")
    check(err <= limit, f"{tag}: out rel L2 {err} from one process's > {limit} ({rule})")
    names = ("zero_halo", "unmerged") + (("off_by_one_halo",) if f32 else ())
    faults = {name: _rel_l2(got[0][name], want) for name in names}
    for name, e in faults.items():
        check(e > limit, f"{tag}: the planted fault {name} reads {e} <= {limit}")
    stats = [g["stats"] for g in got]
    check(len(stats[0]) > 0 and all(
        len(s) == len(stats[0]) and all(torch.equal(a, b) for a, b in zip(s, stats[0]))
        for s in stats[1:]), f"{tag}: the merged statistics differ between the ranks")
    need = ("s1", "s2", "t2") + ops.SLAB_FAMILIES
    if f32:
        need = tuple(f + "_f32" for f in need)
    peak_one = ref["peak_one"]
    for r, g in enumerate(got):
        print(f"{tag} rank {r} (planes {g['planes'][0]}-{g['planes'][1]}) launches: "
              f"{g['launches']}; plain on cuda: {g['plain_cuda']}")
        for family in need:
            check(g["launches"].get(family, 0) > 0,
                  f"{tag}: {family}: no launch on rank {r}")
        for family in ("norm_act", "norm_act_f32"):
            check(g["launches"].get(family, 0) == 0,
                  f"{tag}: the whole-row K4 ({family}) launched on rank {r}")
        if f32:
            check(not any(g["launches"].get(f, 0) for f in ops.FWD_FAMILIES + ops.SLAB_FAMILIES),
                  f"{tag}: a bf16 kernel launched on rank {r}: {g['launches']}")
        check(sum(g["plain_cuda"].values()) == 0,
              f"{tag}: plain versions ran on the GPU on rank {r}: {g['plain_cuda']}")
        check(g["peak"] <= SP_PEAK_RATIO * peak_one, f"{tag}: rank {r}'s activation "
              f"peak {g['peak'] / 2**30:.3f} GiB > {SP_PEAK_RATIO} x one process's "
              f"{peak_one / 2**30:.3f} GiB")
    sharded_ms = statistics.median(got[0]["times"])
    print(f"{tag} b=1 on {SP_RANKS} gloo ranks sharing the one card, depth slabs of "
          f"{[g['planes'][1] + 1 - g['planes'][0] for g in got]} planes: out rel L2 "
          f"{err:.3e} from one process's"
          + ("" if f32 else f", the slab route on one rank {floor:.3e}")
          + f" (limit {limit:.3e}: {rule}); planted faults: "
          + ", ".join(f"{name} {e:.3e} ({e / limit:.1f}x the limit)"
                      for name, e in faults.items())
          + f"; {len(stats[0])} merged (mean, rstd) bit-identical on every rank")
    print(f"{tag} forward: median of {SP_CALLS} {sharded_ms:.2f} ms on rank 0 "
          f"({[round(t, 2) for t in got[0]['times']]}) vs one process's "
          f"{ref['one_ms']:.2f} ms; halo and statistics collectives "
          f"{got[0]['collective_ms']:.2f} ms of a {got[0]['timed_ms']:.2f} ms call with "
          f"them timed ({got[0]['collective_ms'] / got[0]['timed_ms']:.1%}); activation "
          "peaks " + ", ".join(f"rank {r} {g['peak'] / 2**30:.3f} GiB "
                               f"({g['peak'] / peak_one:.3f}x)" for r, g in enumerate(got))
          + f" vs one process's {peak_one / 2**30:.3f} GiB (limit {SP_PEAK_RATIO}x)")
    return got[0]["launches"]


def _timed(fn) -> float:
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


F32_FWD_CALLS = 5
F32_STEPS = 4


def _tf32() -> tuple:
    return torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32


def _f32_path(name: str, launches: dict, plain_cuda: dict, families, tf32: tuple) -> None:
    """A float32 path's launches: every family of `families` launched, no
    bf16 family and no plain version on the card; `tf32`, the two TF32
    flags while it ran, both False."""
    from coma_unet_tpu_torch import ops

    print(f"float32 {name}: launches {launches}; plain on cuda {plain_cuda}; "
          f"cudnn.allow_tf32={tf32[0]}, cuda.matmul.allow_tf32={tf32[1]}")
    check(tf32 == (False, False), f"float32 {name}: TF32 on: {tf32}")
    for family in families:
        check(launches.get(family, 0) > 0, f"float32 {name}: {family} did not launch")
    bf16 = {f: n for f, n in launches.items() if f in ops.FAMILIES and not f.endswith("_f32")}
    check(not bf16, f"float32 {name}: bf16 kernels launched: {bf16}")
    check(sum(plain_cuda.values()) == 0, f"float32 {name}: plain on the GPU: {plain_cuda}")


# the float32 step's launch families beside the kernel whose profiler
# records they make (FB1's two maps are one kernel; every conv launch of
# F1 and F2 also makes one record of the weight packing)
F32_RECORDS = ((("s1_f32",), "conv3d_s1_f32_tc_kernel"), (("s2_f32",), "conv3d_s2_f32_tc_kernel"),
               (("t2_f32",), "conv3d_t2_f32_tc_kernel"),
               (("s1_f32", "s2_f32", "t2_f32"), "tf32_pack_weights"),
               (("s1_dw_f32", "strided_dw_f32"), "conv3d_dw_f32_tc_kernel"),
               (("norm_act_f32",), "norm_act_kernel"),
               (("norm_act_bwd_f32",), "norm_act_bwd_kernel"))


def _profile_gaps(records: dict, launches: dict) -> None:
    """Prints, for the profiled step, each float32 kernel's records in the
    profile beside the launches the counters saw in the same step, and the
    gap where the profile holds fewer: a share read from it then misses
    that many calls."""
    parts, gaps = [], []
    for families, name in F32_RECORDS:
        n = sum(launches.get(f, 0) for f in families)
        ms, got = records.get(name, (0.0, 0))
        parts.append(f"{name} {got} of {n}")
        if got < n:
            gaps.append(f"{name} {n - got} ({ms:.3f} ms over {got} records)")
    print("  profiler records of the launches counted in the same step: " + "; ".join(parts))
    print("  " + ("every launch has its record" if not gaps else
                  "the profile dropped records: " + "; ".join(gaps)))


def phase_float32() -> dict:
    """Phase 15, the float32 paths: the default ModelConfig in float32,
    widths uncut, weights from seed 0, TF32 off. The 128^3 b=2 forward
    (median of F32_FWD_CALLS CUDA-event calls), F32_STEPS RnC train steps at
    128^3 b=2 (median of steps 2 on), the template-space 216^3 b=1 forward,
    and `cli.main infer --compute_dtype float32` on a synthetic 6-subject
    128^3 cohort (phase 10's), with the TF32 flags set True before it: the
    CLI must turn both off. Each path is counted from 0: every float32
    family it reaches launches, no bf16 family and no plain version runs on
    the card. Returns the launches by path."""
    import dataclasses
    import gc
    import os
    import shutil
    import tempfile

    from coma_unet_tpu_torch import (
        ContraAttnUNet,
        DataConfig,
        ExperimentConfig,
        LossConfig,
        ModelConfig,
        ROI_INDICES,
        TEMPLATE_ROI_INDICES,
        ops,
    )
    from coma_unet_tpu_torch.data.synthetic import make_synthetic_cohort
    from coma_unet_tpu_torch.infer import make_infer_fn
    from coma_unet_tpu_torch.data.table import read_csv, write_rows
    from coma_unet_tpu_torch.io import load_nifti_vol
    from coma_unet_tpu_torch.train import create_train_state, make_train_step

    t_phase = time.perf_counter()
    paths: dict = {}
    with _no_tf32():
        model = ContraAttnUNet(ModelConfig(compute_dtype="float32"), device=DEVICE,
                               generator=torch.Generator().manual_seed(0))
        batch = _batch(np.random.default_rng(0), b=2, s=128)
        args = _args(batch, DEVICE)
        model.eval()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_counts()
        with torch.inference_mode():
            out = model(*args, with_projections=False).out
            torch.cuda.synchronize()
            paths["float32 forward"] = dict(ops.LAUNCHES)
            plain = dict(ops.PLAIN_ON_CUDA)
            check(tuple(out.shape) == (2, 1, 128, 128, 128) and out.dtype == torch.float32
                  and bool(torch.isfinite(out).all()), f"float32 forward: out {out.shape}")
            fwd_ms = median_ms(lambda: model(*args, with_projections=False),
                               reps=F32_FWD_CALLS, warmup=1)
        fwd_peak = torch.cuda.max_memory_allocated() / 2**30
        _f32_path("forward 128^3 b=2", paths["float32 forward"], plain, ops.FWD_FAMILIES_F32,
                  _tf32())
        print(f"float32 forward b=2 128^3: median of {F32_FWD_CALLS} {fwd_ms:.2f} ms "
              f"({fwd_ms / 2:.2f} ms/volume; phase 6's bf16 forward is the same model); peak "
              f"memory {fwd_peak:.2f} GiB")
        del out

        model.train()
        state = create_train_state(model, 1e-3)
        step = make_train_step(model, LossConfig(), state.optimizer)
        tb = {k: torch.as_tensor(v, device=DEVICE) for k, v in batch.items()}
        roi_w = torch.full((36,), 225.0, device=DEVICE)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_counts()
        losses, step_ms = [], []
        for _ in range(F32_STEPS):
            t0 = time.perf_counter()
            metrics = step(tb, roi_w)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(metrics["loss"]))
        paths["float32 train"] = dict(ops.LAUNCHES)
        plain = dict(ops.PLAIN_ON_CUDA)
        train_peak = torch.cuda.max_memory_allocated() / 2**30
        _f32_path("train step 128^3 b=2", paths["float32 train"], plain, ops.PATH_FAMILIES_F32,
                  _tf32())
        check(all(np.isfinite(losses)) and all(v != 0.0 for v in losses),
              f"float32 train: losses {losses}")
        check(state.step == F32_STEPS, f"float32 train: {state.step} updates")
        med = statistics.median(step_ms[1:])
        print(f"float32 train losses {[round(v, 6) for v in losses]}, grad_norm "
              f"{float(metrics['grad_norm']):.4f}; step b=2 128^3: median {med:.2f} ms over "
              f"steps 2-{F32_STEPS} ({[round(t, 2) for t in step_ms]}); peak memory "
              f"{train_peak:.2f} GiB")
        print("float32 train step b=2 128^3, one more step under the profiler:")
        ops.reset_counts()
        records: dict = {}
        profile_step(lambda: step(tb, roi_w), names=F32_KERNELS, by_name=records)
        _profile_gaps(records, dict(ops.LAUNCHES))
        del model, state, step, metrics, tb
        gc.collect()
        torch.cuda.empty_cache()

        cfg = ExperimentConfig(data=DataConfig(template_space=True)).normalized().model
        cfg = dataclasses.replace(cfg, compute_dtype="float32")
        model = ContraAttnUNet(cfg, device=DEVICE,
                               generator=torch.Generator().manual_seed(0)).eval()
        infer = make_infer_fn(model)
        big_args = _args(_batch(np.random.default_rng(3), b=1, s=216,
                                r=len(TEMPLATE_ROI_INDICES)), DEVICE)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_counts()
        out = infer(*big_args)
        torch.cuda.synchronize()
        paths["float32 216 forward"] = dict(ops.LAUNCHES)
        plain = dict(ops.PLAIN_ON_CUDA)
        check(tuple(out.shape) == (1, 1, 216, 216, 216) and out.dtype == torch.float32
              and bool(torch.isfinite(out).all()), f"float32 216^3 forward: out {out.shape}")
        big_ms = median_ms(lambda: infer(*big_args), reps=3, warmup=0)
        big_peak = torch.cuda.max_memory_allocated() / 2**30
        _f32_path("forward 216^3 b=1", paths["float32 216 forward"], plain,
                  ops.FWD_FAMILIES_F32, _tf32())
        print(f"float32 forward b=1 216^3 (template space, make_infer_fn): median of 3 "
              f"{big_ms:.2f} ms; peak memory {big_peak:.2f} GiB")
        del model, infer, out
        gc.collect()
        torch.cuda.empty_cache()

    # the CLI, from TF32 on: it must turn both flags off for float32
    tmp = tempfile.mkdtemp(prefix="coma_f32_")
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    try:
        t0 = time.perf_counter()
        cohort = make_synthetic_cohort(os.path.join(tmp, "cohort"), n_subjects=6, size=128,
                                       num_rois=len(ROI_INDICES))
        cohort_s = time.perf_counter() - t0
        lookup = os.path.join(tmp, "infer_lookup.csv")
        write_rows(lookup, read_csv(cohort["lookup"]).rows()[4:])
        tables = ["--covariate_csv", cohort["cov"], "--quartile_csv", cohort["quart"],
                  "--predictions_json", cohort["preds"]]
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
        peaks: dict = {}
        ops.reset_counts()
        rc, _, infer_s = _cli(["infer", "--compute_dtype", "float32", "--input_lookup", lookup,
                               "--out_dir", os.path.join(tmp, "synth")] + tables, peaks)
        paths["float32 infer (CLI)"] = dict(ops.LAUNCHES)
        plain = dict(ops.PLAIN_ON_CUDA)
        flags = _tf32()
        check(rc == 0, f"float32 infer returned {rc}")
        synth = sorted(os.listdir(os.path.join(tmp, "synth")))
        check(len(synth) == 2 and all(f.endswith("_synth_tau.nii") for f in synth),
              f"float32 infer wrote {synth}")
        for f in synth:
            vol = load_nifti_vol(os.path.join(tmp, "synth", f), resize=False)
            check(vol.shape == (1, 128, 128, 128) and bool(np.isfinite(vol).all()),
                  f"float32 infer: {f} {vol.shape}")
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"float32 infer (CLI): cohort {cohort_s:.2f} s, infer {infer_s:.2f} s for 2 "
          f"volumes, peak memory {peaks['infer']:.2f} GiB; the TF32 flags were True "
          f"before it, the CLI turned them off")
    _f32_path("infer (CLI)", paths["float32 infer (CLI)"], plain, ops.FWD_FAMILIES_F32,
              flags)
    print(f"float32 paths: phase {time.perf_counter() - t_phase:.1f} s")
    return paths


SIDE_ROWS, SIDE_ROIS = 96, 36
SIDE_EPOCHS = 4
SIDE_BATCH = 32
SIDE_LOSS_TOL = 1e-4  # |card - CPU| / CPU of train_convattn's first-epoch loss
SIDE_TOL = 1e-5       # the heads and losses on the card against the CPU, of max|CPU|


def phase_side_models() -> None:
    """Phase 16, the side models and losses on the card: `train_convattn`
    SIDE_EPOCHS epochs of a `ConvAttn` (36 ROIs, batches of SIDE_BATCH) on a
    synthetic ROI table read by `ImageDataset` -- finite losses that fall,
    the first epoch within SIDE_LOSS_TOL of the same run on the CPU; the
    UQ heads `MLP` and `AleatoricUncertaintyNet`, the four weighted losses,
    `npair_loss` on quartile templates written as NIfTI files and loaded by
    `load_quartile_templates`, `cluster_npair_loss` and
    `heteroscedastic_loss` on CUDA tensors against the CPU within SIDE_TOL
    of max|CPU|. TF32 off. No kernel of the port runs here."""
    import os
    import shutil
    import tempfile

    from coma_unet_tpu_torch import losses
    from coma_unet_tpu_torch.data.image_dataset import ImageDataset
    from coma_unet_tpu_torch.data.table import write_rows
    from coma_unet_tpu_torch.io import write_nifti
    from coma_unet_tpu_torch.losses.templates import (
        load_quartile_templates,
        select_npair_templates,
    )
    from coma_unet_tpu_torch.models.convattn import ConvAttn, train_convattn
    from coma_unet_tpu_torch.models.uq import MLP, AleatoricUncertaintyNet

    t_phase = time.perf_counter()
    rng = np.random.default_rng(0)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_side_")
    try:
        table = os.path.join(tmp, "rois.csv")
        suvr = rng.uniform(0.8, 2.5, size=(SIDE_ROWS, SIDE_ROIS))
        write_rows(table, [{f"roi_{j}": float(v) for j, v in enumerate(row)}
                           for row in suvr])
        ds = ImageDataset(table)
        check(len(ds) == SIDE_ROWS and ds[0][0].shape == (SIDE_ROIS,),
              f"side models: ImageDataset {len(ds)} rows, item {ds[0][0].shape}")
        ds.set_mean_std(ds.get_mris().mean(0), ds.get_mris().std(0))
        weights = np.linspace(0.5, 1.5, SIDE_ROIS).astype(np.float32)
        with _no_tf32():
            runs = {}
            for dev in (DEVICE, "cpu"):
                model = ConvAttn(SIDE_ROIS, output_size=SIDE_ROIS, device=dev)
                t0 = time.perf_counter()
                state, epochs = train_convattn(model, ds, weights, epochs=SIDE_EPOCHS,
                                               batch_size=SIDE_BATCH, seed=0)
                runs[dev] = (epochs, time.perf_counter() - t0, state)
            card, cpu = runs[DEVICE][0], runs["cpu"][0]
            check(all(np.isfinite(card)) and card[-1] < card[0],
                  f"side models: train_convattn losses on the card {card}")
            drift = abs(card[0] - cpu[0]) / abs(cpu[0])
            check(drift <= SIDE_LOSS_TOL, f"side models: first-epoch loss {card[0]} on the "
                  f"card vs {cpu[0]} on the CPU ({drift:.2e} > {SIDE_LOSS_TOL})")
            check(next(iter(runs[DEVICE][2].values())).is_cuda,
                  "side models: the trained state is not on the card")

            gen = torch.Generator().manual_seed(1)
            x = torch.randn((8, 24), generator=gen)
            q, q_hat = torch.randn(8, generator=gen), torch.randn(8, generator=gen)
            s2 = torch.rand(8, generator=gen) + 0.2
            pred, target = torch.randn((8, 5), generator=gen), torch.randn((8, 5), generator=gen)
            w5 = torch.rand(5, generator=gen) + 0.5
            levels = [(torch.randn((4, f), generator=gen), torch.randn((4, f), generator=gen),
                       torch.randn((4, 7, f), generator=gen)) for f in (16, 32)]
            paths = {"pos": [], "neg": []}
            for tag, base in (("pos", 10.0), ("neg", 0.0)):
                for i in range(4):
                    path = os.path.join(tmp, f"ab{tag}_quart{i + 1}.nii")
                    vol = base + i + rng.uniform(0.0, 0.5, size=(12, 12, 12))
                    write_nifti(path, vol.astype(np.float32), spacing=(2.0, 2.0, 2.0))
                    paths[tag].append(path)
            templates = load_quartile_templates(paths["pos"], paths["neg"],
                                                target=(16, 16, 16), resize=False)
            pos, negs = (torch.from_numpy(t) for t in select_npair_templates(templates, 1, 2))
            anchor = pos[None] + 0.1 * torch.randn((3, pos.numel()), generator=gen)

            def heads_and_losses(dev):
                mv = lambda t: t.to(dev)  # noqa: E731
                mlp = MLP(24, (32, 16), 3, device=dev,
                          generator=torch.Generator().manual_seed(2))
                uq = AleatoricUncertaintyNet(24, hidden=32, device=dev,
                                             generator=torch.Generator().manual_seed(3))
                with torch.no_grad():
                    out = {"MLP": mlp(mv(x)),
                           "AleatoricUncertaintyNet sigma2": uq(mv(x), mv(q_hat))[0],
                           "AleatoricUncertaintyNet confidence": uq(mv(x), mv(q_hat))[1]}
                for name in ("weighted_mse", "weighted_l1", "weighted_cc", "weighted_cccl"):
                    out[name] = getattr(losses, name)(mv(pred), mv(target), mv(w5))
                out["npair_loss"] = losses.npair_loss(mv(anchor), mv(pos), mv(negs))
                out["cluster_npair_loss"] = losses.cluster_npair_loss(
                    *[[mv(t[i]) for t in levels] for i in range(3)], temperature=0.5)
                out["heteroscedastic_loss"] = losses.heteroscedastic_loss(
                    mv(q), mv(q_hat), mv(s2))
                return out

            on_card, on_cpu = heads_and_losses(DEVICE), heads_and_losses("cpu")
        errs = {}
        for name, want in on_cpu.items():
            got = on_card[name]
            check(got.is_cuda and got.shape == want.shape and bool(torch.isfinite(got).all()),
                  f"side models: {name} on the card {got.device} {tuple(got.shape)}")
            errs[name] = float((got.cpu() - want).abs().max() / want.abs().max())
            check(errs[name] <= SIDE_TOL, f"side models: {name} on the card misses the "
                  f"CPU by {errs[name]:.2e} of max > {SIDE_TOL}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"side models: train_convattn {SIDE_EPOCHS} epochs on the card "
          f"{[round(v, 6) for v in card]} ({runs[DEVICE][1]:.2f} s) vs the CPU "
          f"{[round(v, 6) for v in cpu]} ({runs['cpu'][1]:.2f} s): first epoch "
          f"{drift:.2e} apart (limit {SIDE_LOSS_TOL})")
    print("side models: on the card against the CPU, max error over max: "
          + ", ".join(f"{name} {e:.1e}" for name, e in errs.items())
          + f" (limit {SIDE_TOL}); phase {time.perf_counter() - t_phase:.1f} s")


ANALYSIS_BATCHES = 4   # b=2 batches of 128^3 through `extract_bottleneck_encodings`
ANALYSIS_CALLS = 5     # extraction calls timed by StepTimer and by CUDA events
ANALYSIS_FEATURES = 4096  # features the probe keeps (its RFE bound)
SMOOTH_TOL = 1e-6      # |card - CPU| of `gaussian_smooth`, of max|CPU| (TF32 off)


def phase_analysis() -> dict:
    """Phase 17, the analysis on the card: the default ModelConfig flagship
    (seed 0, left in training mode, which the extraction restores) through
    `extract_bottleneck_encodings` over ANALYSIS_BATCHES
    b=2 batches at 128^3 inside `profiling.trace`: [8, 262144] finite
    features, K1, K2, K3 and K4 launched and no plain version on the card,
    a trace file holding K1 records (their count printed beside the
    launches: the profiler may miss some); the 64^3 b=2 bottleneck features
    of phase 4's model (FiLM given a signal) in bf16 on the card against
    its f32 forward on the CPU within PARITY_TOL rel L2;
    `probe_abeta_from_embeddings` on the card's features with
    ANALYSIS_FEATURES features kept and abeta four 1s and four 0s (`r2`
    and `rfe_r2` finite; its host seconds); ANALYSIS_CALLS b=2 extractions
    timed by `StepTimer` and by CUDA events; `gaussian_smooth` of a
    [2, 1, 128^3] float32 volume within SMOOTH_TOL of the CPU's (TF32 off)
    and `resize_nearest_device` bit-equal to the CPU's. Returns the
    extraction's launches."""
    import dataclasses
    import glob
    import os
    import shutil
    import tempfile

    from coma_unet_tpu_torch import ContraAttnUNet, ModelConfig, ops
    from coma_unet_tpu_torch.analysis import (
        extract_bottleneck_encodings,
        probe_abeta_from_embeddings,
    )
    from coma_unet_tpu_torch.utils import profiling

    t_phase = time.perf_counter()
    # left in training mode: the extraction runs it as eval and puts it back
    model = ContraAttnUNet(ModelConfig(), device=DEVICE,
                           generator=torch.Generator().manual_seed(0))
    loader = [_batch(np.random.default_rng(100 + i), b=2, s=128)
              for i in range(ANALYSIS_BATCHES)]
    # four 1s, then four 0s: the probe's held-out rows (6 and 2 of
    # RandomState(0)'s permutation) hold one of each
    abeta = np.repeat(np.asarray([1.0, 0.0], np.float32), ANALYSIS_BATCHES)
    for i, batch in enumerate(loader):
        batch["abeta"] = abeta[2 * i:2 * i + 2]
        batch["covars"][:, 0] = batch["abeta"]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_analysis_")
    try:
        ops.reset_counts()
        t0 = time.perf_counter()
        with profiling.trace(tmp):
            x, ab = extract_bottleneck_encodings(model, loader)
        extract_s = time.perf_counter() - t0
        launches, plain_cuda = dict(ops.LAUNCHES), dict(ops.PLAIN_ON_CUDA)
        traces = glob.glob(os.path.join(tmp, "*.json"))
        check(len(traces) == 1, f"analysis: trace files {traces}")
        with open(traces[0]) as f:
            events = json.load(f)["traceEvents"]
        k1_records = sum(1 for e in events if e.get("cat") == "kernel"
                         and "conv3d_s1_tc_kernel" in e.get("name", ""))
        trace_mb = os.path.getsize(traces[0]) / 2**20
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    n = 2 * ANALYSIS_BATCHES
    check(x.shape == (n, 512 * 8 ** 3) and x.dtype == np.float32,
          f"analysis: features {x.shape} {x.dtype}")
    check(bool(np.isfinite(x).all()), "analysis: non-finite features")
    check(model.training, "analysis: the extraction left the model in eval mode")
    check(np.array_equal(ab, abeta), f"analysis: abeta {ab}")
    for family in ops.FWD_FAMILIES:
        check(launches.get(family, 0) > 0, f"analysis: {family} did not launch")
    check(sum(plain_cuda.values()) == 0, f"analysis: plain on the GPU: {plain_cuda}")
    check(k1_records > 0, "analysis: the trace holds no K1 record")
    print(f"analysis: {n} volumes at 128^3 -> features {x.shape} in {extract_s:.2f} s "
          f"(trace on); launches {launches}; plain on cuda {plain_cuda}; trace "
          f"{trace_mb:.1f} MB with {k1_records} K1 records against {launches.get('s1', 0)} "
          f"K1 launches")

    # the 64^3 features against the f32 forward on the CPU (phase 4's model)
    s = 64
    cpu_cfg = ModelConfig(prompt_shape=(s, s, s), compute_dtype="float32")
    gen = torch.Generator().manual_seed(0)
    ref_model = ContraAttnUNet(cpu_cfg, device="cpu", generator=gen).eval()
    _film_signal(ref_model, gen)
    gpu_model = ContraAttnUNet(dataclasses.replace(cpu_cfg, compute_dtype="bfloat16"),
                               device=DEVICE).eval()
    gpu_model.load_state_dict(ref_model.state_dict())
    small = _batch(np.random.default_rng(1), b=2, s=s)
    small["covars"][:, 0] = [1.0, 0.0]
    got, _ = extract_bottleneck_encodings(gpu_model, [small])
    t0 = time.perf_counter()
    want, _ = extract_bottleneck_encodings(ref_model, [small])
    cpu_s = time.perf_counter() - t0
    rel = float(np.linalg.norm(got - want) / np.linalg.norm(want))
    check(got.shape == want.shape == (2, 512 * 4 ** 3), f"analysis: 64^3 {got.shape}")
    check(rel <= PARITY_TOL, f"analysis: 64^3 features rel L2 {rel} > {PARITY_TOL}")
    print(f"analysis: 64^3 b=2 bottleneck features, bf16 card vs f32 CPU: rel L2 "
          f"{rel:.4e} (limit {PARITY_TOL}); cpu f32 {cpu_s:.1f} s")
    del ref_model, gpu_model

    t0 = time.perf_counter()
    probe = probe_abeta_from_embeddings(x, abeta, n_features=ANALYSIS_FEATURES)
    probe_s = time.perf_counter() - t0
    check(all(np.isfinite(v) for v in probe.values()), f"analysis: probe {probe}")
    print(f"analysis: probe r2 {probe['r2']!r}, rfe_r2 {probe['rfe_r2']!r} "
          f"({ANALYSIS_FEATURES} features, {n} rows); host {probe_s:.3f} s")

    timer, event_ms = profiling.StepTimer(), []
    for i in range(ANALYSIS_CALLS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with timer.measure():
            start.record()
            extract_bottleneck_encodings(model, [loader[i % ANALYSIS_BATCHES]])
            end.record()
        end.synchronize()
        event_ms.append(start.elapsed_time(end))
    print(f"analysis: b=2 128^3 extraction (host copy in, features out): StepTimer "
          f"p50 {timer.p50() * 1e3:.2f} ms, CUDA events median "
          f"{statistics.median(event_ms):.2f} ms over {ANALYSIS_CALLS} calls "
          f"({[round(t, 2) for t in event_ms]})")
    del model

    vol = torch.from_numpy(np.random.default_rng(2).uniform(
        0, 1, (2, 1, 128, 128, 128)).astype(np.float32))
    with _no_tf32():
        smooth_card = ops.gaussian_smooth(vol.to(DEVICE)).cpu()
    smooth_cpu = ops.gaussian_smooth(vol)
    smooth_err = float((smooth_card - smooth_cpu).abs().max() / smooth_cpu.abs().max())
    check(smooth_err <= SMOOTH_TOL, f"analysis: gaussian_smooth {smooth_err} > {SMOOTH_TOL}")
    ratios, out_shape = (1.25, 0.8, 1.0 / 3.0), (103, 160, 384)
    resized = ops.resize_nearest_device(vol[0, 0].to(DEVICE), ratios, out_shape).cpu()
    check(torch.equal(resized, ops.resize_nearest_device(vol[0, 0], ratios, out_shape)),
          "analysis: resize_nearest_device on the card differs from the CPU")
    print(f"analysis: gaussian_smooth [2,1,128^3] f32 card vs CPU {smooth_err:.2e} of max "
          f"(limit {SMOOTH_TOL}); resize_nearest_device {tuple(resized.shape)} bit-equal; "
          f"phase {time.perf_counter() - t_phase:.1f} s")
    return launches


def _phase(name: str, fn, *args, **kwargs):
    """fn(*args, **kwargs), then a line with the phase's seconds."""
    t0 = time.perf_counter()
    result = fn(*args, **kwargs)
    print(f"phase {name}: {time.perf_counter() - t0:.1f} s", flush=True)
    return result


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs a GPU",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    _phase("1 device", phase_device)
    _phase("2 build", phase_build)
    if "--parity-seeds" in sys.argv:  # phase 8 alone, at seeds 0 .. n-1
        for seed in range(int(sys.argv[sys.argv.index("--parity-seeds") + 1])):
            phase_parity(s=88, b=1, template=True, seed=seed)
        return 0
    summary: dict = {}
    _phase("3 kernels", phase_kernels, summary)
    _phase("4 parity", phase_parity, f32=True)
    _phase("5 gradients b=2", phase_gradients)
    _phase("5 gradients b=3", phase_gradients, b=3, f32=True)
    paths = {"serving": _phase("6 serving", phase_serving),
             "training": _phase("7 training", phase_training)}
    torch.cuda.empty_cache()
    _phase("8 template parity", phase_parity, s=88, b=1, template=True)
    paths["template"] = _phase("9 template space", phase_template)
    torch.cuda.empty_cache()
    paths["loop"] = _phase("10 loop", phase_loop)
    torch.cuda.empty_cache()
    paths["tcds"] = _phase("11 tcds", phase_tcds)
    torch.cuda.empty_cache()
    paths["baselines"] = _phase("12 baselines", phase_baselines)
    torch.cuda.empty_cache()
    paths["data_parallel"] = _phase("13 data parallel", phase_data_parallel)
    torch.cuda.empty_cache()
    sp = _phase("14 spatial", phase_spatial)
    paths["spatial"], paths["spatial 216"] = sp[128], sp[216]
    torch.cuda.empty_cache()
    sp = _phase("14 spatial float32", phase_spatial, "float32")
    paths["float32 spatial"], paths["float32 spatial 216"] = sp[128], sp[216]
    torch.cuda.empty_cache()
    paths.update(_phase("15 float32", phase_float32))
    torch.cuda.empty_cache()
    _phase("16 side models", phase_side_models)
    torch.cuda.empty_cache()
    paths["analysis"] = _phase("17 analysis", phase_analysis)
    kernels = []
    for family, (name, source, replaces) in SOURCES.items():
        entry = summary[family]
        base, dtype = _base(family)
        # K4's slab halves run on the depth-sharded path alone; the float32
        # forms' main path is phase 15's train steps
        if base in ("norm_stats", "norm_apply"):
            main_path = "float32 spatial" if dtype == torch.float32 else "spatial"
        else:
            main_path = "float32 train" if dtype == torch.float32 else "tcds"
        kernels.append({
            "name": name, "dtype": str(dtype).replace("torch.", ""), "route": "cuda",
            "source": source, "replaces": replaces,
            "launches": paths[main_path].get(family, 0),
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
