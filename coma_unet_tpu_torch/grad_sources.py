"""Phase 5's float32 gradient readings of `chip_smoke.py`, repeated and with
the float32 conv kernels swapped one at a time for their plain versions
(cuDNN in f32, TF32 off), to find which kernel moves them.

    python3 -m coma_unet_tpu_torch.grad_sources TAG [short]

Run from the root of a tree (its `chip_smoke.py` gives the batch, the model
set-up and the gradient groups; a tree unpacked elsewhere runs it with
`PYTHONPATH=.`). It builds phase 5's 64^3 b=3 model and batch, takes the
step's gradients on the CPU in f32 and in f64, and on the card in float32
as the port runs it: three times, then once with cuDNN deterministic. Each
line prints, for a few groups, the card's rel L2 error against the CPU's
f32 / against the CPU's f64, and whether the gradients equal the previous
reading's bit for bit. Without `short` it goes on with F1 (`conv_f32`), F2
(`conv_f2`), FB1's stride-1 map and FB1's strided map (both launched by
`conv3d.dw_f32`) each replaced by its plain version, then all four with
cuDNN deterministic. The swaps are this diagnostic's own; the port never
runs a plain version on the card.
"""

from __future__ import annotations

import dataclasses
import sys

import numpy as np
import torch

SHOW = ("pos_dynamic_prompt", "neg_dynamic_prompt", "general_dynamic_prompt", "unet.head",
        "unet.down0", "unet.merge1", "deep_modulator_3c", "fusion_layer")


def rel(a: dict, o: dict, names) -> float:
    num = sum(float((a[n] - o[n]).square().sum()) for n in names)
    den = sum(float(o[n].square().sum()) for n in names)
    return (num / den) ** 0.5


def main(tag: str, short: bool) -> None:
    import chip_smoke as cs
    import coma_unet_tpu_torch.ops.conv3d as conv
    import coma_unet_tpu_torch.ops.conv3d_strided as strided
    from coma_unet_tpu_torch import ContraAttnUNet, LossConfig, ModelConfig

    s, b = 64, 3
    cfg = ModelConfig(prompt_shape=(s,) * 3)
    gen = torch.Generator().manual_seed(0)
    ref = ContraAttnUNet(dataclasses.replace(cfg, compute_dtype="float32"), device="cpu",
                         generator=gen)
    cs._film_signal(ref, gen)
    batch = cs._batch(np.random.default_rng(1), b=b, s=s)
    batch["covars"][:, 0] = [1.0, 0.0, 1.0]
    lc = LossConfig(rnc=True)
    _, _, g_ref, _ = cs._loss_and_grads(ref, batch, "cpu", lc)
    m64 = ContraAttnUNet(dataclasses.replace(ref.config, compute_dtype="float64"),
                         device="cpu")
    m64.load_state_dict(ref.state_dict())
    _, _, g64, _ = cs._loss_and_grads(m64, batch, "cpu", lc)
    del m64
    skip = cs._norm_fed_biases(ref)
    groups: dict = {}
    for n, g in g_ref.items():
        if g is not None and n not in skip:
            groups.setdefault(cs._group(n), []).append(n)
    print(f"{tag} cpu32-f64 " + " ".join(f"{k}={rel(g_ref, g64, groups[k]):.3e}" for k in SHOW),
          flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    model = ContraAttnUNet(dataclasses.replace(ref.config, compute_dtype="float32"),
                           device="cuda")
    model.load_state_dict(ref.state_dict())
    last: dict = {}

    def reading(label: str) -> None:
        _, _, g, _ = cs._loss_and_grads(model, batch, "cuda", lc)
        same = "" if not last else " bit-equal-to-previous=" + str(
            all(torch.equal(g[n], last[n]) for n in g if g[n] is not None))
        last.update(g)
        print(f"{tag} {label}: " + " ".join(
            f"{k}={rel(g, g_ref, groups[k]):.3e}/{rel(g, g64, groups[k]):.3e}" for k in SHOW)
            + same, flush=True)

    for i in range(3):
        reading(f"as-is #{i}")
    torch.backends.cudnn.deterministic = True
    reading("cudnn-deterministic #0")
    torch.backends.cudnn.deterministic = False
    if short:
        return

    def f1_plain(plan, x, w, bias32, per_sample, flip):
        return conv.conv3d_ref(x, conv.flip_t(w) if flip else w, bias32)

    def f2_plain(plan, x, w, bias32, per_sample, flip):
        wt = conv.flip_t(w) if flip else w
        return (conv.conv3d_ref(x, wt, bias32, stride=2) if plan.mode == "s2"
                else strided.conv_transpose3d_ref(x, wt, bias32))

    good_f1, good_f2, good_dw = conv.conv_f32, strided.conv_f2, conv.dw_f32

    def dw_plain(maps):
        # FB1's maps in `maps` (0: stride-1; 1: strided, whose (full, half)
        # the wrapper passes as (x, g) for the stride-2 conv and (g, x) for
        # the transposed one) by PyTorch's weight gradient
        def swapped(plan, x, g, per_sample):
            if plan.mode in maps:
                return conv.conv3d_weight_ref(x, g, plan.k, per_sample,
                                              stride=2 if plan.mode == 1 else 1)
            return good_dw(plan, x, g, per_sample)
        return swapped

    conv.conv_f32 = f1_plain
    reading("F1->cudnn #0")
    reading("F1->cudnn #1")
    conv.conv_f32 = good_f1
    strided.conv_f2 = f2_plain
    reading("F2->cudnn")
    strided.conv_f2 = good_f2
    conv.dw_f32 = dw_plain((0,))
    reading("FB1(s1)->cudnn")
    conv.dw_f32 = dw_plain((1,))
    reading("FB1(strided)->cudnn")
    torch.backends.cudnn.deterministic = True
    conv.conv_f32, strided.conv_f2, conv.dw_f32 = f1_plain, f2_plain, dw_plain((0, 1))
    reading("all->cudnn deterministic #0")
    reading("all->cudnn deterministic #1")
    conv.conv_f32, strided.conv_f2, conv.dw_f32 = good_f1, good_f2, good_dw


if __name__ == "__main__":
    main(sys.argv[1], len(sys.argv) > 2 and sys.argv[2] == "short")
