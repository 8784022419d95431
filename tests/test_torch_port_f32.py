"""The float32 forms of the port's kernels, checked on the CPU, where no
kernel runs: FB1 (`csrc/conv3d_dw_f32.cu`, cut by `ops/conv3d.py:fb1_plan`),
the dtype rules of the wrappers, and the CLI's float32 on CUDA. F1, the
stride-1 conv in f32, is checked in `tests/test_torch_port_f1_tc.py`; F2,
the stride-2 and transposed convs, in `tests/test_torch_port_f2_tc.py`.

(a) The stride-1 conv shapes the paths reach (the K1 cases of
    `chip_smoke.py` phase 3, whose shapes the float32 paths share) take
    F1's wide and narrow tiles; at every KB1 and KB2 shape the FB1 plan's
    splits cover every brick of every sample once, its bricks every
    position of g's grid once, its tiles every channel pair once, within
    227 KB and 288 threads. A shape it cannot cut raises.
(b) A float64 emulation of FB1's index maps, cut as its plan says -- the
    staged box with its zero fill (the strided map: its even positions
    first), each split's partial summed in split order -- equals the plain
    version (PyTorch's conv) within 1e-10, for shared and per-sample
    weights and both weight-gradient maps.
(c) `check_cuda_input` takes float32 and refuses a tensor of another dtype
    than its call's; a bf16 x with f32 weights raises in `check_conv_args`
    (never cast), and float16 raises.
(d) The CLI: `--compute_dtype float32 --device cuda` (the device and the
    model builder patched, since no card is here) builds a float32 model
    with TF32 off in cuDNN and in matmul; float16 on CUDA exits 2 before a
    model is built.

The whole slice against JAX in float32 is covered on the CPU by
`tests/test_e2e_torch_parity.py` and the port's parity files
(`test_torch_port_model.py`, `_train.py`, `_eval.py`, `_grads.py`), whose
models are float32: they are not repeated here. K4's and KB3's plan at
element size 4 is in `tests/test_torch_port_norm_plan.py`.
"""

import importlib
import itertools

import numpy as np
import pytest
import torch

import chip_smoke
from coma_unet_tpu_torch import ops
from coma_unet_tpu_torch.ops import _build
from coma_unet_tpu_torch.ops.conv3d import (
    FB1_MAX_THREADS,
    GRID_MAX,
    SMEM_MAX,
    check_conv_args,
    conv3d_weight_ref,
    f1_plan,
    fb1_plan,
)

TOL = 1e-10


def _cdiv(a, b):
    return -(-a // b)


def _half(n):
    return (n - 1) // 2 + 1


def _conv_shapes():
    """(mode, b, cin, cout, d, h, w, k) of every K1 case of phase 3, as the
    kernel sees it (an input gradient: the cotangent in)."""
    shapes = set()
    for family, _, xshape, wshape, extra, entry in chip_smoke._kernel_cases():
        if family == "s1":
            b, cin, d, h, w = xshape
            cout = wshape[1] if entry == "dx" else wshape[0]
            shapes.add((family, b, cin, cout, d, h, w, wshape[-1]))
    return sorted(shapes)


def _dw_shapes():
    """(mode, b, cin, cout, d, h, w, k) of every KB1 and KB2 case of phase
    3: x (full) [b, cin, d, h, w], cout channels of g (half)."""
    shapes = set()
    for family, _, xshape, wshape, _, _ in chip_smoke._kernel_cases():
        if family == "s1_dw":
            shapes.add(("s1",) + tuple(xshape) + (wshape[0], wshape[1]))
        elif family == "strided_dw":
            shapes.add(("s2",) + tuple(xshape) + (wshape[1], 3))
    return sorted((m, b, ci, co, d, h, w, k) for m, b, ci, d, h, w, co, k in shapes)


def test_phase3_shapes_cover_every_conv_site():
    conv, dw = _conv_shapes(), _dw_shapes()
    assert {s[0] for s in conv} == {"s1"} and len(conv) >= 25
    assert {s[0] for s in dw} == {"s1", "s2"} and len(dw) >= 20
    # the wide layers take 32 or 64 channels a block, the narrow ones 8 or 16
    assert (f1_plan(2, 32, 32, 128, 128, 128, 3).at, f1_plan(2, 64, 64, 64, 64, 64, 3).at) == (
        32, 64)
    assert [f1_plan(2, 16, c, 128, 128, 128, 3).at for c in (1, 3, 8, 16)] == [8, 8, 8, 16]


# ---------------------------------------------------------------- FB1 plan
@pytest.mark.parametrize("shape", sorted(set(_dw_shapes()) | {
    ("s1", 2, 5, 3, 9, 10, 37, 3), ("s1", 1, 9, 17, 5, 3, 33, 1),
    ("s2", 2, 3, 5, 9, 17, 35, 3)}), ids=lambda s: "x".join(map(str, s)))
def test_fb1_plan_covers_every_position_and_weight_once(shape):
    mode, b, cin, cout, d, h, w, k = shape
    plan = fb1_plan(mode, b, cin, cout, d, h, w, k)
    assert plan.threads == k * k * plan.cg * plan.og <= FB1_MAX_THREADS
    assert plan.smem <= SMEM_MAX and max(plan.grid[1:]) <= GRID_MAX
    assert (plan.ct, plan.at) == (4 * plan.cg, plan.qo * plan.og)
    assert plan.grid == (_cdiv(cin, plan.ct), _cdiv(cout, plan.at), plan.splits)
    size = (_half(d), _half(h), _half(w)) if mode == "s2" else (d, h, w)
    nb = [_cdiv(n, m) for n, m in zip(size, plan.brick)]
    assert plan.bricks == nb[0] * nb[1] * nb[2]
    assert plan.splits == b * plan.splits_per_sample == b * _cdiv(plan.bricks, plan.bps)
    assert plan.workspace == plan.splits * cout * cin * k ** 3
    # each sample's bricks once over its splits; each brick's positions tile
    # g's grid once
    seen = np.zeros((b, plan.bricks), np.int32)
    for split in range(plan.splits):
        s = split % plan.splits_per_sample
        seen[split // plan.splits_per_sample, s * plan.bps:(s + 1) * plan.bps] += 1
    assert (seen == 1).all()
    j = np.arange(plan.bricks)
    bw, bh, bd = j % nb[2], (j // nb[2]) % nb[1], j // (nb[2] * nb[1])
    bd_, bh_, bw_ = plan.brick
    off = np.stack(np.meshgrid(np.arange(bd_), np.arange(bh_), np.arange(bw_), indexing="ij"),
                   -1).reshape(-1, 3)
    pd_ = (bd[:, None] * bd_ + off[None, :, 0]).reshape(-1)
    ph_ = (bh[:, None] * bh_ + off[None, :, 1]).reshape(-1)
    pw_ = (bw[:, None] * bw_ + off[None, :, 2]).reshape(-1)
    keep = (pd_ < size[0]) & (ph_ < size[1]) & (pw_ < size[2])
    counts = np.bincount(((pd_ * size[1] + ph_) * size[2] + pw_)[keep],
                         minlength=size[0] * size[1] * size[2])
    assert (counts == 1).all()
    # every (o, c, t) of dW once: tiles of channels x threads' (kd, kh, kw)
    tid = np.arange(plan.threads)
    oi, ci, tg = tid % plan.og, (tid // plan.og) % plan.cg, tid // (plan.og * plan.cg)
    cover = np.zeros((cout, cin, k ** 3), np.int32)
    for gx, gy in itertools.product(range(plan.grid[0]), range(plan.grid[1])):
        for q, c, kw in itertools.product(range(plan.qo), range(4), range(k)):
            o = gy * plan.at + oi * plan.qo + q
            cc = gx * plan.ct + ci * 4 + c
            t = tg * k + kw
            ok = (o < cout) & (cc < cin)
            np.add.at(cover, (o[ok], cc[ok], t[ok]), 1)
    assert (cover == 1).all()


def test_fb1_plan_raises_on_shapes_it_cannot_cut():
    with pytest.raises(ValueError):
        fb1_plan("s1", 1, 4, 4, 2048, 1024, 1024, 3)
    with pytest.raises(ValueError):
        fb1_plan("s2", 1, 4, 4, 8, 8, 8, 1)
    with pytest.raises(ValueError):
        fb1_plan("s1", 1, 4, 4 * 8 * (GRID_MAX + 1), 8, 8, 8, 3)


# ------------------------------------------------------------ emulation
def emulate_fb1(x, g, plan, per_sample):
    """FB1 as the kernel computes it, in x's dtype: each split's partial
    over its bricks (the staged x box, S2 split by parity along W, the g
    tile zero past the grid), the (kd, kh) pairs' k taps along W, then the
    partials summed in split order."""
    mode, k = plan.mode, plan.k
    b_n, cin = x.shape[:2]
    cout = g.shape[1]
    d, h, wd = x.shape[2:]
    size = g.shape[2:]
    bd, bh, bw = plan.brick
    xd, xh, xw = plan.box
    nbh, nbw = _cdiv(size[1], bh), _cdiv(size[2], bw)
    parts = []
    for split in range(plan.splits):
        b, s = divmod(split, plan.splits_per_sample)
        part = torch.zeros((cout, cin, k, k, k), dtype=x.dtype)
        for j in range(s * plan.bps, min((s + 1) * plan.bps, plan.bricks)):
            p0 = ((j // (nbw * nbh)) * bd, ((j // nbw) % nbh) * bh, (j % nbw) * bw)
            org = [2 * p - 1 for p in p0] if mode == 1 else [p - k // 2 for p in p0]
            box = torch.zeros((cin, xd, xh, plan.row), dtype=x.dtype)
            src = [(max(o_, 0), min(o_ + n, lim)) for o_, n, lim in zip(org, (xd, xh, xw), (d, h, wd))]
            if all(lo < hi for lo, hi in src):
                cols = torch.arange(src[2][0] - org[2], src[2][1] - org[2])
                if mode == 1:
                    cols = (cols % 2) * ((xw + 1) // 2) + cols // 2
                box[:, src[0][0] - org[0]:src[0][1] - org[0],
                    src[1][0] - org[1]:src[1][1] - org[1], cols] = \
                    x[b, :, src[0][0]:src[0][1], src[1][0]:src[1][1], src[2][0]:src[2][1]]
            gt = torch.zeros((cout, bd, bh, bw), dtype=x.dtype)
            n = [min(m, lim - p) for m, lim, p in zip((bd, bh, bw), size, p0)]
            gt[:, :n[0], :n[1], :n[2]] = g[b, :, p0[0]:p0[0] + n[0], p0[1]:p0[1] + n[1],
                                           p0[2]:p0[2] + n[2]]
            for kd, kh, kw in itertools.product(range(k), repeat=3):
                if mode == 1:
                    half = (xw + 1) // 2
                    cols = {0: slice(0, bw), 1: slice(half, half + bw), 2: slice(1, bw + 1)}[kw]
                    xv = box[:, kd:kd + 2 * bd:2, kh:kh + 2 * bh:2, cols]
                else:
                    xv = box[:, kd:kd + bd, kh:kh + bh, kw:kw + bw]
                part[:, :, kd, kh, kw] += torch.einsum("odhw,cdhw->oc", gt, xv)
        parts.append(part)
    parts = torch.stack(parts)
    if per_sample:
        return parts.reshape((b_n, plan.splits_per_sample) + parts.shape[1:]).sum(1)
    return parts.sum(0)


@pytest.mark.parametrize("mode,spatial,k", [
    ("s1", (5, 9, 37), 3), ("s1", (3, 5, 40), 1), ("s2", (5, 9, 67), 3)],
    ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else str(v))
@pytest.mark.parametrize("per_sample", [False, True])
def test_fb1_emulation_matches_plain(mode, spatial, k, per_sample, monkeypatch):
    import coma_unet_tpu_torch.ops.conv3d as conv

    b, cin, cout = 2, 6, 5
    # small runs, so that a sample takes several splits
    monkeypatch.setattr(conv, "FB1_MIN_BRICKS", 1)
    monkeypatch.setattr(conv, "FB1_MAX_POSITIONS", 2 * 128)
    gen = torch.Generator().manual_seed(4)
    x = torch.randn((b, cin) + spatial, generator=gen, dtype=torch.float64)
    gsize = tuple(_half(n) for n in spatial) if mode == "s2" else spatial
    g = torch.randn((b, cout) + gsize, generator=gen, dtype=torch.float64)
    plan = fb1_plan(mode, b, cin, cout, *spatial, k)
    assert plan.splits_per_sample > 1
    got = emulate_fb1(x, g, plan, per_sample)
    want = conv3d_weight_ref(x, g, k, per_sample, stride=2 if mode == "s2" else 1)
    assert float((got - want).abs().max()) <= TOL * float(want.abs().max())


# ------------------------------------------------------------ dtype rules
def test_check_cuda_input_takes_the_call_sites_dtype():
    cpu = torch.device("cpu")
    x = torch.zeros((2, 3, 4, 4, 4))
    _build.check_cuda_input("x", x, 5, cpu, torch.float32)
    _build.check_cuda_input("x", x.bfloat16(), 5, cpu, torch.bfloat16)
    with pytest.raises(ValueError, match="bfloat16"):
        _build.check_cuda_input("x", x, 5, cpu, torch.bfloat16)
    with pytest.raises(ValueError, match="float32"):
        _build.check_cuda_input("x", x.bfloat16(), 5, cpu, torch.float32)
    assert _build.kernel_dtype("x", x) == torch.float32
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        _build.kernel_dtype("x", x.half())
    assert _build.family("s1", torch.float32) == "s1_f32"
    assert _build.family("s1", torch.bfloat16) == "s1"
    assert set(ops.F32_FAMILIES) == {f + "_f32" for f in ops.PATH_FAMILIES + ops.SLAB_FAMILIES
                                     + ops.ENTRY_FAMILIES}


def test_conv_args_refuse_mixed_dtypes():
    x = torch.zeros((2, 3, 4, 4, 4))
    w = torch.zeros((5, 3, 3, 3, 3))
    assert check_conv_args(x, w, None, (3,))[:2] == (3, False)
    with pytest.raises(ValueError):
        check_conv_args(x.bfloat16(), w, None, (3,))
    with pytest.raises(ValueError):
        check_conv_args(x, w.bfloat16(), None, (3,))
    with pytest.raises(ValueError):
        check_conv_args(x.half(), w.half(), None, (3,))


# ------------------------------------------------------------------- CLI
def _cli_args(tmp_path):
    """A train command whose tables need not exist: the model is built,
    and the patched builder stops the run there."""
    return ["train", "--splits_dir", str(tmp_path), "-save_path", str(tmp_path / "run"),
            "--covariate_csv", str(tmp_path / "c.csv"), "--quartile_csv", str(tmp_path / "q.csv"),
            "--device", "cuda"]


class _Built(Exception):
    pass


def _cli():
    # the package's `cli.main` is the function; the module is in sys.modules
    return importlib.import_module("coma_unet_tpu_torch.cli.main")


def test_cli_float32_on_cuda_builds_an_f32_model_with_tf32_off(tmp_path, monkeypatch):
    from coma_unet_tpu_torch.train import loop

    cli = _cli()

    seen = {}

    def build(config, device):
        seen.update(dtype=config.model.compute_dtype, device=device,
                    cudnn=torch.backends.cudnn.allow_tf32,
                    matmul=torch.backends.cuda.matmul.allow_tf32)
        raise _Built

    monkeypatch.setattr(loop, "require_device", lambda device: torch.device(device))
    monkeypatch.setattr(cli, "_build_model", build)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    with pytest.raises(_Built):
        cli.main(_cli_args(tmp_path) + ["--compute_dtype", "float32"])
    assert seen == dict(dtype="float32", device=torch.device("cuda"), cudnn=False, matmul=False)


def test_cli_float16_on_cuda_exits_2_before_a_model(tmp_path, monkeypatch, capsys):
    cli = _cli()

    def no_model(*a, **k):
        raise AssertionError("a model was built")

    monkeypatch.setattr(cli, "_build_model", no_model)
    assert cli.main(_cli_args(tmp_path) + ["--compute_dtype", "float16"]) == 2
    err = capsys.readouterr().err
    assert "bfloat16" in err and "float32" in err and "--device cpu" in err
