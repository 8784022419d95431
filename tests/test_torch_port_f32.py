"""The float32 forms of the port's kernels, checked on the CPU, where no
kernel runs: the phase-3 shapes the float32 paths share, the dtype rules of
the wrappers, and the CLI's float32 on CUDA. F1, the stride-1 conv in f32,
is checked in `tests/test_torch_port_f1_tc.py`; F2, the stride-2 and
transposed convs, in `tests/test_torch_port_f2_tc.py`; FB1, the weight
gradients, in `tests/test_torch_port_fb1_tc.py`.

(a) The stride-1 conv shapes the paths reach (the K1 cases of
    `chip_smoke.py` phase 3, whose shapes the float32 paths share) take
    F1's wide and narrow tiles, and phase 3 has weight-gradient cases of
    both maps.
(b) `check_cuda_input` takes float32 and refuses a tensor of another dtype
    than its call's; a bf16 x with f32 weights raises in `check_conv_args`
    (never cast), and float16 raises.
(c) The CLI: `--compute_dtype float32 --device cuda` (the device and the
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

import pytest
import torch

import chip_smoke
from coma_unet_tpu_torch import ops
from coma_unet_tpu_torch.ops import _build
from coma_unet_tpu_torch.ops.conv3d import check_conv_args, f1_plan


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
