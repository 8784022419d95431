"""The PyTorch port's kernel families (`coma_unet_tpu_torch.ops`) against
the JAX package's Pallas kernels, which run here in interpret mode.

On a CPU tensor each op wrapper runs its plain PyTorch version, so these
tests pin the plain versions, and the layouts and conventions around the
CUDA kernels (OIDHW weights, per-sample CondConv weights, the lhs-dilated
transposed-conv weights), to the reference at f32: every case holds
max|port - jax| / max|jax| < 1e-5. The shapes are those of the JAX package's
own kernel tests. The kernels themselves run only on the GPU, where
`chip_smoke.py` compares each with its plain version.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import coma_unet_tpu.ops.pallas.conv3d as c3  # noqa: E402
import coma_unet_tpu.ops.pallas.conv3d_strided as strided  # noqa: E402
from coma_unet_tpu.ops import roi as jax_roi  # noqa: E402
from coma_unet_tpu.ops.pallas.conv3d_p1 import _p1_fwd  # noqa: E402
from coma_unet_tpu.ops.pallas.conv3d_packed import _packed_fwd  # noqa: E402
from coma_unet_tpu.ops.pallas.norm_act import norm_act as jax_norm_act  # noqa: E402
from coma_unet_tpu_torch import ops  # noqa: E402
from coma_unet_tpu_torch.ops import _build  # noqa: E402

TOL = 1e-5


def _rel(got, want) -> float:
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / np.abs(want).max())


def _conv_data(seed, xshape, wshape):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, xshape).astype(np.float32)
    w = rng.uniform(-0.3, 0.3, wshape).astype(np.float32)
    return x, w


def _port(fn, x, w):
    return fn(torch.from_numpy(x), torch.from_numpy(w)).numpy()


# (Pallas entry, input shape, weight shape): shared [Cout, Cin, k, k, k] or
# per-sample [B, Cout, Cin, k, k, k] weights
S1_CASES = {
    "p1": (lambda x, w: _p1_fwd(x, w, interpret=True), [
        ((1, 3, 8, 6, 128), (5, 3, 3, 3, 3)),
        ((2, 8, 4, 8, 128), (16, 8, 3, 3, 3)),
        ((1, 1, 4, 4, 128), (4, 1, 3, 3, 3)),      # Cin = 1: the U-Net head
        ((2, 4, 4, 6, 128), (2, 6, 4, 3, 3, 3)),   # per sample
    ]),
    "conv3d": (lambda x, w: c3._pallas_conv3d_fwd(x, w, w.shape[-1],
                                                   interpret=True), [
        ((2, 4, 5, 8, 128), (5, 4, 3, 3, 3)),
        ((1, 3, 4, 16, 128), (4, 3, 1, 1, 1)),     # k = 1
        ((1, 1, 3, 8, 128), (2, 1, 3, 3, 3)),
        ((3, 4, 8, 8, 8), (3, 5, 4, 3, 3, 3)),     # per sample
        ((2, 3, 4, 8, 128), (2, 1, 3, 1, 1, 1)),   # per sample, k = 1
    ]),
    "packed": (lambda x, w: strided.unpack_w(
        _packed_fwd(strided.pack_w(x), w, interpret=True)), [
        ((2, 3, 6, 8, 64), (5, 3, 3, 3, 3)),
        ((3, 4, 8, 8, 64), (3, 5, 4, 3, 3, 3)),    # per sample
    ]),
}


@pytest.mark.parametrize("kernel,index", [
    (name, i) for name, (_, cases) in S1_CASES.items()
    for i in range(len(cases))])
def test_conv3d_s1_matches_pallas(kernel, index):
    fn, cases = S1_CASES[kernel]
    xshape, wshape = cases[index]
    x, w = _conv_data(index, xshape, wshape)
    want = fn(jnp.asarray(x), jnp.asarray(w))
    assert _rel(_port(ops.conv3d_s1, x, w), want) < TOL


@pytest.mark.parametrize("wshape", [(5, 3, 3, 3, 3), (2, 5, 3, 3, 3, 3)])
def test_conv3d_s2_matches_pallas(wshape):
    x, w = _conv_data(1, (2, 3, 8, 8, 8), wshape)
    want = strided.unpack_w(strided._s2_fwd(jnp.asarray(x), jnp.asarray(w),
                                            interpret=True))
    assert _rel(_port(ops.conv3d_s2, x, w), want) < TOL


@pytest.mark.parametrize("wshape", [(5, 3, 3, 3, 3), (2, 5, 3, 3, 3, 3)])
def test_conv3d_t2_matches_pallas(wshape):
    x, w = _conv_data(2, (2, 3, 6, 8, 16), wshape)
    want = strided._t2_fwd(strided.pack_w(jnp.asarray(x)), jnp.asarray(w),
                           interpret=True)
    assert _rel(_port(ops.conv3d_t2, x, w), want) < TOL


def test_conv_bias_is_added():
    x, w = _conv_data(3, (2, 3, 4, 4, 4), (5, 3, 3, 3, 3))
    bias = torch.linspace(-1.0, 1.0, 5)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    for fn in (ops.conv3d_s1, ops.conv3d_s2, ops.conv3d_t2):
        got = fn(xt, wt, bias) - fn(xt, wt)
        torch.testing.assert_close(got, bias.reshape(1, -1, 1, 1, 1).expand_as(got),
                                   rtol=0, atol=1e-6)


@pytest.mark.parametrize("act,film", [
    ("none", True), ("relu", True), ("leakyrelu", True), ("prelu", True),
    ("relu", False)])
def test_norm_act_matches_pallas(act, film):
    rng = np.random.default_rng(4)
    b, c = 2, 3
    x = rng.normal(size=(b, c, 4, 8, 128)).astype(np.float32)
    alpha = np.asarray([0.25], np.float32)
    scale = shift = None
    if film:
        scale = (1.0 + 0.3 * rng.normal(size=(b, c))).astype(np.float32)
        shift = (0.3 * rng.normal(size=(b, c))).astype(np.float32)
    want = jax_norm_act(jnp.asarray(x), jnp.asarray(alpha), act,
                        None if scale is None else jnp.asarray(scale),
                        None if shift is None else jnp.asarray(shift))
    t = (lambda a: None if a is None else torch.from_numpy(a))
    got = ops.norm_act(t(x), t(alpha), act, t(scale), t(shift))
    assert _rel(got.numpy(), want) < TOL


def test_norm_act_single_channel_matches_pallas():
    # the modulator's C == 1 outputs: the TPU kernel's [1, B, ...] view
    rng = np.random.default_rng(5)
    x = rng.normal(size=(3, 1, 4, 8, 128)).astype(np.float32)
    alpha = np.asarray([0.25], np.float32)
    want = jax_norm_act(jnp.asarray(x), jnp.asarray(alpha), "prelu")
    got = ops.norm_act(torch.from_numpy(x), torch.from_numpy(alpha), "prelu")
    assert _rel(got.numpy(), want) < TOL


def test_roi_ops_match_jax():
    rng = np.random.default_rng(6)
    labels = (17, 1001, 2035, 49)
    raw = rng.choice([0, 5, 17, 1001, 2035, 49, 4095, 9000],
                     size=(2, 6, 5, 4)).astype(np.int32)
    values = rng.normal(size=(2, len(labels))).astype(np.float32)
    lut = ops.make_roi_lut(labels)
    np.testing.assert_array_equal(lut.numpy(), np.asarray(jax_roi.make_roi_lut(labels)))
    compact = ops.compact_roi(torch.from_numpy(raw), lut)
    want = jax_roi.compact_roi(jnp.asarray(raw), jax_roi.make_roi_lut(labels))
    np.testing.assert_array_equal(compact.numpy(), np.asarray(want))
    # ids past R paint the background, as in the JAX select chain
    compact[0, 0, 0, 0] = len(labels) + 3
    got = ops.paint_roi_values(compact, torch.from_numpy(values), 0.5)
    want = jax_roi.paint_roi_values(jnp.asarray(compact.numpy()),
                                    jnp.asarray(values), 0.5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_wrappers_count_plain_calls_by_device():
    _build.reset_counts()
    x, w = _conv_data(7, (1, 2, 4, 4, 4), (3, 2, 3, 3, 3))
    ops.conv3d_s1(torch.from_numpy(x), torch.from_numpy(w))
    assert _build.PLAIN_ON_CPU["s1"] == 1
    assert not _build.LAUNCHES and not _build.PLAIN_ON_CUDA


def test_wrappers_reject_other_devices():
    x = torch.empty((1, 2, 4, 4, 4), device="meta")
    w = torch.empty((3, 2, 3, 3, 3), device="meta")
    for fn in (ops.conv3d_s1, ops.conv3d_s2, ops.conv3d_t2):
        with pytest.raises(ValueError, match="unsupported device"):
            fn(x, w)
    with pytest.raises(ValueError, match="unsupported device"):
        ops.norm_act(x, None, "relu")


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    import shutil

    from torch.utils import cpp_extension

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(cpp_extension, "CUDA_HOME", None)
    monkeypatch.setattr(shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build()
    assert not list(tmp_path.iterdir())
