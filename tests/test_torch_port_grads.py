"""The backward half of the PyTorch port's kernel families against the JAX
package's Pallas backward kernels, which run here in interpret mode, and
the port's autograd Functions against torch autograd of the plain forward.

On a CPU tensor each wrapper runs its plain PyTorch version, so the first
group pins the plain versions of KB1 (`conv3d_s1_dw`), KB2
(`conv3d_strided_dw`, both roles) and KB3 (`norm_act_bwd`) to the Pallas
kernels they replace, at the shapes of the JAX package's own kernel tests;
the second pins each Function's gradient assembly (flipped, io-swapped
weights for dx, the role swap and tap flip of the transposed conv's dW,
dbias, the FiLM and PReLU gradients) to autograd. Every case holds
max|port - reference| / max|reference| < 1e-5 in f32. The CUDA kernels
themselves run only on the GPU, where `chip_smoke.py` compares each with
its plain version.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import coma_unet_tpu.ops.pallas.conv3d as c3  # noqa: E402
import coma_unet_tpu.ops.pallas.conv3d_strided as strided  # noqa: E402
from coma_unet_tpu.ops.pallas.conv3d_p1 import _p1_dw  # noqa: E402
from coma_unet_tpu.ops.pallas.conv3d_packed import _packed_dw  # noqa: E402
from coma_unet_tpu.ops.pallas.norm_act import (  # noqa: E402
    _norm_act_bwd_impl,
    _norm_act_fwd_impl,
)
from coma_unet_tpu.ops.phase_dot import shift_dot_dw  # noqa: E402
from coma_unet_tpu_torch import ops  # noqa: E402
from coma_unet_tpu_torch.ops.conv3d import conv3d_ref  # noqa: E402
from coma_unet_tpu_torch.ops.conv3d_strided import conv_transpose3d_ref  # noqa: E402

TOL = 1e-5


def _rel(got, want) -> float:
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _data(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.uniform(-1, 1, s).astype(np.float32) for s in shapes]


def _t(a):
    return torch.from_numpy(a)


# ------------------------------------------------------------- KB1 (s1 dW)
# (Pallas dW, x shape, Cout, k, per_sample): the shapes of
# tests/test_pallas_conv.py, test_p1_conv.py and test_packed_level.py
S1_DW_CASES = {
    "conv3d_k3": (lambda x, g, ps: c3._pallas_conv3d_dw(
        x, g, 3, batched=ps, interpret=True), (2, 3, 4, 8, 128), 5, 3, False),
    "conv3d_k3_per_sample": (lambda x, g, ps: c3._pallas_conv3d_dw(
        x, g, 3, batched=ps, interpret=True), (3, 4, 8, 8, 8), 5, 3, True),
    "conv3d_k1": (lambda x, g, ps: c3._pallas_conv3d_dw(
        x, g, 1, batched=ps, interpret=True), (2, 4, 8, 8, 128), 3, 1, False),
    "conv3d_k1_per_sample": (lambda x, g, ps: c3._pallas_conv3d_dw(
        x, g, 1, batched=ps, interpret=True), (2, 4, 8, 8, 128), 3, 1, True),
    "p1": (lambda x, g, ps: _p1_dw(x, g, batched=ps, interpret=True),
           (2, 3, 4, 6, 128), 5, 3, False),
    "p1_per_sample": (lambda x, g, ps: _p1_dw(x, g, batched=ps,
                                              interpret=True),
                      (2, 3, 4, 6, 128), 5, 3, True),
    "packed": (lambda x, g, ps: _packed_dw(
        strided.pack_w(x), strided.pack_w(g), batched=ps, interpret=True),
        (2, 3, 6, 8, 64), 5, 3, False),
    "packed_per_sample": (lambda x, g, ps: _packed_dw(
        strided.pack_w(x), strided.pack_w(g), batched=ps, interpret=True),
        (3, 4, 8, 8, 64), 5, 3, True),
    # Cin = 1 (the U-Net head): the JAX package's shifted-slice route
    "cin1_per_sample": (lambda x, g, ps: shift_dot_dw(x, g, 3, batched=ps),
                        (2, 1, 4, 8, 128), 4, 3, True),
}


@pytest.mark.parametrize("case", sorted(S1_DW_CASES))
def test_conv3d_s1_dw_matches_pallas(case):
    fn, xshape, cout, k, per_sample = S1_DW_CASES[case]
    x, g = _data(0, xshape, (xshape[0], cout) + xshape[2:])
    want = fn(jnp.asarray(x), jnp.asarray(g), per_sample)
    ops.reset_counts()
    got = ops.conv3d_s1_dw(_t(x), _t(g), k, per_sample)
    assert ops.PLAIN_ON_CPU["s1_dw"] == 1
    assert _rel(got, want) < TOL


# ------------------------------------------------------- KB2 (strided dW)
def _dw_dil_taps_last(m, per_sample):
    """JAX `_dw_dil` [(B,) 27, Cp, Cf] -> [(B,) Cp, Cf, 3, 3, 3]."""
    m = np.asarray(m)
    m = np.moveaxis(m, -3, -1)
    return m.reshape(m.shape[:-1] + (3, 3, 3))


@pytest.mark.parametrize("role", ["s2", "t2"])
@pytest.mark.parametrize("per_sample", [False, True])
def test_conv3d_strided_dw_matches_pallas(role, per_sample):
    """Both roles of `_dw_dil` (test_packed_level.py:86-150): the stride-2
    conv's dW (full = x, half = g) and the transposed conv's (full = g,
    half = x); the half-resolution operand is packed on the JAX side."""
    b, cin, cout, d = 2, 3, 5, 8
    c_full, c_half = (cin, cout) if role == "s2" else (cout, cin)
    full, half = _data(1, (b, c_full, d, d, d), (b, c_half) + (d // 2,) * 3)
    want = strided._dw_dil(jnp.asarray(full), strided.pack_w(jnp.asarray(half)),
                           batched=per_sample, interpret=True)
    got = ops.conv3d_strided_dw(_t(full), _t(half), per_sample)
    assert _rel(got, _dw_dil_taps_last(want, per_sample)) < TOL
    if role == "t2":  # the transposed conv's dW: channels swapped, taps flipped
        perm = (0, 3, 2, 1) if per_sample else (2, 1, 0)
        shape = ((b,) if per_sample else ()) + (cout, cin, 3, 3, 3)
        want_dw = jnp.flip(jnp.transpose(want, perm).reshape(shape),
                           axis=(-3, -2, -1))
        got_dw = torch.flip(got.transpose(-5, -4), dims=(-3, -2, -1))
        assert _rel(got_dw, want_dw) < TOL


@pytest.mark.parametrize("dw", ["_dw_dil_v1", "_dw_v2"])
def test_conv3d_strided_dw_matches_both_generations(dw):
    full, half = _data(2, (2, 4, 8, 8, 8), (2, 3, 4, 4, 4))
    want = getattr(strided, dw)(jnp.asarray(full),
                                strided.pack_w(jnp.asarray(half)),
                                interpret=True)
    got = ops.conv3d_strided_dw(_t(full), _t(half), False)
    assert _rel(got, _dw_dil_taps_last(want, False)) < TOL


# ---------------------------------------------------- KB3 (norm_act bwd)
@pytest.mark.parametrize("act,film,c", [
    ("none", True, 3), ("relu", True, 3), ("leakyrelu", True, 3),
    ("prelu", True, 3), ("relu", False, 3), ("prelu", False, 3),
    ("none", False, 1), ("prelu", False, 1)])
def test_norm_act_bwd_matches_pallas(act, film, c):
    rng = np.random.default_rng(3)
    b = 2 if c > 1 else 3
    x = (0.5 + rng.normal(size=(b, c, 4, 8, 128))).astype(np.float32)
    g = rng.normal(size=x.shape).astype(np.float32)
    alpha = np.asarray([0.25], np.float32)
    scale = np.ones((b, c), np.float32)
    shift = np.zeros((b, c), np.float32)
    if film:
        scale = (1.0 + 0.3 * rng.normal(size=(b, c))).astype(np.float32)
        shift = (0.3 * rng.normal(size=(b, c))).astype(np.float32)
    _, aux = _norm_act_fwd_impl(jnp.asarray(x), jnp.asarray(alpha),
                                jnp.asarray(scale), jnp.asarray(shift), act,
                                1e-5, True)
    want = _norm_act_bwd_impl(jnp.asarray(x), aux, jnp.asarray(g), act, True)
    got = ops.norm_act_bwd_plain(_t(x), _t(g), _t(alpha), act,
                                 _t(scale) if film else None,
                                 _t(shift) if film else None)
    names = ("dx", "dalpha", "dscale", "dshift")
    for name, a, w in zip(names, got, want):
        if name == "dalpha":
            if act == "prelu":
                assert _rel(a, np.reshape(w, (1,))) < TOL
            else:
                assert float(a.abs().max()) == 0.0
            continue
        assert _rel(a, w) < TOL, name


# ---------------------------------- the Functions against torch autograd
def _grads(fn, inputs, cot):
    leaves = [t.detach().clone().requires_grad_(t.is_floating_point())
              for t in inputs]
    out = fn(*leaves)
    out.backward(cot)
    return out.detach(), [t.grad for t in leaves]


CONV_CASES = {
    # (wrapper, reference forward, x shape, weight shape)
    "s1_k3": (ops.conv3d_s1, lambda x, w, b: conv3d_ref(x, w, b),
              (2, 3, 6, 5, 7), (4, 3, 3, 3, 3)),
    "s1_k3_per_sample": (ops.conv3d_s1, lambda x, w, b: conv3d_ref(x, w, b),
                         (2, 3, 6, 5, 7), (2, 4, 3, 3, 3, 3)),
    "s1_k1": (ops.conv3d_s1, lambda x, w, b: conv3d_ref(x, w, b),
              (2, 3, 4, 5, 6), (4, 3, 1, 1, 1)),
    "s1_k1_per_sample": (ops.conv3d_s1, lambda x, w, b: conv3d_ref(x, w, b),
                         (2, 3, 4, 5, 6), (2, 1, 3, 1, 1, 1)),
    "s2": (ops.conv3d_s2, lambda x, w, b: conv3d_ref(x, w, b, stride=2),
           (2, 3, 8, 6, 4), (5, 3, 3, 3, 3)),
    "s2_per_sample": (ops.conv3d_s2,
                      lambda x, w, b: conv3d_ref(x, w, b, stride=2),
                      (2, 3, 8, 6, 4), (2, 5, 3, 3, 3, 3)),
    "t2": (ops.conv3d_t2, lambda x, w, b: conv_transpose3d_ref(x, w, b),
           (2, 3, 4, 3, 2), (5, 3, 3, 3, 3)),
    "t2_per_sample": (ops.conv3d_t2,
                      lambda x, w, b: conv_transpose3d_ref(x, w, b),
                      (2, 3, 4, 3, 2), (2, 5, 3, 3, 3, 3)),
}


@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_conv_function_grads_match_autograd(case):
    fn, ref, xshape, wshape = CONV_CASES[case]
    x, w = _data(4, xshape, wshape)
    bias = np.linspace(-1.0, 1.0, wshape[-5], dtype=np.float32)
    inputs = [_t(x), _t(w), _t(bias)]
    with torch.no_grad():
        y_ref = ref(*inputs)
    cot = _t(_data(5, tuple(y_ref.shape))[0])
    y_got, got = _grads(fn, inputs, cot)
    _, want = _grads(ref, inputs, cot)
    assert _rel(y_got, y_ref) < TOL
    for name, a, b in zip(("dx", "dw", "dbias"), got, want):
        assert _rel(a, b) < TOL, name


def test_conv_function_skips_unneeded_input_grad():
    """The U-Net head's input (the MRI) needs no dx: the backward then runs
    the dW and dbias reductions but no input-gradient conv."""
    x, w = _data(6, (2, 1, 4, 4, 4), (2, 3, 1, 3, 3, 3))
    wt = _t(w).requires_grad_()
    bias = torch.zeros(3, requires_grad=True)
    ops.reset_counts()
    ops.conv3d_s1(_t(x), wt, bias).square().sum().backward()
    assert dict(ops.PLAIN_ON_CPU) == {"s1": 1, "s1_dw": 1}
    assert wt.grad is not None and bias.grad is not None


@pytest.mark.parametrize("act,film", [("prelu", True), ("relu", True),
                                      ("leakyrelu", False), ("none", True)])
def test_norm_act_function_grads_match_autograd(act, film):
    rng = np.random.default_rng(7)
    b, c = 2, 3
    x = (1.0 + rng.normal(size=(b, c, 4, 5, 6))).astype(np.float32)
    inputs = [_t(x), torch.tensor([0.25])]
    if film:
        inputs += [_t((1.0 + 0.3 * rng.normal(size=(b, c))).astype(np.float32)),
                   _t((0.3 * rng.normal(size=(b, c))).astype(np.float32))]
    cot = _t(rng.normal(size=x.shape).astype(np.float32))

    def port(x_, a_, *film_):
        return ops.norm_act(x_, a_, act, *film_)

    def ref(x_, a_, *film_):
        return ops.norm_act_plain(x_, a_, act, *film_)

    y_got, got = _grads(port, inputs, cot)
    y_ref, want = _grads(ref, inputs, cot)
    assert _rel(y_got, y_ref) < TOL
    for name, a, w in zip(("dx", "dalpha", "dscale", "dshift"), got, want):
        if name == "dalpha" and act != "prelu":
            assert a is None or float(a.abs().max()) == 0.0
            continue
        assert _rel(a, w) < TOL, name
