"""The PyTorch port's flagship forward (`coma_unet_tpu_torch`) against the
flax ContraAttnUNet, which runs through its plain XLA reference
(`pallas_convs=False`), on the CPU at f32.

Both sides take the same parameters: the flax init with seeded numpy noise
added to every leaf (flax zero-initializes the FiLM heads, so without the
noise FiLM would be the identity and go unchecked), bridged to the port by
`from_flax`. Tolerance: rtol = atol = 1e-4, as the existing end-to-end
parity test uses. Also pinned here: the bridge is strict, the forward
reaches all four forward kernel families' wrappers, inference and sliding-window
blending match the JAX package's, and the port never imports JAX.
"""

import ast
import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from coma_unet_tpu.config import ModelConfig  # noqa: E402
from coma_unet_tpu.infer import sliding_window as jax_sw  # noqa: E402
from coma_unet_tpu.models import ContraAttnUNet as FlaxContra  # noqa: E402
import coma_unet_tpu_torch  # noqa: E402
from coma_unet_tpu_torch import AttentionUNet, ContraAttnUNet, ops  # noqa: E402
from coma_unet_tpu_torch import MODEL_TYPES, build_model  # noqa: E402
from coma_unet_tpu_torch.convert import from_flax  # noqa: E402
from coma_unet_tpu_torch.infer import (  # noqa: E402
    make_infer_fn,
    sliding_window_inference,
)

B, S, R = 2, 16, 5
TOL = dict(rtol=1e-4, atol=1e-4)
CFG = ModelConfig(
    channels=(4, 8, 16),
    strides=(2, 2, 2),
    latent_spaces=(32,) * 3,
    prompt_shape=(S, S, S),
    num_experts=4,
    compute_dtype="float32",
    pallas_convs=False,
    packed_level=False,
    remat=False,
)
ARGS = ("mri", "covars", "roi_loc", "roi_std", "roi_compact")
ROOT = Path(__file__).resolve().parents[1]


def _batch(rng, b=B, s=S):
    mri = rng.uniform(0.0, 1.0, size=(b, 1, s, s, s)).astype(np.float32)
    mri[mri < 0.2] = 0.0  # exercise the modulator's brain mask
    covars = rng.normal(size=(b, CFG.num_covars)).astype(np.float32)
    covars[:, 0] = [1.0, 0.0][:b]  # one abeta+ and one abeta- (prompt select)
    return {
        "mri": mri,
        "covars": covars,
        "roi_loc": rng.uniform(0.5, 2.0, size=(b, R)).astype(np.float32),
        "roi_std": rng.uniform(0.0, 0.5, size=(b, R)).astype(np.float32),
        "roi_compact": rng.integers(0, R + 1, size=(b, s, s, s)).astype(np.int32),
    }


def _flax_apply(model, params, batch, with_projections):
    return jax.jit(lambda p: model.apply(
        {"params": p}, *(jnp.asarray(batch[k]) for k in ARGS), train=False,
        with_projections=with_projections))(params)


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    batch = _batch(rng)
    flax_model = FlaxContra(CFG)
    variables = jax.jit(lambda key: flax_model.init(
        key, *(jnp.asarray(batch[k]) for k in ARGS), train=False))(
        jax.random.PRNGKey(0))
    params = jax.tree.map(
        lambda a: (np.asarray(a) + 0.05 * rng.normal(size=a.shape)).astype(
            np.float32), variables["params"])
    outs = {wp: _flax_apply(flax_model, params, batch, wp)
            for wp in (True, False)}
    port = ContraAttnUNet(CFG, device="cpu").eval()
    port.load_state_dict(from_flax(params, port))
    return flax_model, params, batch, outs, port


def _port_forward(port, batch, with_projections=True):
    with torch.inference_mode():
        return port(*(torch.from_numpy(batch[k]) for k in ARGS),
                    with_projections=with_projections)


@pytest.mark.parametrize("with_projections", [True, False])
def test_forward_matches_flax(setup, with_projections):
    _, _, batch, outs, port = setup
    want = outs[with_projections]
    got = _port_forward(port, batch, with_projections)
    np.testing.assert_allclose(got.out.numpy(), np.asarray(want.out), **TOL)
    assert len(got.projections) == len(want.projections)
    for i, (a, b) in enumerate(zip(got.projections, want.projections)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL,
                                   err_msg=f"projection {i}")
    np.testing.assert_allclose(got.final_projection.numpy(),
                               np.asarray(want.final_projection), **TOL)
    for name in ("encoder", "attention"):
        for i, (a, b) in enumerate(zip(getattr(got, name), getattr(want, name))):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL,
                                       err_msg=f"{name} {i}")


def test_forward_reaches_every_kernel_wrapper(setup):
    *_, batch, _, port = setup
    ops.reset_counts()
    _port_forward(port, batch, with_projections=False)
    assert all(ops.PLAIN_ON_CPU[f] > 0 for f in ops.FWD_FAMILIES), dict(ops.PLAIN_ON_CPU)
    assert not any(ops.PLAIN_ON_CPU[f] for f in ops.BWD_FAMILIES)
    assert not ops.LAUNCHES and not ops.PLAIN_ON_CUDA


def test_from_flax_is_strict(setup):
    _, params, *_, port = setup
    missing = {k: v for k, v in params.items() if k != "final_proj"}
    with pytest.raises(ValueError, match="final_proj"):
        from_flax(missing, port)
    extra = dict(params, stray={"kernel": np.zeros((2, 2), np.float32)})
    with pytest.raises(ValueError, match="stray"):
        from_flax(extra, port)
    wrong = dict(params, pos_dynamic_prompt=np.zeros((1, 1, 8, 8, 8), np.float32))
    with pytest.raises(ValueError, match="pos_dynamic_prompt"):
        from_flax(wrong, port)


def test_infer_and_sliding_window_match_jax(setup):
    """`make_infer_fn` + Gaussian-blended sliding window over a 20^3 volume
    (8 patches of 16^3, batch 4, the last batch padded) on both sides."""
    flax_model, params, _, _, port = setup
    vol = _batch(np.random.default_rng(1), b=1, s=20)
    kw = dict(patch_size=(S, S, S), overlap=0.25, batch_size=4)
    want = jax_sw.sliding_window_inference(
        jax_sw.make_infer_fn(flax_model), {"params": params},
        *(vol[k] for k in ARGS), **kw)
    got = sliding_window_inference(make_infer_fn(port),
                                   *(vol[k] for k in ARGS), **kw)
    assert got.shape == (1, 1, 20, 20, 20)
    np.testing.assert_allclose(got, want, **TOL)


def test_port_runs_without_jax():
    """A fresh interpreter imports the port and runs a tiny forward of the
    flagship and of three baselines; JAX must never be imported."""
    code = (
        "import sys, torch\n"
        "from coma_unet_tpu_torch import ContraAttnUNet, ModelConfig\n"
        "cfg = ModelConfig(channels=(2, 4, 8), latent_spaces=(8,) * 3,\n"
        "                  prompt_shape=(8, 8, 8), num_experts=2,\n"
        "                  compute_dtype='float32')\n"
        "m = ContraAttnUNet(cfg, device='cpu',\n"
        "                   generator=torch.Generator().manual_seed(0))\n"
        "with torch.inference_mode():\n"
        "    out = m(torch.rand(2, 1, 8, 8, 8), torch.rand(2, 6)).out\n"
        "assert out.shape == (2, 1, 8, 8, 8) and bool(torch.isfinite(out).all())\n"
        "import dataclasses\n"
        "from coma_unet_tpu_torch.models.registry import build_model\n"
        "cfg16 = dataclasses.replace(cfg, prompt_shape=(16, 16, 16))\n"
        "for name in ('UNET', 'GenUNETR', 'AttnSwinUnetr'):\n"
        "    b = build_model(name, cfg16, device='cpu')\n"
        "    with torch.inference_mode():\n"
        "        y = b(torch.rand(1, 1, 16, 16, 16))\n"
        "    assert y.shape == (1, 1, 16, 16, 16), name\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'coma_unet_tpu')]\n"
        "assert not bad, bad\n"
        "from pathlib import Path\n"
        f"ref = Path({str(ROOT / 'coma_unet_tpu')!r})\n"
        "files = [Path(getattr(m, '__file__', None) or '/').resolve()\n"
        "         for m in list(sys.modules.values())]\n"
        "loaded = [str(f) for f in files if f.is_relative_to(ref)]\n"
        "assert not loaded, loaded\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT)] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr


# a string that is a path into the JAX package ("coma_unet_tpu",
# "coma_unet_tpu/config.py", "../coma_unet_tpu/ops"), not prose naming one
_REF_PATH = re.compile(r"^(\.{1,2}/)*coma_unet_tpu(/[\w./-]*)?$")
_LOADERS = {"spec_from_file_location", "SourceFileLoader", "load_source",
            "run_path"}


def _docstrings(tree):
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)) and node.body:
            first = node.body[0]
            if isinstance(first, ast.Expr) and isinstance(first.value, ast.Constant):
                yield first.value


# the one function that may import matplotlib: the recorder's chart helper
_CHART_FUNCTION = "_plt"


def _imports_outside_charts(tree):
    """(node, names) for every import in `tree`, except those inside a
    function named `_CHART_FUNCTION`, whose matplotlib imports are allowed."""
    allowed = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.FunctionDef) and node.name == _CHART_FUNCTION:
            allowed |= {id(n) for n in ast.walk(node)}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        if id(node) in allowed:
            names = [n for n in names if n.split(".")[0] != "matplotlib"]
        yield node, names


def test_port_source_imports_no_jax():
    """AST scan: no import of jax, flax, optax, orbax, pandas, sklearn or
    matplotlib (matplotlib only inside the recorder's chart function), nothing of the
    JAX package, no loader that runs a file by path, and no string that
    names a path into the JAX package."""
    banned = {"jax", "jaxlib", "flax", "optax", "orbax", "coma_unet_tpu",
              "pandas", "sklearn", "matplotlib"}
    pkg = Path(coma_unet_tpu_torch.__file__).parent
    files = sorted(pkg.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    # the native runtime, the analysis modules and data parallelism are
    # scanned too, and the registry and its baselines
    assert {"runtime", "analysis", "parallel"} <= {p.parent.name for p in files}
    assert {"baselines.py", "swin.py", "registry.py", "convattn.py", "uq.py"} <= {
        p.name for p in files if p.parent.name == "models"}
    # the side models' losses and dataset, the probe, the regional
    # statistics and the profiler
    assert {"losses/weighted.py", "losses/templates.py", "data/image_dataset.py",
            "analysis/embeddings.py", "analysis/regions.py",
            "utils/profiling.py"} <= {f"{p.parent.name}/{p.name}" for p in files}
    for path in files:
        tree = ast.parse(path.read_text())
        docs = {id(node) for node in _docstrings(tree)}
        for node in ast.walk(tree):
            if isinstance(node, (ast.Attribute, ast.Name)):
                name = node.attr if isinstance(node, ast.Attribute) else node.id
                assert name not in _LOADERS, f"{path}:{node.lineno}: {name}"
            elif (isinstance(node, ast.Constant) and isinstance(node.value, str)
                  and id(node) not in docs):
                assert not _REF_PATH.match(node.value.strip()), (
                    f"{path}:{node.lineno}: {node.value!r}")
        for node, names in _imports_outside_charts(tree):
            for name in names:
                assert name.split(".")[0] not in banned, f"{path}: {name}"


def test_purity_scan_confines_matplotlib():
    """matplotlib passes the scan inside the chart function only."""
    inside = ast.parse("def _plt():\n    import matplotlib.pyplot as plt\n")
    outside = ast.parse("import matplotlib\ndef chart():\n    import matplotlib\n")
    assert [n for _, n in _imports_outside_charts(inside)] == [[]]
    assert [n for _, n in _imports_outside_charts(outside)] == [["matplotlib"]] * 2


def test_purity_scan_catches_a_load_by_path():
    """The scan above fails on the by-path loader the port once had."""
    src = ('import importlib.util\n'
           'from pathlib import Path\n'
           'p = Path(__file__).parents[1] / "coma_unet_tpu" / "config.py"\n'
           'spec = importlib.util.spec_from_file_location("c", p)\n')
    tree = ast.parse(src)
    names = {n.attr for n in ast.walk(tree) if isinstance(n, ast.Attribute)}
    strings = [n.value for n in ast.walk(tree)
               if isinstance(n, ast.Constant) and isinstance(n.value, str)]
    assert names & _LOADERS
    assert any(_REF_PATH.match(v) for v in strings)
    assert not _REF_PATH.match("coma_unet_tpu_torch/csrc/conv3d_s1.cu")
    assert not _REF_PATH.match("coma_unet_tpu/ops/pallas/conv3d.py:260 _fwd")


def test_models_build_on_the_gpu_by_default(monkeypatch):
    """Without `device` a model builds on the GPU; where there is none it
    raises and names the way to the CPU, instead of running the plain
    versions there."""
    cfg = ModelConfig(channels=(2, 4), strides=(2, 2), latent_spaces=(8,) * 2,
                      prompt_shape=(8, 8, 8), num_experts=2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cls in (ContraAttnUNet, AttentionUNet):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            cls(cfg)
    for name in MODEL_TYPES:  # every type of the registry
        with pytest.raises(RuntimeError, match='device="cpu"'):
            build_model(name, cfg)
    model = ContraAttnUNet(cfg, device="cpu")
    assert {p.device.type for p in model.parameters()} == {"cpu"}
    model = build_model("AttnSwinUnetr", dataclasses.replace(
        cfg, prompt_shape=(16, 16, 16)), device="cpu")
    assert {p.device.type for p in model.parameters()} == {"cpu"}
