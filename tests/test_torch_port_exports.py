"""The port's public names: every name that a `coma_unet_tpu` package
`__init__.py` exports is exported by the port's matching `__init__.py`,
apart from the TPU workarounds the port leaves behind by design
(`LEFT_BEHIND`); and each function of the port's last slice (the
analysis, the profiler, the device forms and the host functions) imports
from where its JAX counterpart does. The JAX package is read as text and
never imported here."""

import ast
import importlib
import pathlib

import pytest

JAX_ROOT = pathlib.Path(__file__).resolve().parent.parent / "coma_unet_tpu"

# names of the JAX package the port has no counterpart for, and why
LEFT_BEHIND = {
    # TPU sharding specs and the split (AOT) train step; the port's mesh is
    # a torch.distributed group
    ("parallel", "batch_sharding"),
    ("parallel", "replicate_sharding"),
    ("parallel", "make_sharded_split_train_step"),
    # the port's native reader raises where g++ fails instead of falling
    # back to numpy, so there is nothing to route around
    ("runtime", "native_available"),
}


def _jax_exports():
    pairs = []
    for init in sorted(JAX_ROOT.rglob("__init__.py")):
        sub = init.parent.relative_to(JAX_ROOT).parts
        if sub[:2] == ("ops", "pallas"):  # the TPU kernels: ported as csrc/
            continue
        tree = ast.parse(init.read_text())
        for node in tree.body:
            if isinstance(node, ast.ImportFrom):
                pairs += [(".".join(sub), a.asname or a.name) for a in node.names]
    return pairs


JAX_EXPORTS = _jax_exports()

# the names the last slice added or exported, by the port module that holds them
SLICE_NAMES = [
    ("", "ROI_NAMES"),
    ("analysis", "extract_bottleneck_encodings"),
    ("analysis", "probe_abeta_from_embeddings"),
    ("analysis", "pca"),
    ("analysis", "analyze_region"),
    ("analysis", "analyze_sample"),
    ("analysis", "create_roi_suvr_table"),
    ("utils", "setup_logging"),
    ("utils", "trace"),
    ("utils", "StepTimer"),
    ("utils.profiling", "trace"),
    ("ops", "gaussian_smooth"),
    ("ops", "resize_nearest"),
    ("ops", "resize_linear"),
    ("ops", "resize_nearest_device"),
    ("ops", "center_pad_crop"),
    ("io", "mask_volume"),
    ("io", "reduce_image_size"),
    ("io", "convert_npy_to_nii"),
    ("data", "INVALID_IDS"),
    ("data", "remove_invalid"),
    ("data", "create_splits_lookup_tables"),
    ("train", "param_count"),
    ("train.recorder", "scatter_corr"),
    ("data.covariates", "PredictionTable.merge"),
    ("models", "AttentionGate"),
    ("models", "CondConvolution"),
    ("models", "ConvBlock"),
    ("models", "Convolution"),
    ("models", "ProjectionHead"),
    ("models", "StackedFusionConvLayers"),
    ("models", "UpBlock"),
]


def _lookup(module: str, name: str):
    mod = importlib.import_module(".".join(filter(None, ("coma_unet_tpu_torch", module))))
    obj = mod
    for part in name.split("."):
        obj = getattr(obj, part)
    return obj


@pytest.mark.parametrize("module,name", sorted(set(JAX_EXPORTS) - LEFT_BEHIND
                                               | set(SLICE_NAMES)))
def test_port_exports(module, name):
    assert _lookup(module, name) is not None


def test_left_behind_are_still_jax_names():
    """Each name left behind is one the JAX package exports and the port
    does not."""
    assert len(JAX_EXPORTS) > 60
    for module, name in LEFT_BEHIND:
        assert (module, name) in JAX_EXPORTS
        with pytest.raises(AttributeError):
            _lookup(module, name)
