"""The port's analysis (`coma_unet_tpu_torch/analysis/`: the embedding probe
and the per-ROI statistics) against the JAX package's, on the CPU.

The encodings come from the tiny configuration (16^3, channels (4, 8, 16),
4 experts, f32; the JAX side through its plain XLA reference,
`pallas_convs=False`) with the flax init's parameters carried across by
`convert.from_flax`: within 1e-4 relative L2, abeta exactly; a baseline
raises ValueError. The probe is numpy and scipy in the port and
scikit-learn in the JAX package: `r2` and `rfe_r2` within 1e-6 of
sklearn's on seeded float32 features at N = 8, 12 and 16 with 64 and 512
features kept, with constant (zero-variance) columns, a training split
whose abeta is constant and NaN or negative abeta rows, NaN on both sides
at N = 4; RFE's support equals `sklearn.feature_selection.RFE`'s. The
regional statistics equal the pandas version's, the CSV byte for byte.
"""

import dataclasses
import warnings

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("sklearn")
pytest.importorskip("pandas")

from sklearn.feature_selection import RFE  # noqa: E402
from sklearn.linear_model import LinearRegression  # noqa: E402

from coma_unet_tpu.analysis import embeddings as jax_embeddings  # noqa: E402
from coma_unet_tpu.analysis import regions as jax_regions  # noqa: E402
from coma_unet_tpu.models import ContraAttnUNet as FlaxContra  # noqa: E402

import coma_unet_tpu_torch.config as pconfig  # noqa: E402
from coma_unet_tpu_torch import ContraAttnUNet  # noqa: E402
from coma_unet_tpu_torch.analysis import (  # noqa: E402
    analyze_region,
    analyze_sample,
    create_roi_suvr_table,
    export_attention_maps,
    extract_bottleneck_encodings,
    pca,
    probe_abeta_from_embeddings,
)
from coma_unet_tpu_torch.analysis import embeddings as port_embeddings  # noqa: E402
from coma_unet_tpu_torch.convert import from_flax  # noqa: E402
from coma_unet_tpu_torch.io.volume import write_tensor_to_nii  # noqa: E402
from coma_unet_tpu_torch.models.registry import build_model  # noqa: E402

S, B = 16, 2
ENC_TOL = 1e-4    # rel L2 of the bottleneck features
PROBE_TOL = 1e-6  # |r2 - sklearn's|, |rfe_r2 - sklearn's|
JAX_ONLY = dict(pallas_convs=False, packed_level=False, remat=False)


def _model_pair(config):
    """The flax model with its init and the port's with the same
    parameters (and batch statistics, moved off their init values so
    that running and batch statistics differ)."""
    jcfg = dataclasses.replace(config, **JAX_ONLY)
    example = (np.zeros((B, 1, S, S, S), np.float32), np.zeros((B, 6), np.float32),
               np.zeros((B, 36), np.float32), np.zeros((B, 36), np.float32),
               np.zeros((B, S, S, S), np.int32))
    flax_model = FlaxContra(jcfg)
    init = jax.jit(lambda key, *a: flax_model.init(key, *a, train=True))
    variables = jax.device_get(init(jax.random.PRNGKey(0), *example))
    if "batch_stats" in variables:
        rng = np.random.default_rng(1)
        variables = dict(variables, batch_stats=jax.tree_util.tree_map_with_path(
            lambda path, v: np.asarray(
                v * rng.uniform(0.5, 1.5, v.shape) if path[-1].key == "var"
                else v + rng.normal(0, 0.1, v.shape), np.float32),
            variables["batch_stats"]))
    fields = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    port = ContraAttnUNet(pconfig.ModelConfig(**fields), device="cpu")
    port.load_state_dict(from_flax(variables["params"], port,
                                   variables.get("batch_stats")))
    return flax_model, variables, port


@pytest.fixture(scope="module")
def models(tiny_model_config):
    return _model_pair(tiny_model_config)


def _loader(seed, n_batches=2):
    rng = np.random.default_rng(seed)
    batches = []
    for _ in range(n_batches):
        batches.append({
            "mri": rng.uniform(0, 1, (B, 1, S, S, S)).astype(np.float32),
            "covars": rng.uniform(0, 1, (B, 6)).astype(np.float32),
            "roi_loc": rng.uniform(0, 2, (B, 36)).astype(np.float32),
            "roi_std": rng.uniform(0, 0.2, (B, 36)).astype(np.float32),
            "roi_compact": rng.integers(0, 37, (B, S, S, S)).astype(np.int32),
            "abeta": rng.integers(0, 2, (B,)).astype(np.float32),
        })
    return batches


def test_encodings_match_jax(models):
    flax_model, variables, port = models
    loader = _loader(0)
    want_x, want_ab = jax_embeddings.extract_bottleneck_encodings(
        flax_model, variables, loader)
    # tensors as the port's loader yields them
    got_x, got_ab = extract_bottleneck_encodings(
        port, [{k: torch.from_numpy(v) for k, v in b.items()} for b in loader])
    assert got_x.dtype == np.float32 and got_x.shape == want_x.shape
    assert got_x.shape == (2 * B, 16 * 4 ** 3)  # 16 channels at 4^3
    rel = np.linalg.norm(got_x - want_x) / np.linalg.norm(want_x)
    assert rel <= ENC_TOL, rel
    np.testing.assert_array_equal(got_ab, want_ab)


@pytest.mark.parametrize("overrides", [dict(norm="batch"), dict(dropout=0.2)],
                         ids=["batch_norm", "dropout"])
def test_encodings_match_jax_in_eval_mode(tiny_model_config, overrides):
    """A port model left in training mode gives JAX's `train=False`
    features, its running statistics untouched and its mode restored."""
    flax_model, variables, port = _model_pair(
        dataclasses.replace(tiny_model_config, **overrides))
    loader = _loader(0)
    want_x, _ = jax_embeddings.extract_bottleneck_encodings(
        flax_model, variables, loader)
    port.train()
    before = {k: v.clone() for k, v in port.state_dict().items()}
    got_x, _ = extract_bottleneck_encodings(port, loader)
    rel = np.linalg.norm(got_x - want_x) / np.linalg.norm(want_x)
    assert rel <= ENC_TOL, rel
    assert port.training
    after = port.state_dict()
    assert all(torch.equal(before[k], after[k]) for k in before)


def test_attention_export_runs_in_eval_mode(tiny_model_config, tmp_path):
    """The attention export, like the encodings, runs a model left in
    training mode as `train=False` and leaves its statistics and mode."""
    cfg = dataclasses.replace(tiny_model_config, norm="batch", dropout=0.2)
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    port = ContraAttnUNet(pconfig.ModelConfig(**fields), device="cpu")
    batch = _loader(0, n_batches=1)[0]
    port.eval()
    with torch.inference_mode():
        want = port(*(torch.from_numpy(batch[k]) for k in
                      ("mri", "covars", "roi_loc", "roi_std", "roi_compact")),
                    with_projections=False).attention
    port.train()
    before = {k: v.clone() for k, v in port.state_dict().items()}
    paths = export_attention_maps(port, batch, str(tmp_path))
    assert len(paths) == B * len(want)
    assert port.training
    after = port.state_dict()
    assert all(torch.equal(before[k], after[k]) for k in before)
    # the first sample's level-0 map, as the eval-mode forward gives it
    write_tensor_to_nii(want[0][0].numpy(), str(tmp_path / "want.nii"))
    assert (tmp_path / "want.nii").read_bytes() == open(paths[0], "rb").read()


def test_encodings_refuse_a_baseline():
    model = build_model("UNET", pconfig.ModelConfig(channels=(4, 8, 16)), device="cpu")
    with pytest.raises(ValueError, match="no encoder features"):
        extract_bottleneck_encodings(model, [{"abeta": np.zeros(1)}])


def _features(seed, n, f=1024):
    """Post-ReLU-like float32 features with constant columns."""
    rng = np.random.default_rng(seed)
    x = np.maximum(rng.standard_normal((n, f)), 0.0).astype(np.float32)
    x[:, ::7] = 0.0
    x[:, 3::11] = 2.5
    return x


def _abeta(seed, n):
    return np.random.default_rng(seed + 1).integers(0, 2, n).astype(np.float64)


def _same(got, want):
    assert set(got) == set(want) == {"r2", "rfe_r2"}
    for k in want:
        if np.isnan(want[k]):
            assert np.isnan(got[k]), (k, got, want)
        else:
            assert abs(got[k] - want[k]) <= PROBE_TOL, (k, got, want)


def _sklearn(*args, **kwargs):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return jax_embeddings.probe_abeta_from_embeddings(*args, **kwargs)


@pytest.mark.parametrize("n_features", [64, 512])
@pytest.mark.parametrize("n", [8, 12, 16])
def test_probe_matches_sklearn(n, n_features):
    x, ab = _features(n, n), _abeta(n, n)
    want = _sklearn(x, ab, n_features=n_features, seed=n)
    got = probe_abeta_from_embeddings(x, ab, n_features=n_features, seed=n)
    _same(got, want)
    assert np.isfinite(got["r2"]) and np.isfinite(got["rfe_r2"])


@pytest.mark.parametrize("case", ["constant_train_abeta", "filtered_rows",
                                  "all_features", "n4"])
def test_probe_edge_cases_match_sklearn(case):
    n, n_features = 12, 64
    x, ab = _features(7, n, f=96), _abeta(7, n)
    if case == "constant_train_abeta":
        train, test = port_embeddings.train_test_split(n, 0)
        ab[train] = 1.0
        ab[test] = [0.0, 1.0, 0.0]
    elif case == "filtered_rows":
        ab[[2, 5]] = np.nan
        ab[9] = -1.0
    elif case == "all_features":
        n_features = None
    else:
        x, ab = x[:4], ab[:4]
    want = _sklearn(x, ab, n_features=n_features, seed=0)
    got = probe_abeta_from_embeddings(x, ab, n_features=n_features, seed=0)
    _same(got, want)
    if case == "n4":
        assert np.isnan(got["r2"]) and np.isnan(got["rfe_r2"])
    if case == "constant_train_abeta":
        # PLS stops at its first component: the prediction is the mean
        assert np.isfinite(got["r2"])


@pytest.mark.parametrize("f", [8, 64, 200])
def test_rfe_support_matches_sklearn(f):
    n = 12
    x, ab = _features(f, n, f=f), _abeta(f, n)
    train, _ = port_embeddings.train_test_split(n, 0)
    keep = max(2, f // 4)
    want = RFE(LinearRegression(), n_features_to_select=keep).fit(x[train], ab[train])
    got = port_embeddings.rfe_support(x[train], ab[train], keep)
    np.testing.assert_array_equal(got, want.support_)
    assert got.sum() == keep


def test_pca_matches_jax():
    x = _features(3, 10, f=40)
    for center in (True, False):
        for a, b in zip(pca(x, 3, center=center), jax_embeddings.pca(x, 3, center=center)):
            np.testing.assert_array_equal(a, b)


def _roi_samples(seed, n=3, s=8):
    rng = np.random.default_rng(seed)
    samples = []
    for i in range(n):
        roi = rng.choice([0, 1, 2, 5, 8, 10], size=(1, s, s, s)).astype(np.float32)
        samples.append({"tau": rng.uniform(0.5, 3.0, (1, s, s, s)).astype(np.float32),
                        "roi": roi, "sample_id": f"S{i:03d}/ses-{i}"})
    samples[1].pop("sample_id")
    return samples


def _eq(a, b) -> bool:
    return a == b or (a != a and b != b)


def test_regions_match_pandas(tmp_path):
    (s0, *_), indices = _roi_samples(0), (1, 2, 5, 8, 10, 99)
    vol, roi = s0["tau"][0], s0["roi"][0]
    for idx in indices:
        got, want = analyze_region(vol, roi, idx), jax_regions.analyze_region(vol, roi, idx)
        assert list(got) == list(want)
        assert all(_eq(got[k], want[k]) for k in want), (idx, got, want)
    empty = analyze_region(vol, roi, 99)
    assert empty["voxels"] == 0 and np.isnan(empty["mean"]) and np.isnan(empty["std"])

    got, want = analyze_sample(vol, roi, indices), jax_regions.analyze_sample(vol, roi, indices)
    assert got.columns == list(want.columns)
    for c in got.columns:
        assert all(_eq(a, b) for a, b in zip(got[c], want[c].tolist())), c

    samples = _roi_samples(1)
    got = create_roi_suvr_table(samples, indices, out_csv=str(tmp_path / "port.csv"))
    want = jax_regions.create_roi_suvr_table(samples, indices, out_csv=str(tmp_path / "jax.csv"))
    assert got["sample_id"] == list(want.index)
    assert got.columns[1:] == list(want.columns)
    for c in want.columns:
        np.testing.assert_array_equal(np.asarray(got[c]), want[c].to_numpy())
    assert (tmp_path / "port.csv").read_bytes() == (tmp_path / "jax.csv").read_bytes()
    # the default ROI set and volume key, no CSV
    got = create_roi_suvr_table(samples)
    want = jax_regions.create_roi_suvr_table(samples)
    assert got.columns[1:] == list(want.columns)
