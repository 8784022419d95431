"""The last host-side and device-form functions of the port against the JAX
package's, on the CPU: `ops.gaussian_smooth` (within 1e-6 of max|JAX|, for
[D, H, W] and [B, C, D, H, W] with C = 3, sigma 1.0 and 2 / 2.355) and
`ops.resize_nearest_device` (exactly), the lookup CSVs of
`create_splits_lookup_tables` and `convert_npy_to_nii`'s NIfTI (byte for
byte), `remove_invalid`, `mask_volume`, `reduce_image_size`,
`QuartileTable.abeta` and `PredictionTable.merge` (exactly),
`param_count` (the JAX count of `variables["params"]` for the tiny
flagship and for UNET with batch norm, from `jax.eval_shape` of the
init), `scatter_corr`,
and the profiler: `trace` writes a trace file, `StepTimer.p50` is finite,
or NaN before any measurement.
"""

import dataclasses
import json
import math
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pd = pytest.importorskip("pandas")

import jax.numpy as jnp  # noqa: E402

from coma_unet_tpu.data import covariates as jcov  # noqa: E402
from coma_unet_tpu.data import lookup as jlookup  # noqa: E402
from coma_unet_tpu.io import volume as jvolume  # noqa: E402
from coma_unet_tpu.models import registry as jregistry  # noqa: E402
from coma_unet_tpu.ops import resize as jresize  # noqa: E402
from coma_unet_tpu.ops import smooth as jsmooth  # noqa: E402
from coma_unet_tpu.train import recorder as jrecorder  # noqa: E402
from coma_unet_tpu.train.state import param_count as jax_param_count  # noqa: E402

import coma_unet_tpu_torch.config as pconfig  # noqa: E402
from coma_unet_tpu_torch import ops  # noqa: E402
from coma_unet_tpu_torch.data import covariates as pcov  # noqa: E402
from coma_unet_tpu_torch.data import (  # noqa: E402
    INVALID_IDS,
    create_splits_lookup_tables,
    remove_invalid,
)
from coma_unet_tpu_torch.data.table import read_csv  # noqa: E402
from coma_unet_tpu_torch.io import (  # noqa: E402
    convert_npy_to_nii,
    mask_volume,
    reduce_image_size,
)
from coma_unet_tpu_torch.models.registry import build_model  # noqa: E402
from coma_unet_tpu_torch.train import param_count, recorder  # noqa: E402
from coma_unet_tpu_torch.utils.profiling import StepTimer, trace  # noqa: E402

SMOOTH_TOL = 1e-6  # of max|JAX|
JAX_ONLY = dict(pallas_convs=False, packed_level=False, remat=False)


@pytest.mark.parametrize("sigma", [1.0, 2.0 / 2.355])
@pytest.mark.parametrize("shape", [(9, 12, 10), (2, 3, 9, 12, 10)])
def test_gaussian_smooth_matches_jax(shape, sigma):
    x = np.random.default_rng(len(shape)).uniform(-1, 2, shape).astype(np.float32)
    want = np.asarray(jsmooth.gaussian_smooth(jnp.asarray(x), sigma=sigma))
    got = ops.gaussian_smooth(torch.from_numpy(x), sigma=sigma)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    err = np.abs(got.numpy() - want).max() / np.abs(want).max()
    assert err <= SMOOTH_TOL, err


@pytest.mark.parametrize("ratios,out_shape", [
    ((1.0, 1.0, 1.0), (9, 12, 10)),
    ((1.5, 0.8, 1.2), (6, 15, 8)),
    ((0.5, 2.0, 0.75), (18, 6, 14)),
    ((1.0 / 3.0, 0.6, 1.7), (30, 20, 7)),
])
def test_resize_nearest_device_matches_jax(ratios, out_shape):
    vol = np.random.default_rng(0).standard_normal((9, 12, 10)).astype(np.float32)
    r = np.asarray(ratios, np.float32)
    want = np.asarray(jresize.resize_nearest_device(jnp.asarray(vol), jnp.asarray(r), out_shape))
    got = ops.resize_nearest_device(torch.from_numpy(vol), torch.from_numpy(r), out_shape)
    np.testing.assert_array_equal(got.numpy(), want)
    # the host resample's indices where no sample falls outside the volume
    if ratios == (1.5, 0.8, 1.2):
        host = ops.resize_nearest(vol, (1.0, 1.0, 1.0), ratios)
        np.testing.assert_array_equal(got.numpy()[:host.shape[0], :host.shape[1],
                                                  :host.shape[2]], host)


def _lookup_rows(n=7, extra_keys=False):
    """Lookup rows; with `extra_keys` two later rows carry keys the first
    has not (an int and a string), which pandas fills with NaN."""
    rows = []
    for i in range(n):
        sid = f"{i:03d}_S_{i:04d}"
        rows.append({"MRI": f"/data/adni/{sid}/ses-{i}/anat/mri.nii",
                     "tau": f"/data/adni/{sid}/ses-{i}/pet/tau.nii",
                     "roi": f"/data/adni/{sid}/ses-{i}/roi.nii",
                     "age": 60.5 + i if i != 3 else float("nan"),
                     "visits": i, "site": "A" if i % 2 else None})
    if extra_keys:
        rows[2]["scanner"] = 3
        rows[5]["note"] = "rescan"
        rows[6]["scanner"] = 1
    return rows


def test_create_splits_lookup_tables_matches_jax(tmp_path):
    _check_splits_against_jax(_lookup_rows(), tmp_path)


def test_create_splits_lookup_tables_with_extra_keys_matches_jax(tmp_path):
    _check_splits_against_jax(_lookup_rows(extra_keys=True), tmp_path)


def _check_splits_against_jax(rows, tmp_path):
    folds = [[f"{i:03d}_S_{i:04d}/ses-{i}" for i in (0, 3)],
             [f"{i:03d}_S_{i:04d}/ses-{i}" for i in (1, 5, 6)], []]
    jlookup.create_splits_lookup_tables(pd.DataFrame(rows), folds, str(tmp_path / "jax"))
    create_splits_lookup_tables(rows, folds, str(tmp_path / "rows"))
    # a Table read back from a CSV that pandas wrote
    pd.DataFrame(rows).to_csv(tmp_path / "all.csv", index=False)
    create_splits_lookup_tables(read_csv(str(tmp_path / "all.csv")), folds,
                                str(tmp_path / "table"))
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(f"{s}_lookup_{k}.csv" for k in (1, 2, 3)
                           for s in ("test", "training"))
    for port in ("rows", "table"):
        assert sorted(os.listdir(tmp_path / port)) == names
        for name in names:
            assert ((tmp_path / port / name).read_bytes()
                    == (tmp_path / "jax" / name).read_bytes()), (port, name)


def test_remove_invalid_matches_jax():
    ids = ["a", "b", "c", "b"]
    assert INVALID_IDS == jlookup.INVALID_IDS
    assert remove_invalid(ids) == jlookup.remove_invalid(ids) == ids
    assert remove_invalid(ids, ["b"]) == jlookup.remove_invalid(ids, ["b"]) == ["a", "c"]


@pytest.mark.parametrize("shape", [(9, 12, 10), (1, 9, 12, 10)])
def test_convert_npy_to_nii_matches_jax(tmp_path, shape):
    arr = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    np.save(tmp_path / "v.npy", arr)
    jvolume.convert_npy_to_nii(str(tmp_path / "v.npy"), str(tmp_path / "jax.nii"))
    convert_npy_to_nii(str(tmp_path / "v.npy"), str(tmp_path / "port.nii"),
                       spacing=(2.0, 2.0, 2.0))
    assert (tmp_path / "port.nii").read_bytes() == (tmp_path / "jax.nii").read_bytes()


def test_mask_and_reduce_volume_match_jax():
    rng = np.random.default_rng(2)
    vol = rng.uniform(0.1, 1.0, (2, 9, 12, 10)).astype(np.float32)
    mask = (rng.uniform(size=(9, 12, 10)) > 0.4).astype(np.float32)
    got, want = mask_volume(vol[0], mask), jvolume.mask_volume(vol[0], mask)
    np.testing.assert_array_equal(got, want)
    assert got is not vol[0] and (got[mask == 0] == 0).all()
    sparse = np.zeros_like(vol)
    sparse[0, 2:5, 3, 4:9] = 1.0
    sparse[1, 6, 1:8, 5] = 2.0
    for v in (sparse, sparse[0], np.zeros((4, 5, 6), np.float32)):
        got, want = reduce_image_size(v), jvolume.reduce_image_size(v)
        assert got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    assert reduce_image_size(sparse).shape == (2, 5, 7, 5)


def test_quartile_abeta_and_prediction_merge_match_jax(tmp_path):
    path = str(tmp_path / "q.csv")
    with open(path, "w") as f:
        f.write("ADNI_ID,quartile_lub,Abeta_Covar\n7,1,0.5\n8,,1\n9,3.0,\n")
    got, want = pcov.QuartileTable(path), jcov.QuartileTable(path)
    assert got.abeta == want.abeta == {"7.0": 0.5, "8.0": 1.0}
    with open(path, "w") as f:
        f.write("ADNI_ID,quartile_lub\nS1,1\nS2,4\n")
    got, want = pcov.QuartileTable(path), jcov.QuartileTable(path)
    assert got.abeta == want.abeta == {}

    a = {"S1": {"Tau_Meta": {"loc": 1.0, "std": 0.1}}, "S2": {"Tau_Meta": {"loc": 2.0}}}
    b = {"S2": {"Tau_Meta": {"loc": 9.0}}, "S3": {"Tau_Meta": {"loc": 3.0}}}
    got = pcov.PredictionTable(a).merge(pcov.PredictionTable(b))
    want = jcov.PredictionTable(a).merge(jcov.PredictionTable(b))
    assert isinstance(got, pcov.PredictionTable)
    assert got.table == want.table
    assert list(got.table) == list(want.table) == ["S2", "S3", "S1"]
    assert got.meta_tau("S2") == 2.0


def _jax_param_count(model, *inputs, **kwargs):
    shapes = jax.eval_shape(lambda k: model.init(k, *inputs, **kwargs),
                            jax.random.PRNGKey(0))
    return jax_param_count(shapes["params"])


@pytest.mark.parametrize("model_type", ["ContraAttnUNET", "UNET"])
def test_param_count_matches_jax(tiny_model_config, model_type):
    # UNET with batch norm: its running statistics are buffers, not counted
    norm = "batch" if model_type == "UNET" else "instance"
    jcfg = dataclasses.replace(tiny_model_config, norm=norm, **JAX_ONLY)
    fields = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    port = build_model(model_type, pconfig.ModelConfig(**fields), device="cpu")
    s = 16
    x = jnp.zeros((2, 1, s, s, s), jnp.float32)
    if model_type == "UNET":
        want = _jax_param_count(jregistry.build_model(model_type, jcfg), x, train=False)
        assert sum(b.numel() for b in port.buffers()) > 0
    else:
        want = _jax_param_count(
            jregistry.build_model(model_type, jcfg), x, jnp.zeros((2, 6)),
            jnp.zeros((2, 36)), jnp.zeros((2, 36)), jnp.zeros((2, s, s, s), jnp.int32),
            train=True)
    assert param_count(port) == want > 0


def test_scatter_corr_draws_or_skips(tmp_path):
    x = np.linspace(0.0, 1.0, 20)
    y = x + np.random.default_rng(3).normal(0.0, 0.1, 20)
    recorder.scatter_corr(x, y, str(tmp_path / "port"))
    if recorder._plt() is None:
        assert not (tmp_path / "port.png").exists()
    else:
        jrecorder.scatter_corr(x, y, str(tmp_path / "jax"))
        assert (tmp_path / "port.png").stat().st_size > 0
        assert (tmp_path / "jax.png").exists()


def test_trace_and_step_timer(tmp_path):
    with trace(None):
        pass
    with trace(""):
        pass
    log_dir = tmp_path / "trace"
    with trace(str(log_dir)):
        y = torch.nn.functional.conv3d(torch.ones(1, 1, 6, 6, 6), torch.ones(2, 1, 3, 3, 3))
    (name,) = os.listdir(log_dir)
    assert name.startswith(f"trace.{os.getpid()}.") and name.endswith(".json")
    events = json.loads((log_dir / name).read_text())["traceEvents"]
    assert any("conv" in str(e.get("name", "")) for e in events)

    timer = StepTimer()
    assert math.isnan(timer.p50())
    for fetch in (None, y, y.numpy(), 3.5):
        with timer.measure(fetch):
            y = y + 1.0
    assert len(timer.times) == 4 and all(t >= 0.0 for t in timer.times)
    assert math.isfinite(timer.p50()) and timer.p50() == float(np.median(timer.times))


def test_trace_is_written_when_the_block_raises(tmp_path):
    with pytest.raises(RuntimeError, match="step failed"):
        with trace(str(tmp_path)):
            torch.nn.functional.conv3d(torch.ones(1, 1, 6, 6, 6), torch.ones(2, 1, 3, 3, 3))
            raise RuntimeError("step failed")
    (name,) = os.listdir(tmp_path)
    events = json.loads((tmp_path / name).read_text())["traceEvents"]
    assert any("conv" in str(e.get("name", "")) for e in events)
