"""The port's host side (`coma_unet_tpu_torch/io`, `data`, the CSV tables,
`ops/{preprocess,resize,smooth}.py`) against the JAX package's, on one
synthetic cohort (8 subjects at 16^3) and on hand-made CSVs and volumes.

Everything here is exact: the same files, the same arrays bit for bit, the
same table values, the same batches from the loader over two shuffled
epochs with wrap-padding. The JAX package reads and writes its CSVs with
pandas; the port with the `csv` module.
"""

import filecmp
import os

import numpy as np
import pandas as pd
import pytest

pytest.importorskip("jax")

from coma_unet_tpu import data as jdata  # noqa: E402
from coma_unet_tpu.config import ROI_INDICES  # noqa: E402
from coma_unet_tpu.data import covariates as jcov  # noqa: E402
from coma_unet_tpu.data import lookup as jlookup  # noqa: E402
from coma_unet_tpu.data.synthetic import make_synthetic_cohort as jmake  # noqa: E402
from coma_unet_tpu.io import nifti as jnifti  # noqa: E402
from coma_unet_tpu.io import volume as jvolume  # noqa: E402
from coma_unet_tpu.ops.preprocess import center_pad_crop as jpad  # noqa: E402
from coma_unet_tpu.ops.smooth import gaussian_kernel1d as jkernel  # noqa: E402
from coma_unet_tpu.train.recorder import MetricRecorder as JRecorder  # noqa: E402
from coma_unet_tpu_torch import data as pdata  # noqa: E402
from coma_unet_tpu_torch.data import covariates as pcov  # noqa: E402
from coma_unet_tpu_torch.data import lookup as plookup  # noqa: E402
from coma_unet_tpu_torch.data.synthetic import make_synthetic_cohort as pmake  # noqa: E402
from coma_unet_tpu_torch.data.table import read_csv  # noqa: E402
from coma_unet_tpu_torch.io import nifti as pnifti  # noqa: E402
from coma_unet_tpu_torch.io import volume as pvolume  # noqa: E402
from coma_unet_tpu_torch.ops.preprocess import center_pad_crop as ppad  # noqa: E402
from coma_unet_tpu_torch.ops.smooth import gaussian_kernel1d as pkernel  # noqa: E402
from coma_unet_tpu_torch.train.recorder import MetricRecorder as PRecorder  # noqa: E402

S = 16


@pytest.fixture(scope="module")
def cohorts(tmp_path_factory):
    """The same cohort written by each package."""
    root = tmp_path_factory.mktemp("cohorts")
    return (jmake(str(root / "jax")), pmake(str(root / "port")))


@pytest.fixture(scope="module")
def cohort(cohorts):
    return cohorts[1]


def _same(a, b):
    assert type(a) is type(b) or (np.isscalar(a) and np.isscalar(b)), (a, b)
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b or (a != a and b != b), (a, b)


# ------------------------------------------------------------ NIfTI, volumes
@pytest.mark.parametrize("dtype,gz", [(np.float32, False), (np.int16, True),
                                      (np.uint8, False), (np.float64, True)])
def test_nifti_round_trip_matches_jax(tmp_path, dtype, gz):
    rng = np.random.default_rng(0)
    data = (rng.normal(size=(7, 9, 11)) * 50).astype(dtype)
    ext = ".nii.gz" if gz else ".nii"
    pj, pp = str(tmp_path / f"j{ext}"), str(tmp_path / f"p{ext}")
    jnifti.write_nifti(pj, data, spacing=(1.5, 2.0, 2.5))
    pnifti.write_nifti(pp, data, spacing=(1.5, 2.0, 2.5))
    if gz:  # gzip stamps the file name and time: compare the payloads
        import gzip
        assert gzip.open(pj).read() == gzip.open(pp).read()
    else:
        assert filecmp.cmp(pj, pp, shallow=False)
    for path in (pj, pp):
        a, b = jnifti.read_nifti(path), pnifti.read_nifti(path)
        _same(a.data, b.data)
        _same(a.data_zyx, b.data_zyx)
        _same(a.affine, b.affine)
        assert a.spacing == b.spacing and a.header == b.header
        np.testing.assert_array_equal(b.data, data)


@pytest.mark.parametrize("interpolation", ["nearest", "linear"])
def test_load_nifti_vol_at_1_5mm_matches_jax(tmp_path, interpolation):
    data = np.random.default_rng(1).uniform(size=(21, 17, 13)).astype(np.float32)
    data[3, 4, 5] = np.nan
    path = str(tmp_path / "v.nii")
    jnifti.write_nifti(path, data, spacing=(1.5, 1.5, 1.5))
    want = jvolume.load_nifti_vol(path, interpolation=interpolation)
    got = pvolume.load_nifti_vol(path, interpolation=interpolation)
    assert got.shape == (1, 10, 13, 16)
    _same(got, want)
    tpl = (20, 12, 16)
    _same(pvolume.load_template(path, tpl), jvolume.load_template(path, tpl))
    _same(pvolume.pad_volume(tpl)(got), jvolume.pad_volume(tpl)(want))


def test_host_ops_match_jax():
    vol = np.random.default_rng(2).normal(size=(1, 9, 14, 5)).astype(np.float32)
    for target in ((12, 10, 8), 7, (9, 14, 5)):
        _same(ppad(vol, target), jpad(vol, target))
    for sigma in (1.0, 2.0 / 2.3548, 0.4):
        for approx in ("erf", "sampled"):
            _same(pkernel(sigma, approx=approx), jkernel(sigma, approx=approx))


def test_write_tensor_to_nii_matches_jax(tmp_path):
    import torch

    vol = np.random.default_rng(3).uniform(size=(1, 1, 6, 7, 8)).astype(np.float32)
    for i, arr in enumerate((vol, vol[0], vol[0, 0])):
        pj, pp = str(tmp_path / f"j{i}.nii"), str(tmp_path / f"p{i}.nii")
        jvolume.write_tensor_to_nii(arr, pj)
        pvolume.write_tensor_to_nii(torch.from_numpy(arr), pp)
        assert filecmp.cmp(pj, pp, shallow=False)


def test_synthetic_cohort_matches_jax(cohorts):
    jc, pc = cohorts
    for key in ("cov", "quart", "preds"):
        assert open(jc[key]).read() == open(pc[key]).read(), key
    jrows = pd.read_csv(jc["lookup"])
    prows = pd.read_csv(pc["lookup"])
    assert list(jrows.columns) == list(prows.columns) == ["MRI", "tau", "roi"]
    for col in jrows.columns:
        for a, b in zip(jrows[col], prows[col]):
            assert os.path.relpath(a, jc["root"]) == os.path.relpath(b, pc["root"])
            assert filecmp.cmp(a, b, shallow=False)


# ------------------------------------------------------------ tables
HAND_CSV = """Unnamed: 0,ADNI_ID,Abeta_Covar,Age,Sex,Education,Cognition,MMSCORE_x
0,101,1,70,M,16,,a
1,101,0,,F,12,28,b
2,102,,80.5,f,,25,
3,103,1,NA,x,14,29,c
4,104,0,61,m,18,30,d
"""

HAND_CSVS = {
    "hand": HAND_CSV,
    # ids with a gap: read as floats, written "101.0"
    "float_ids": HAND_CSV.replace("2,102,", "2,,"),
    # aliased columns, numeric sex, no Cognition at all
    "aliased": ("BID,ABETA,Age,PTGENDER,Education\n"
                "B1,1,70,0,16\nB2,,75,1,\nB3,0,,1,12\n"),
    # a column that is all empty and a numeric Sex
    "empty_col": ("ADNI_ID,Abeta_Covar,Age,Sex,Education,Cognition\n"
                  "s1,1,,0,16,20\ns2,0,,1,12,30\n"),
}


@pytest.mark.parametrize("name", sorted(HAND_CSVS))
@pytest.mark.parametrize("edu30", [False, True])
def test_covariate_table_matches_jax(tmp_path, name, edu30):
    path = str(tmp_path / f"{name}.csv")
    with open(path, "w") as f:
        f.write(HAND_CSVS[name])
    want = jcov.CovariateTable(path, scale_education_by_30=edu30)
    got = pcov.CovariateTable(path, scale_education_by_30=edu30)
    assert set(got.means) == set(want.means)
    for k, v in want.means.items():
        assert got.means[k] == v or (v != v and got.means[k] != got.means[k]), k
    ids = list(want.df.index) + ["missing", "101.0", "101"]
    for sid in ids:
        if not isinstance(sid, str):
            continue
        assert (sid in got) == (sid in want), sid
        for meta in (None, 0.25):
            _same(got.get(sid, meta_tau=meta), want.get(sid, meta_tau=meta))


def test_quartile_and_prediction_tables_match_jax(tmp_path, cohort):
    want, got = jcov.QuartileTable(cohort["quart"]), pcov.QuartileTable(cohort["quart"])
    assert got.map == want.map
    for sid in list(want.map) + ["nope"]:
        assert got.quartile(sid) == want.quartile(sid)
    # all numeric: pandas' iterrows makes the int ids floats
    path = str(tmp_path / "q.csv")
    with open(path, "w") as f:
        f.write("ADNI_ID,quartile_lub,Abeta_Covar\n7,1,0.5\n8,,1\n9,3.0,\n")
    want, got = jcov.QuartileTable(path), pcov.QuartileTable(path)
    assert got.map == want.map
    assert list(got.map) == ["7.0", "9.0"]

    jp, pp = jcov.PredictionTable(cohort["preds"]), pcov.PredictionTable(cohort["preds"])
    assert pp.roi_names == jp.roi_names
    for sid in list(jp.table) + ["nope"]:
        _same(pp.roi_arrays(sid), jp.roi_arrays(sid))
        _same(pp.meta_tau(sid), jp.meta_tau(sid))
        assert (sid in pp) == (sid in jp)


def test_lookup_matches_jax(tmp_path, cohort):
    rows = read_csv(cohort["lookup"]).rows()
    path = str(tmp_path / "lookup.csv")
    bad = dict(rows[0], MRI=rows[0]["MRI"] + ".missing")
    pd.DataFrame(rows[:3] + [bad]).to_csv(path, index=False)
    want = jlookup.load_lookup_csv(path)
    got = plookup.load_lookup_csv(path)
    assert got == want.to_dict("records") and len(got) == 3
    with pytest.raises(ValueError, match="pet"):
        plookup.load_lookup_csv(path, require_columns=("MRI", "roi", "pet"))
    for p in rows[0].values():
        assert plookup.extract_id(p) == jlookup.extract_id(p)
    for p in ("/x/a4/B1/PET/analysis/s.nii", "/x/scan/A/B/C/d.nii",
              "/q/ucsf/U7/x.nii", "a/b", "/p/011_S_1/s/t/u/v.nii",
              "/p/011-S-1/s/t/u.nii"):
        assert plookup.extract_id(p) == jlookup.extract_id(p), p
        assert plookup.get_id_from_path(p) == jlookup.get_id_from_path(p), p
    ids = ["a", "b", "c"]
    assert plookup.filter_for_holdout(ids, ["b"]) == jlookup.filter_for_holdout(ids, ["b"])


def test_recorder_csvs_match_jax(tmp_path):
    """Column-per-epoch CSVs, written over a file that carries pandas'
    index column: the same header and cells. pandas re-reads the earlier
    columns with its own float parser, which may drop a value's last digit
    (-0.01654943077504689 -> -0.0165494307750468, 5.5e-15 relative); the
    port reads them back exactly, so the cells agree to 1e-13."""
    from coma_unet_tpu.metrics.aggregate import MetricResults

    rng = np.random.default_rng(4)

    def results():
        corr = rng.uniform(-1, 1, size=6)
        corr[2] = np.nan
        return MetricResults(
            mae=float(rng.uniform()), mape=float(rng.uniform(0, 300)),
            rse=1.0, rrmse=1.0, ssim=0.5, roi_maes=rng.uniform(size=6),
            roi_mapes=rng.uniform(0, 100, size=6), roi_rses=rng.uniform(size=6),
            roi_wrrmses=rng.uniform(size=6), roi_correlations=corr,
            num_samples=3)

    runs = [results(), results(), results()]
    dirs = {}
    for name, cls in (("jax", JRecorder), ("port", PRecorder)):
        d = tmp_path / name / "validation_metric_results"
        d.mkdir(parents=True)
        # an earlier file with pandas' index column
        pd.DataFrame({"epoch_0": np.arange(6) * 0.5}).to_csv(str(d / "roi_mapes.csv"))
        rec = cls(str(tmp_path / name))
        for epoch, res in zip((1, 2, 1), runs):  # epoch 1 again: replaced
            rec.record(res, epoch)
        dirs[name] = d
    names = sorted(os.listdir(dirs["jax"]))
    assert names == sorted(os.listdir(dirs["port"])) and len(names) == 8
    for n in names:
        want = open(str(dirs["jax"] / n)).read().splitlines()
        got = open(str(dirs["port"] / n)).read().splitlines()
        assert got[0] == want[0] and len(got) == len(want), n
        for g, w in zip(got[1:], want[1:]):
            g, w = g.split(","), w.split(",")
            np.testing.assert_allclose(
                [float(v or "nan") for v in g], [float(v or "nan") for v in w],
                rtol=1e-13, atol=0, err_msg=n)
    head = open(str(dirs["port"] / "roi_mapes.csv")).readline().strip()
    assert head == "epoch_0,epoch_1,epoch_2"


def test_save_matrices_matches_jax(tmp_path):
    from coma_unet_tpu.metrics.aggregate import MetricAccumulator as JAcc
    from coma_unet_tpu_torch.metrics.aggregate import MetricAccumulator as PAcc

    rng = np.random.default_rng(5)
    accs = (JAcc(4), PAcc(4))
    for b, ids in ((3, ["a", "b/c", "d"]), (2, ["e", "f"])):
        vox = {k: rng.uniform(size=b).astype(np.float32)
               for k in ("mae", "mape_num", "mape_cnt", "rse", "rrmse")}
        roi = {k: rng.uniform(size=(b, 4)).astype(np.float32)
               for k in ("mae", "mape_num", "mape_cnt", "rse", "wrrmse",
                         "pred_mean", "gt_mean")}
        abeta = rng.integers(-1, 2, size=b).astype(np.float32)
        for acc in accs:
            acc.update(vox, roi, abeta, ids)
    for name, acc in zip(("jax", "port"), accs):
        acc.save_matrices(str(tmp_path / name), prefix="t_")
    names = sorted(os.listdir(str(tmp_path / "jax")))
    assert names == sorted(os.listdir(str(tmp_path / "port")))
    for n in names:
        assert filecmp.cmp(str(tmp_path / "jax" / n), str(tmp_path / "port" / n),
                           shallow=False), n
    # no ids at all: no header row
    acc = PAcc(2)
    acc.update({k: np.ones(1, np.float32) for k in ("mae", "mape_num", "mape_cnt",
                                                     "rse", "rrmse")},
               {k: np.full((1, 2), 0.1, np.float32) for k in (
                   "mae", "mape_num", "mape_cnt", "rse", "wrrmse", "pred_mean",
                   "gt_mean")}, np.zeros(1, np.float32))
    acc.save_matrices(str(tmp_path / "noids"))
    assert open(str(tmp_path / "noids" / "pred_means.csv")).read() == "0.1\n0.1\n"


# ------------------------------------------------------------ datasets, loader
def _tables(c, port):
    mod = pcov if port else jcov
    return (mod.CovariateTable(c["cov"]), mod.QuartileTable(c["quart"]),
            mod.PredictionTable(c["preds"]))


def _datasets(c, port, mask_path):
    d = pdata if port else jdata
    cov, quart, preds = _tables(c, port)
    kw = dict(pad_dims=(S, S, S))
    return {
        "volume": d.VolumeDataset(c["lookup"], **kw),
        "volume_template": d.VolumeDataset(
            c["lookup"], template_space=True, smoothing=True,
            tau_mask_path=mask_path, pad_dims=(20, 12, S)),
        "covariate": d.CovariateVolumeDataset(c["lookup"], cov, quart, **kw),
        "predicted": d.PredictedMetaTauDataset(c["lookup"], cov, quart,
                                               meta_tau_table=preds, **kw),
        "inference": d.InferenceVolumeDataset(c["lookup"], cov,
                                              meta_tau_table=preds, **kw),
    }


@pytest.fixture(scope="module")
def mask_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("mask") / "mask.nii")
    mask = (np.random.default_rng(6).uniform(size=(S,) * 3) > 0.3).astype(np.float32)
    jnifti.write_nifti(path, mask, spacing=(2.0, 2.0, 2.0))
    return path


@pytest.mark.parametrize("name", ["volume", "volume_template", "covariate",
                                  "predicted", "inference"])
def test_dataset_items_match_jax(cohort, mask_path, name):
    want_ds = _datasets(cohort, False, mask_path)[name]
    got_ds = _datasets(cohort, True, mask_path)[name]
    assert len(got_ds) == len(want_ds) == 8
    for idx in (0, 5):
        want, got = want_ds[idx], got_ds[idx]
        if name == "predicted":  # cluster-mode: the port reads the negative
            want = dict(want)    # that the JAX collate takes
            want["neg"] = want.pop("negs")[0]
        _same(got, want)


def test_loader_batches_match_jax(cohort, tmp_path):
    """Five subjects at b=2, two shuffled passes: the last batch of each
    pass is wrap-padded and flagged."""
    path = str(tmp_path / "five.csv")
    pd.read_csv(cohort["lookup"]).iloc[:5].to_csv(path, index=False)
    loaders = []
    for port in (False, True):
        d = pdata if port else jdata
        cov, quart, preds = _tables(cohort, port)
        ds = d.PredictedMetaTauDataset(path, cov, quart, meta_tau_table=preds,
                                       pad_dims=(S, S, S))
        loaders.append(d.DataLoader(ds, 2, predictions=preds, shuffle=True,
                                    seed=3, num_workers=2,
                                    roi_indices=ROI_INDICES))
    want_loader, got_loader = loaders
    assert len(got_loader) == len(want_loader) == 3
    for _ in range(2):
        want, got = list(want_loader), list(got_loader)
        assert len(got) == len(want) == 3
        for a, b in zip(got, want):
            _same(a, b)
        assert got[-1]["valid"].tolist() == [True, False]
    assert got[0]["roi_compact"].dtype == np.int32


def test_loader_raises_a_worker_error_and_pins():
    import torch

    class Broken:
        def __len__(self):
            return 3

        def __getitem__(self, i):
            raise OSError(f"cannot read {i}")

    with pytest.raises(OSError, match="cannot read"):
        list(pdata.DataLoader(Broken(), 2))
    batch = {"mri": np.ones((1, 2), np.float32), "sample_ids": ["a"],
             "valid": np.ones(1, bool)}
    moved = pdata.batch_to_device(batch, torch.device("cpu"))
    assert set(moved) == {"mri"} and moved["mri"].dtype == torch.float32
