"""The port's cohort presets, the attention export and the `infer` options
that use them (`--cohort`, `--cohort_dir`, `--save_attention`) against the
JAX package's, on the CPU at f32 (16^3, channels (4, 8, 16), 4 experts).

The synthetic bundles of the five presets are the JAX package's byte for
byte, and `load_cohort_dataset` gives the JAX items exactly. The psi maps
that `export_attention_maps` writes are within 1e-4 of the JAX export's,
from the same parameters (the flax init, bridged by `from_flax`); `infer
--cohort ... --save_attention` writes the volumes and maps of the same
model's forward.
"""

import filecmp
import json
import os

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax  # noqa: E402

import coma_unet_tpu.config as jconfig  # noqa: E402
from coma_unet_tpu.analysis.attention import export_attention_maps as j_export  # noqa: E402
from coma_unet_tpu.data import cohorts as jcohorts  # noqa: E402
from coma_unet_tpu.data.synthetic import make_synthetic_cohort_bundle as j_bundle  # noqa: E402
from coma_unet_tpu.models import ContraAttnUNet as FlaxContra  # noqa: E402

import coma_unet_tpu_torch.config as pconfig  # noqa: E402
from coma_unet_tpu_torch import ContraAttnUNet  # noqa: E402
from coma_unet_tpu_torch import data as pdata  # noqa: E402
from coma_unet_tpu_torch.analysis import export_attention_maps  # noqa: E402
from coma_unet_tpu_torch.cli import main as cli_main  # noqa: E402
from coma_unet_tpu_torch.convert import from_flax  # noqa: E402
from coma_unet_tpu_torch.data import cohorts as pcohorts  # noqa: E402
from coma_unet_tpu_torch.data.synthetic import make_synthetic_cohort_bundle  # noqa: E402
from coma_unet_tpu_torch.infer import make_infer_fn  # noqa: E402
from coma_unet_tpu_torch.io import read_nifti  # noqa: E402

S = 16
MODEL = dict(channels=(4, 8, 16), strides=(2, 2, 2), latent_spaces=(32,) * 3,
             prompt_shape=(S, S, S), num_experts=4, compute_dtype="float32",
             pallas_convs=False, packed_level=False, remat=False)
COHORTS = sorted(pcohorts.COHORT_PRESETS)
ATTN_TOL = 1e-4


@pytest.fixture(scope="module")
def bundles(tmp_path_factory):
    """Each preset's bundle as each package writes it."""
    root = tmp_path_factory.mktemp("bundles")
    return {c: (j_bundle(str(root / "jax" / c), c, n_subjects=4, size=S),
                make_synthetic_cohort_bundle(str(root / "port" / c), c,
                                             n_subjects=4, size=S))
            for c in COHORTS}


def _same(a, b, where=""):
    if isinstance(a, dict):
        assert set(a) == set(b), where
        for k in a:
            _same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    else:
        assert a == b or (a != a and b != b), (where, a, b)


def test_presets_match_jax():
    assert set(pcohorts.COHORT_PRESETS) == set(jcohorts.COHORT_PRESETS)
    for name, preset in pcohorts.COHORT_PRESETS.items():
        want = jcohorts.COHORT_PRESETS[name]
        assert {f: getattr(preset, f) for f in preset.__dataclass_fields__} == {
            f: getattr(want, f) for f in want.__dataclass_fields__}


@pytest.mark.parametrize("cohort", COHORTS)
def test_bundle_files_match_jax(bundles, cohort):
    jroot, proot = bundles[cohort]
    names = []
    for dirpath, _, files in os.walk(jroot):
        names += [os.path.relpath(os.path.join(dirpath, f), jroot) for f in files]
    got = []
    for dirpath, _, files in os.walk(proot):
        got += [os.path.relpath(os.path.join(dirpath, f), proot) for f in files]
    assert sorted(names) == sorted(got) and len(names) == 4 * 2 + 4 + (
        pcohorts.COHORT_PRESETS[cohort].abeta_json is not None)
    for name in names:
        a, b = os.path.join(jroot, name), os.path.join(proot, name)
        if name.endswith(".csv"):  # absolute paths inside: compare relative
            assert (open(a).read().replace(jroot, "<root>")
                    == open(b).read().replace(proot, "<root>")), name
        else:
            assert filecmp.cmp(a, b, shallow=False), name


@pytest.mark.parametrize("cohort", COHORTS)
def test_cohort_dataset_items_match_jax(bundles, cohort):
    _, proot = bundles[cohort]
    got = pcohorts.load_cohort_dataset(cohort, proot, pad_dims=(S, S, S))
    want = jcohorts.load_cohort_dataset(cohort, proot, pad_dims=(S, S, S))
    assert len(got) == len(want) == 4
    for i in range(4):
        _same(got[i], want[i], f"{cohort}[{i}]")
    # subject 0's abeta is missing from the CSV: the fallback fills it
    # where the cohort has one
    has_fallback = pcohorts.COHORT_PRESETS[cohort].abeta_json is not None
    assert got[0]["abeta"] == (1.0 if has_fallback else -1.0)
    assert got[1]["covars"][4] == np.float32(21.0 / 30.0)


def test_missing_files_and_unknown_cohorts(tmp_path, bundles, caplog):
    _, proot = bundles["ucsf"]
    preset = pcohorts.COHORT_PRESETS["ucsf"]
    for name in ("paths_csv", "covariate_csv"):
        os.link(os.path.join(proot, getattr(preset, name)),
                str(tmp_path / getattr(preset, name)))
    got = pcohorts.load_cohort_dataset("ucsf", str(tmp_path), pad_dims=(S, S, S))
    want = jcohorts.load_cohort_dataset("ucsf", str(tmp_path), pad_dims=(S, S, S))
    _same(got[2], want[2])
    assert got[2]["covars"][5] == 0.0 and "missing" in caplog.text
    with pytest.raises(ValueError, match="unknown cohort"):
        pcohorts.load_cohort_dataset("nope", str(tmp_path))


@pytest.fixture(scope="module")
def models():
    """The flax model with its init and the port's with the same
    parameters."""
    example = (np.zeros((2, 1, S, S, S), np.float32), np.zeros((2, 6), np.float32),
               np.zeros((2, 36), np.float32), np.zeros((2, 36), np.float32),
               np.zeros((2, S, S, S), np.int32))
    flax_model = FlaxContra(jconfig.ModelConfig(**MODEL))
    init = jax.jit(lambda key, *a: flax_model.init(key, *a, train=True))
    variables = jax.device_get(init(jax.random.PRNGKey(0), *example))
    port = ContraAttnUNet(pconfig.ModelConfig(**MODEL), device="cpu")
    port.load_state_dict(from_flax(variables["params"], port))
    return flax_model, variables, port


def test_attention_export_matches_jax(bundles, models, tmp_path):
    flax_model, variables, port = models
    _, proot = bundles["ucsf"]
    ds = pcohorts.load_cohort_dataset("ucsf", proot, pad_dims=(S, S, S))
    batch = next(iter(pdata.DataLoader(ds, 2, predictions=ds.meta_tau_table)))
    ids = batch["sample_ids"]
    got = export_attention_maps(port, batch, str(tmp_path / "port"), sample_ids=ids)
    want = j_export(flax_model, variables, batch, str(tmp_path / "jax"), sample_ids=ids)
    assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in want]
    assert len(got) == 2 * 2 and os.path.basename(got[0]) == "COH000_attn_level0.nii"
    for a, b in zip(got, want):
        ia, ib = read_nifti(a), read_nifti(b)
        assert ia.data.shape == ib.data.shape and ia.spacing == ib.spacing
        np.testing.assert_allclose(ia.data, ib.data, rtol=0, atol=ATTN_TOL, err_msg=a)
        assert 0.0 <= ia.data.min() and ia.data.max() <= 1.0
        assert float(np.std(ia.data)) > 0.0


def test_cli_infer_cohort_with_attention(bundles, tmp_path, monkeypatch):
    """`infer --cohort ucsf --cohort_dir <bundle> --save_attention`: the
    loader's items are the JAX `load_cohort_dataset`'s, one synthesized
    volume and one psi map a level per subject, each the forward's of the
    model the CLI builds (the seeded init)."""
    _, proot = bundles["ucsf"]
    cfg = {"model": {k: list(v) if isinstance(v, tuple) else v
                     for k, v in MODEL.items()},
           "data": {"volume_shape": [S, S, S]}, "save_path": str(tmp_path / "r")}
    (tmp_path / "config.json").write_text(json.dumps(cfg))
    seen = []

    class Recording(pdata.DataLoader):
        def __init__(self, dataset, *a, **k):
            seen.append(dataset)
            super().__init__(dataset, *a, **k)

    monkeypatch.setattr(pdata, "DataLoader", Recording)
    out = tmp_path / "synth"
    argv = ["infer", "--config", str(tmp_path / "config.json"), "--device", "cpu",
            "--cohort", "ucsf", "--cohort_dir", proot, "--out_dir", str(out),
            "--save_attention"]
    assert cli_main(argv) == 0
    want = jcohorts.load_cohort_dataset("ucsf", proot, pad_dims=(S, S, S))
    (ds,) = seen
    for i in range(len(want)):
        _same(ds[i], want[i])
    model = ContraAttnUNet(pconfig.ModelConfig(**MODEL), device="cpu",
                           generator=torch.Generator().manual_seed(0))
    infer = make_infer_fn(model)
    loader = Recording(ds, 1, predictions=ds.meta_tau_table)
    for batch in loader:
        sid = batch["sample_ids"][0]
        synth = read_nifti(str(out / f"{sid}_synth_tau.nii")).data_zyx
        ref = infer(*(batch[k] for k in ("mri", "covars", "roi_loc", "roi_std",
                                         "roi_compact")))
        np.testing.assert_allclose(synth, ref[0, 0].numpy(), rtol=1e-6, atol=1e-6)
        export_attention_maps(model, batch, str(tmp_path / "ref"), sample_ids=[sid])
        for level in range(2):
            name = f"{sid}_attn_level{level}.nii"
            assert filecmp.cmp(str(out / "attention" / name),
                               str(tmp_path / "ref" / name), shallow=False)
    assert len(os.listdir(out / "attention")) == 4 * 2


def test_cli_infer_cohort_needs_its_directory(tmp_path, capsys):
    cfg = {"model": {k: list(v) if isinstance(v, tuple) else v
                     for k, v in MODEL.items()},
           "data": {"volume_shape": [S, S, S]}}
    (tmp_path / "config.json").write_text(json.dumps(cfg))
    base = ["infer", "--config", str(tmp_path / "config.json"), "--device", "cpu"]
    assert cli_main(base + ["--cohort", "ucsf"]) == 2
    assert "--cohort requires --cohort_dir" in capsys.readouterr().err
    assert cli_main(base + ["--cohort_dir", str(tmp_path)]) == 2
    assert "--input_lookup is required" in capsys.readouterr().err
