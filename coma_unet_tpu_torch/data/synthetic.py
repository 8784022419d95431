"""A synthetic cohort on disk (counterpart of
`coma_unet_tpu/data/synthetic.py`): the test and smoke data of the port's
host side, since the real ADNI/A4 data cannot ship with the repo.

ADNI-layout NIfTI volumes (MRI, tau and a FreeSurfer-labelled ROI volume),
a covariate CSV, an abeta x tau-quartile CSV and a per-ROI prediction JSON,
in the schemas that the lookup, covariate and prediction tables read; and
an MRI-only cohort bundle for `infer --cohort`. The same seed writes the
same volumes and CSV rows as the JAX package's.
"""

from __future__ import annotations

import json
import os
from typing import Dict

import numpy as np

from coma_unet_tpu_torch.config import ROI_INDEX_TO_NAME, ROI_INDICES
from coma_unet_tpu_torch.data.table import write_rows
from coma_unet_tpu_torch.io.nifti import write_nifti


def make_synthetic_cohort(root: str, n_subjects: int = 8, size: int = 16,
                          spacing: float = 2.0, num_rois: int = 5,
                          seed: int = 0) -> Dict[str, str]:
    """Write an n-subject cohort under `root`; returns {"root", "lookup",
    "cov", "quart", "preds"} paths. Volumes are `size`^3 at `spacing` mm;
    ROI volumes carry the first `num_rois` labels of `ROI_INDICES` and the
    background 0; ids follow the ADNI xnat layout that `extract_id`
    parses."""
    rng = np.random.default_rng(seed)
    rows, cov_rows, quart_rows = [], [], []
    preds: Dict[str, dict] = {}
    labels = [0] + list(ROI_INDICES[:num_rois])
    for i in range(n_subjects):
        sid = f"{i:03d}-S-{1000 + i}"
        d = os.path.join(root, "adni", sid, "PET_2020-01-01_FTP", "analysis")
        os.makedirs(d, exist_ok=True)
        mri = rng.uniform(0, 255, size=(size,) * 3).astype(np.float32)
        tau = rng.uniform(0, 2, size=(size,) * 3).astype(np.float32)
        roi = np.asarray(labels)[
            rng.integers(0, len(labels), size=(size,) * 3)].astype(np.float32)
        for name, vol in (("rnu.nii", mri), ("suvr_cereg.nii", tau),
                          ("raparc+aseg.nii", roi)):
            write_nifti(os.path.join(d, name), np.transpose(vol, (2, 1, 0)),
                        spacing=(spacing,) * 3)
        key = f"{sid}/PET_2020-01-01_FTP"
        rows.append({"MRI": os.path.join(d, "rnu.nii"),
                     "tau": os.path.join(d, "suvr_cereg.nii"),
                     "roi": os.path.join(d, "raparc+aseg.nii")})
        cov_rows.append({"ADNI_ID": key, "Abeta_Covar": i % 2,
                         "Age": 60 + i, "Sex": "M" if i % 2 else "F",
                         "Education": 12 + i % 5, "Cognition": 20 + i})
        quart_rows.append({"ADNI_ID": key, "quartile_lub": (i % 4) + 1})
        preds[key] = {ROI_INDEX_TO_NAME[r]: {"loc": float(i), "std": 0.1}
                      for r in ROI_INDICES[:num_rois]}
        preds[key]["Tau_Meta"] = {"loc": 1.0 + i, "std": 0.2}

    paths = dict(root=root, lookup=os.path.join(root, "lookup.csv"),
                 cov=os.path.join(root, "covars.csv"),
                 quart=os.path.join(root, "quarts.csv"),
                 preds=os.path.join(root, "preds.json"))
    write_rows(paths["lookup"], rows)
    write_rows(paths["cov"], cov_rows)
    write_rows(paths["quart"], quart_rows)
    with open(paths["preds"], "w") as f:
        json.dump(preds, f)
    return paths


def make_synthetic_cohort_bundle(root: str, cohort: str = "ucsf",
                                 n_subjects: int = 4, size: int = 16,
                                 spacing: float = 2.0, seed: int = 0) -> str:
    """Write the preset bundle of `cohort` under `root`, in its file names
    (`data/cohorts.py`), so that `infer --cohort <cohort> --cohort_dir
    <root>` runs on it; returns `root`. MRI-only subjects: the paths CSV
    (SAMPLE_ID, MRI, roi), the covariate CSV (subject 0's abeta missing, so
    that the fallback table fills it), the tau-meta and cognition JSONs,
    and the abeta JSON where the cohort has one."""
    from coma_unet_tpu_torch.data.cohorts import COHORT_PRESETS

    preset = COHORT_PRESETS[cohort]
    rng = np.random.default_rng(seed)
    rows, cov_rows = [], []
    tau_meta: Dict[str, dict] = {}
    cognition: Dict[str, float] = {}
    abeta: Dict[str, float] = {}
    for i in range(n_subjects):
        sid = f"COH{i:03d}"
        d = os.path.join(root, "scans", sid)
        os.makedirs(d, exist_ok=True)
        mri = rng.uniform(0, 255, size=(size,) * 3).astype(np.float32)
        roi = rng.integers(0, 3, size=(size,) * 3).astype(np.float32)
        for name, vol in (("mri.nii", mri), ("roi.nii", roi)):
            write_nifti(os.path.join(d, name), np.transpose(vol, (2, 1, 0)),
                        spacing=(spacing,) * 3)
        rows.append({"SAMPLE_ID": sid, "MRI": os.path.join(d, "mri.nii"),
                     "roi": os.path.join(d, "roi.nii")})
        cov_rows.append({"SAMPLE_ID": sid,
                         "Abeta_Covar": float("nan") if i == 0 else i % 2,
                         "Age": 60 + i, "PTGENDER": "Male" if i % 2 else "Female",
                         "Education": 12 + i})
        tau_meta[sid] = {"Tau_Meta": {"loc": 1.0 + i, "std": 0.2}}
        cognition[sid] = 20.0 + i
        abeta[sid] = 1.0
    write_rows(os.path.join(root, preset.paths_csv), rows)
    write_rows(os.path.join(root, preset.covariate_csv), cov_rows)
    tables = [(preset.tau_meta_json, tau_meta), (preset.cognition_json, cognition)]
    if preset.abeta_json:
        tables.append((preset.abeta_json, abeta))
    for name, table in tables:
        with open(os.path.join(root, name), "w") as f:
            json.dump(table, f)
    return root
