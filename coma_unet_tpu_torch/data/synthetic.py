"""A synthetic cohort on disk (counterpart of
`coma_unet_tpu/data/synthetic.py:make_synthetic_cohort`): the test and
smoke data of the port's host side, since the real ADNI/A4 data cannot ship
with the repo.

ADNI-layout NIfTI volumes (MRI, tau and a FreeSurfer-labelled ROI volume),
a covariate CSV, an abeta x tau-quartile CSV and a per-ROI prediction JSON,
in the schemas that the lookup, covariate and prediction tables read. The
same seed writes the same volumes and CSV rows as the JAX package's.
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
