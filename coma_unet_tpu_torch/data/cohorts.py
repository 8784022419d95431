"""The per-cohort inference presets of `infer --cohort <name> --cohort_dir
<base>` (counterpart of `coma_unet_tpu/data/cohorts.py`).

Each of the five cohorts (UCSF, unseen A4, NACC, NACC non-SCAN, ADNI with
autopsy) is a bundle of files under one base directory, under the
reference's file names: the paths CSV, the CatBoostUQ tau-meta JSON, the
KNN MMSCORE JSON, the covariate CSV and, for UCSF and both NACC bundles,
the CatBoostUQ abeta JSON. A missing JSON reads as an empty table, with a
warning.
"""

from __future__ import annotations

import json
import logging
import os
from dataclasses import dataclass
from typing import Optional, Tuple

from coma_unet_tpu_torch.data.covariates import CovariateTable, PredictionTable
from coma_unet_tpu_torch.data.datasets import InferenceVolumeDataset

log = logging.getLogger(__name__)


@dataclass(frozen=True)
class CohortPreset:
    """The file names of one cohort's bundle."""

    name: str
    paths_csv: str
    tau_meta_json: str
    cognition_json: str
    covariate_csv: str
    abeta_json: Optional[str] = None


COHORT_PRESETS = {
    "ucsf": CohortPreset(
        name="ucsf",
        paths_csv="UCSF_paths.csv",
        tau_meta_json="CatBoostUQ_Tau_Meta_predictions_for_UCSF_data.json",
        cognition_json="KNN_MMSCORE_predictions_for_UCSF_data.json",
        abeta_json="CatBoostUQ_Abeta_Covar_predictions_for_UCSF_data.json",
        covariate_csv="UCSF_data_Covar_lookup.csv",
    ),
    "a4": CohortPreset(
        name="a4",
        paths_csv="unseen_A4_sample_path_lookup.csv",
        tau_meta_json="CatBoostUQ_Tau_Meta_predictions_for_Additional_A4_data.json",
        cognition_json="KNN_MMSCORE_predictions_for_unseen_A4_data.json",
        covariate_csv="unseen_A4_Covar_lookup.csv",
    ),
    "nacc": CohortPreset(
        name="nacc",
        paths_csv="NACC_paths.csv",
        tau_meta_json="CatBoostUQ_Tau_Meta_predictions_for_NACC.json",
        cognition_json="KNN_MMSCORE_predictions_for_NACC_data.json",
        abeta_json="CatBoostUQ_Abeta_Covar_predictions_for_NACC.json",
        covariate_csv="NACC_Covar_lookup.csv",
    ),
    "nacc_nonscan": CohortPreset(
        name="nacc_nonscan",
        paths_csv="all_paths.csv",
        tau_meta_json="CatBoostUQ_Tau_Meta_predictions_for_nonSCAN_NACC.json",
        cognition_json="KNN_MMSCORE_predictions_for_nonSCAN_NACC.json",
        abeta_json="CatBoostUQ_Abeta_Covar_predictions_for_nonSCAN_NACC.json",
        covariate_csv="NACC_nonSCAN_Covar_lookup.csv",
    ),
    "adni_autopsy": CohortPreset(
        name="adni_autopsy",
        paths_csv="ADNI_wAutopsy_paths.csv",
        tau_meta_json="CatBoostUQ_Tau_Meta_predictions_for_ADNI_wAutopsy.json",
        cognition_json="KNN_MMSCORE_predictions_for_ADNI_wAutopsy.json",
        covariate_csv="ADNI_wAutopsy_Covar_lookup.csv",
    ),
}


def _load_json(path: str, what: str) -> dict:
    if not os.path.isfile(path):
        log.warning("cohort preset: missing %s (%s), read as an empty table",
                    what, path)
        return {}
    with open(path) as f:
        return json.load(f)


def load_cohort_dataset(cohort: str, base_dir: str,
                        pad_dims: Tuple[int, int, int] = (128, 128, 128),
                        paths_csv: Optional[str] = None,
                        covariate_csv: Optional[str] = None
                        ) -> InferenceVolumeDataset:
    """The `InferenceVolumeDataset` of a named cohort: its tau-meta and
    cognition tables, and the abeta fallback where the cohort has one.
    `paths_csv` and `covariate_csv` override the preset's files; the rest
    are read from `base_dir`."""
    if cohort not in COHORT_PRESETS:
        raise ValueError(f"unknown cohort {cohort!r}; choose from "
                         f"{sorted(COHORT_PRESETS)}")
    preset = COHORT_PRESETS[cohort]

    def path(name: str) -> str:
        return os.path.join(base_dir, name)

    tau_meta = PredictionTable(_load_json(path(preset.tau_meta_json), "tau-meta"))
    cognition = _load_json(path(preset.cognition_json), "cognition")
    abeta = (_load_json(path(preset.abeta_json), "abeta fallback")
             if preset.abeta_json else {})
    return InferenceVolumeDataset(
        paths_csv or path(preset.paths_csv),
        CovariateTable(covariate_csv or path(preset.covariate_csv)),
        meta_tau_table=tau_meta, cognition_table=cognition,
        abeta_fallback_table=abeta, pad_dims=pad_dims)
