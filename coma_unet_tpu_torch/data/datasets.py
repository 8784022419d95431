"""Datasets on the host (counterpart of the part of
`coma_unet_tpu/data/datasets.py` that training, validation and inference
reach): `VolumeDataset`, `CovariateVolumeDataset`, `PredictedMetaTauDataset`
and `InferenceVolumeDataset`.

Sample schema (numpy):
  mri, tau:  [1, D, H, W] float32
  roi:       [1, D, H, W] float32 (raw FreeSurfer labels)
  abeta:     float
  covars:    [K] float32 ([abeta, age, sex, edu, cog(, meta_tau)])
  sample_id, tau_path: str

`PredictedMetaTauDataset` gives flat samples: the anchors that the JAX
package's cluster-mode items carry, which are all that the RnC loss reads.
The triplet datasets of the tCDS loss are not ported yet.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, Optional, Sequence

import numpy as np

from coma_unet_tpu_torch.data.covariates import (
    CovariateTable,
    PredictionTable,
    QuartileTable,
)
from coma_unet_tpu_torch.data.lookup import extract_id, load_lookup_csv
from coma_unet_tpu_torch.io.volume import load_nifti_vol
from coma_unet_tpu_torch.ops.preprocess import center_pad_crop

log = logging.getLogger(__name__)


class VolumeDataset:
    """MRI / tau / ROI volumes from a lookup CSV, resampled to 2 mm and
    center padded or cropped to `pad_dims`. In native space the MRI is
    masked by ROI != 0; in template space the tau by `tau_mask_path`."""

    def __init__(self, lookup, resize: bool = True,
                 template_space: bool = False, smoothing: bool = False,
                 mri_file_type: Optional[str] = None,
                 tau_file_type: Optional[str] = None,
                 tau_mask_path: Optional[str] = None,
                 pad_dims: Optional[Sequence[int]] = None,
                 drop_missing_files: bool = True,
                 require_columns: Sequence[str] = ("MRI", "tau", "roi")):
        self.rows = load_lookup_csv(lookup, require_columns=require_columns,
                                    drop_missing_files=drop_missing_files)
        self.resize = resize
        # a w* file type is a template-space volume; decided here, once,
        # since the loader's worker threads share the dataset
        if mri_file_type and mri_file_type.startswith("w"):
            template_space = True
        self.template_space = template_space
        self.smoothing = smoothing
        self.mri_file_type = mri_file_type
        self.tau_file_type = tau_file_type
        self.tau_mask_path = tau_mask_path
        if pad_dims is None:
            pad_dims = (128, 128, 128) if resize else (216, 216, 216)
        self.pad_dims = tuple(pad_dims)
        self._tau_mask_cache: Optional[np.ndarray] = None

    def __len__(self) -> int:
        return len(self.rows)

    def _paths(self, idx: int):
        row = self.rows[idx]
        mri_path, tau_path, roi_path = row["MRI"], row["tau"], row["roi"]
        if self.mri_file_type:
            mri_path = os.path.join(os.path.dirname(mri_path), self.mri_file_type)
        if self.tau_file_type:
            tau_path = os.path.join(os.path.dirname(tau_path), self.tau_file_type)
        return mri_path, tau_path, roi_path

    def load_volume_file(self, path: str) -> np.ndarray:
        vol = load_nifti_vol(path, resize=self.resize)
        if vol.shape[-3:] != self.pad_dims:
            vol = center_pad_crop(vol, self.pad_dims)
        return vol

    def _tau_mask(self) -> Optional[np.ndarray]:
        if self.tau_mask_path is None:
            return None
        if self._tau_mask_cache is None:
            self._tau_mask_cache = self.load_volume_file(self.tau_mask_path)
        return self._tau_mask_cache

    def _load_triple(self, idx: int):
        mri_path, tau_path, roi_path = self._paths(idx)
        mri = self.load_volume_file(mri_path)
        tau = self.load_volume_file(tau_path)
        roi = self.load_volume_file(roi_path)
        if self.smoothing:
            tau = _gaussian_smooth_host(tau)
        if not self.template_space:
            mri = mri.copy()
            mri[roi == 0] = 0
        else:
            m = self._tau_mask()
            if m is not None:
                tau = tau.copy()
                tau[m == 0] = 0
        return mri, tau, roi, tau_path

    def __getitem__(self, idx: int) -> Dict:
        mri, tau, roi, tau_path = self._load_triple(idx)
        return {"mri": mri, "tau": tau, "roi": roi, "tau_path": tau_path}


def _gaussian_smooth_host(vol: np.ndarray, sigma: float = 1.0) -> np.ndarray:
    """MONAI `GaussianSmooth` on the host (erf kernel, zero padding), for
    the tau target under `smoothing`."""
    from scipy.ndimage import convolve1d

    from coma_unet_tpu_torch.ops.smooth import gaussian_kernel1d

    k = gaussian_kernel1d(sigma)
    out = vol.astype(np.float32)
    for axis in (-3, -2, -1):
        out = convolve1d(out, k, axis=axis, mode="constant")
    return out


class CovariateVolumeDataset(VolumeDataset):
    """+ the subject's covariates and abeta."""

    def __init__(self, lookup, covariates: CovariateTable,
                 quartiles: Optional[QuartileTable] = None, **kwargs):
        super().__init__(lookup, **kwargs)
        self.covariates = covariates
        self.quartiles = quartiles

    def sample_id(self, idx: int) -> str:
        return extract_id(self.rows[idx]["tau"])

    def meta_tau(self, idx: int) -> Optional[float]:
        return None

    def __getitem__(self, idx: int) -> Dict:
        item = super().__getitem__(idx)
        sid = self.sample_id(idx)
        abeta, covars = self.covariates.get(sid, meta_tau=self.meta_tau(idx))
        item.update({"abeta": abeta, "covars": covars, "sample_id": sid})
        return item


def _meta_tau(table, sid: str) -> float:
    if table is None:
        return 0.0
    if isinstance(table, PredictionTable):
        v = table.meta_tau(sid)
    else:
        v = float(table.get(sid, float("nan")))
    return 0.0 if np.isnan(v) else float(v)


class PredictedMetaTauDataset(CovariateVolumeDataset):
    """Covariates with the predicted meta-tau appended -> covars[6] (0 where
    the table has none)."""

    def __init__(self, lookup, covariates, quartiles=None,
                 meta_tau_table=None, **kwargs):
        super().__init__(lookup, covariates, quartiles, **kwargs)
        self.meta_tau_table = meta_tau_table

    def meta_tau(self, idx: int) -> float:
        return _meta_tau(self.meta_tau_table, self.sample_id(idx))


class InferenceVolumeDataset(CovariateVolumeDataset):
    """MRI-only inference: no tau target (the tau slot carries the MRI);
    covars are the 6-vector, with the predicted abeta and cognition tables
    as fallbacks."""

    def __init__(self, lookup, covariates, meta_tau_table=None,
                 cognition_table=None, abeta_fallback_table=None, **kwargs):
        kwargs.setdefault("drop_missing_files", True)
        kwargs.setdefault("require_columns", ("MRI", "roi"))
        super().__init__(lookup, covariates, None, **kwargs)
        self.meta_tau_table = meta_tau_table
        self.cognition_table = cognition_table or {}
        self.abeta_fallback_table = abeta_fallback_table or {}

    def meta_tau(self, idx: int) -> float:
        if self.meta_tau_table is None:
            return 0.0
        v = self.meta_tau_table.meta_tau(self.sample_id(idx))
        return 0.0 if np.isnan(v) else float(v)

    def __getitem__(self, idx: int) -> Dict:
        mri_path, _, roi_path = self._paths(idx)
        mri = self.load_volume_file(mri_path)
        roi = self.load_volume_file(roi_path)
        mri = mri.copy()
        mri[roi == 0] = 0
        sid = self.sample_id(idx)
        abeta, covars = self.covariates.get(sid, meta_tau=self.meta_tau(idx))
        if abeta == -1.0 and sid in self.abeta_fallback_table:
            abeta = float(self.abeta_fallback_table[sid])
            covars = covars.copy()
            covars[0] = abeta
        if sid in self.cognition_table:
            covars = covars.copy()
            covars[4] = float(self.cognition_table[sid]) / 30.0
        return {"mri": mri, "tau": mri, "roi": roi, "abeta": abeta,
                "covars": covars, "sample_id": sid, "tau_path": mri_path}

    def sample_id(self, idx: int) -> str:
        row = self.rows[idx]
        if "SAMPLE_ID" in row:
            return str(row["SAMPLE_ID"])
        return extract_id(row["MRI"])

    def _paths(self, idx: int):
        row = self.rows[idx]
        roi = row["roi"] if "roi" in row else row["MRI"]
        return row["MRI"], row.get("tau", row["MRI"]), roi
