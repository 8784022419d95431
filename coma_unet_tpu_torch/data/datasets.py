"""Datasets on the host (counterpart of `coma_unet_tpu/data/datasets.py`):
`VolumeDataset`, `CovariateVolumeDataset`, the triplet family of the tCDS
loss (`ContrastiveVolumeDataset`, `ClusterVolumeDataset`,
`RegressionVolumeDataset`, `PredictedMetaTauDataset`),
`CombinedVolumeDataset`, `A4VolumeDataset`, `InferenceVolumeDataset` and
`CustomSampler`. Volumes are read by the native reader (`runtime/`).

Sample schema (numpy):
  mri, tau:  [1, D, H, W] float32
  roi:       [1, D, H, W] float32 (raw FreeSurfer labels)
  abeta:     float
  covars:    [K] float32 ([abeta, age, sex, edu, cog(, meta_tau)])
  sample_id, tau_path: str
The triplet datasets nest samples: {"anchor", "pos", "neg"}.

A triplet dataset draws a sample's partners (`draw`) apart from reading
its volumes (`load`): `draw(idx)` consumes the dataset's generator as the
JAX dataset's `__getitem__(idx)` does, so the same seed and the same order
of indices give the JAX dataset's partners. `load` reads only what the
batch uses: the anchor, the positive and the first negative (the JAX
cluster item carries up to 7 negatives, and its `collate` keeps the first),
or the anchor alone where the batch takes no partners (the RnC loss).
"""

from __future__ import annotations

import logging
import os
import random
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from coma_unet_tpu_torch.data.covariates import (
    CovariateTable,
    PredictionTable,
    QuartileTable,
)
from coma_unet_tpu_torch.data.lookup import extract_id, load_lookup_csv
from coma_unet_tpu_torch.runtime.native import load_batch_native

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

    def load_volume_files(self, paths: Sequence[str]) -> List[np.ndarray]:
        """The files as [1, D, H, W] volumes, read together by the native
        reader, one C++ thread a file."""
        vols = load_batch_native(paths, self.pad_dims, resize=self.resize,
                                 num_threads=len(paths))
        return [v[None] for v in vols]

    def load_volume_file(self, path: str) -> np.ndarray:
        return self.load_volume_files([path])[0]

    def _tau_mask(self) -> Optional[np.ndarray]:
        if self.tau_mask_path is None:
            return None
        if self._tau_mask_cache is None:
            self._tau_mask_cache = self.load_volume_file(self.tau_mask_path)
        return self._tau_mask_cache

    def _load_triple(self, idx: int):
        mri_path, tau_path, roi_path = self._paths(idx)
        mri, tau, roi = self.load_volume_files([mri_path, tau_path, roi_path])
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


class ContrastiveVolumeDataset(CovariateVolumeDataset):
    """(anchor, pos, neg) triplets: the positive is a random other subject
    of the anchor's (abeta, tau quartile) cell, the negative another from
    the same cell as the reference draws it, or with `true_negatives` a
    random subject of any other cell; the anchor itself where its cell has
    no other."""

    def __init__(self, lookup, covariates, quartiles, true_negatives=False,
                 seed: int = 0, **kwargs):
        super().__init__(lookup, covariates, quartiles, **kwargs)
        self.true_negatives = true_negatives
        self.rng = random.Random(seed)
        self._index_cells()

    def _index_cells(self) -> None:
        self._cell: Dict[tuple, List[int]] = {}
        self._key: List[tuple] = []
        for i in range(len(self.rows)):
            sid = self.sample_id(i)
            abeta, _ = self.covariates.get(sid)
            q = self.quartiles.quartile(sid) if self.quartiles else -1
            key = (int(abeta), int(q))
            self._cell.setdefault(key, []).append(i)
            self._key.append(key)

    def _pick_other(self, idxs: List[int], me: int) -> int:
        pool = [i for i in idxs if i != me]
        return self.rng.choice(pool) if pool else me

    def draw(self, idx: int) -> Dict[str, Any]:
        """The partners of sample `idx`: {"pos": index, "negs": [index]}."""
        key = self._key[idx]
        cell = self._cell.get(key, [idx])
        pos = self._pick_other(cell, idx)
        if self.true_negatives:
            others = [i for k, v in self._cell.items() if k != key for i in v]
            neg = self.rng.choice(others) if others else idx
        else:
            neg = self._pick_other(cell, idx)
        return {"pos": pos, "negs": [neg]}

    def load(self, idx: int, partners: Optional[Dict[str, Any]] = None) -> Dict:
        """The sample {"anchor", "pos", "neg"} for drawn `partners` (the
        first negative, or the positive where none was drawn); {"anchor"}
        alone when `partners` is None. A subject drawn twice is read once."""
        items = {idx: CovariateVolumeDataset.__getitem__(self, idx)}

        def item(i: int) -> Dict:
            if i not in items:
                items[i] = CovariateVolumeDataset.__getitem__(self, i)
            return items[i]

        if partners is None:
            return {"anchor": items[idx]}
        negs = partners["negs"]
        return {"anchor": items[idx], "pos": item(partners["pos"]),
                "neg": item(negs[0] if negs else partners["pos"])}

    def __getitem__(self, idx: int) -> Dict:
        return self.load(idx, self.draw(idx))


class ClusterVolumeDataset(ContrastiveVolumeDataset):
    """Negatives: one random subject of every other non-empty (abeta,
    quartile) cell, in the cells' order (up to 7)."""

    def draw(self, idx: int) -> Dict[str, Any]:
        key = self._key[idx]
        pos = self._pick_other(self._cell.get(key, [idx]), idx)
        negs = [self.rng.choice(idxs) for k, idxs in sorted(self._cell.items())
                if k != key and idxs]
        return {"pos": pos, "negs": negs}


def _meta_tau(table, sid: str) -> float:
    if table is None:
        return 0.0
    if isinstance(table, PredictionTable):
        v = table.meta_tau(sid)
    else:
        v = float(table.get(sid, float("nan")))
    return 0.0 if np.isnan(v) else float(v)


class RegressionVolumeDataset(ClusterVolumeDataset):
    """Covariates with the meta-tau appended -> covars[6] (0 where the table
    has none); partners by `mode`, "cluster" or else "contrastive". With
    `meta_tau_noise_std` > 0 the label carries Gaussian noise drawn from a
    generator seeded by `hash((sample id, noise_seed))`, as the JAX
    package's: Python salts the hash of a string per process (unless
    PYTHONHASHSEED is set), so the noise repeats within a process only."""

    def __init__(self, lookup, covariates, quartiles=None, meta_tau_table=None,
                 mode: str = "cluster", meta_tau_noise_std: float = 0.0,
                 noise_seed: int = 0, **kwargs):
        self.meta_tau_table = meta_tau_table
        self.mode = mode
        self.meta_tau_noise_std = meta_tau_noise_std
        self.noise_seed = noise_seed
        super().__init__(lookup, covariates, quartiles, **kwargs)

    def meta_tau(self, idx: int) -> float:
        sid = self.sample_id(idx)
        v = _meta_tau(self.meta_tau_table, sid)
        if self.meta_tau_noise_std > 0.0:
            rng = np.random.default_rng(hash((sid, self.noise_seed)) % (2**32))
            v += float(rng.normal(0.0, self.meta_tau_noise_std))
        return v

    def draw(self, idx: int) -> Dict[str, Any]:
        if self.mode == "cluster":
            return ClusterVolumeDataset.draw(self, idx)
        return ContrastiveVolumeDataset.draw(self, idx)


class PredictedMetaTauDataset(RegressionVolumeDataset):
    """`RegressionVolumeDataset` with the meta-tau from the prediction table
    (a `PredictionTable`): the training and validation dataset of the
    CLI."""


class CombinedVolumeDataset(CovariateVolumeDataset):
    """The flat ADNI + A4 dataset of the CLI's `--combined`: covars
    [abeta, age, sex, edu, cognition, meta_tau], the cognition (the
    predicted MMSCORE / 30) from `cognition_table` where it has the subject,
    the abeta from `abeta_fallback_table` where the covariate table has
    none (-1)."""

    def __init__(self, lookup, covariates: CovariateTable,
                 meta_tau_table: Optional[PredictionTable] = None,
                 cognition_table: Optional[dict] = None,
                 abeta_fallback_table: Optional[dict] = None, **kwargs):
        super().__init__(lookup, covariates, None, **kwargs)
        self.meta_tau_table = meta_tau_table
        self.cognition_table = cognition_table or {}
        self.abeta_fallback_table = abeta_fallback_table or {}

    def __getitem__(self, idx: int) -> Dict:
        item = VolumeDataset.__getitem__(self, idx)
        sid = self.sample_id(idx)
        meta = (self.meta_tau_table.meta_tau(sid)
                if self.meta_tau_table is not None else 0.0)
        meta = 0.0 if (meta is None or np.isnan(meta)) else float(meta)
        abeta, covars = self.covariates.get(sid, meta_tau=meta)
        abeta, covars = _fallbacks(sid, abeta, covars, self.abeta_fallback_table,
                                   self.cognition_table)
        item.update({"abeta": abeta, "covars": covars, "sample_id": sid})
        return item


def _fallbacks(sid: str, abeta: float, covars: np.ndarray, abeta_table: dict,
               cognition_table: dict):
    """The predicted abeta where the covariate table has none (-1), and the
    predicted cognition / 30 where the table has the subject."""
    if abeta == -1.0 and sid in abeta_table:
        abeta = float(abeta_table[sid])
        covars = covars.copy()
        covars[0] = abeta
    if sid in cognition_table:
        covars = covars.copy()
        covars[4] = float(cognition_table[sid]) / 30.0
    return abeta, covars


class A4VolumeDataset(CovariateVolumeDataset):
    """The A4 cohort; its covariate CSV's own column names (BID, ABETA) are
    read by `CovariateTable`'s aliases."""


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
        mri, roi = self.load_volume_files([mri_path, roi_path])
        mri = mri.copy()
        mri[roi == 0] = 0
        sid = self.sample_id(idx)
        abeta, covars = self.covariates.get(sid, meta_tau=self.meta_tau(idx))
        abeta, covars = _fallbacks(sid, abeta, covars, self.abeta_fallback_table,
                                   self.cognition_table)
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


class CustomSampler:
    """The dataset's indices without the subjects in `skip_ids` and those
    whose abeta is NaN, shuffled once by `rnd_seed` when `shuffle`."""

    def __init__(self, dataset: CovariateVolumeDataset,
                 skip_ids: Sequence[str] = (), shuffle: bool = False,
                 rnd_seed: int = 0):
        skip = set(skip_ids)
        self.indices = []
        for i in range(len(dataset)):
            sid = dataset.sample_id(i)
            if sid in skip:
                continue
            abeta, _ = dataset.covariates.get(sid)
            if np.isnan(abeta):
                continue
            self.indices.append(i)
        if shuffle:
            random.Random(rnd_seed).shuffle(self.indices)

    def __iter__(self):
        return iter(self.indices)

    def __len__(self) -> int:
        return len(self.indices)
