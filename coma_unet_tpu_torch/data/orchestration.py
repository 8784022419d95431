"""Split orchestration (counterpart of `coma_unet_tpu/data/orchestration.py`):
the per-fold train/test datasets, the ADNI-train / A4-test single split, a
loader that gives triplet datasets the NaN-abeta-skipping `CustomSampler`,
and the subjects with more than one session."""

from __future__ import annotations

import os
from collections import Counter
from typing import Optional, Sequence, Tuple

from coma_unet_tpu_torch.data.covariates import (
    CovariateTable,
    PredictionTable,
    QuartileTable,
)
from coma_unet_tpu_torch.data.datasets import (
    ContrastiveVolumeDataset,
    CovariateVolumeDataset,
    CustomSampler,
    PredictedMetaTauDataset,
)
from coma_unet_tpu_torch.data.lookup import extract_id
from coma_unet_tpu_torch.data.pipeline import DataLoader


def load_split_datasets(splits_dir: str, fold: int, covariate_csv: str,
                        quartile_csv: Optional[str] = None,
                        meta_tau_source=None, mode: str = "cluster",
                        **dataset_kwargs
                        ) -> Tuple[PredictedMetaTauDataset, PredictedMetaTauDataset]:
    """Fold `fold`'s train and test datasets from `training_lookup_k.csv`
    and `test_lookup_k.csv` under `splits_dir`; `meta_tau_source` is a
    PredictionTable, None, or what one is read from."""
    cov = CovariateTable(covariate_csv)
    quart = QuartileTable(quartile_csv) if quartile_csv else None
    meta = (meta_tau_source
            if meta_tau_source is None or isinstance(meta_tau_source, PredictionTable)
            else PredictionTable(meta_tau_source))

    def make(name: str) -> PredictedMetaTauDataset:
        return PredictedMetaTauDataset(
            os.path.join(splits_dir, f"{name}_lookup_{fold}.csv"), cov, quart,
            meta_tau_table=meta, mode=mode, **dataset_kwargs)

    return make("training"), make("test")


def load_single_split_datasets(train_lookup: str, test_lookup: str,
                               covariate_csv: str,
                               expected_sizes: Optional[Tuple[int, int]] = None,
                               **dataset_kwargs):
    """The ADNI-train / A4-test split; `expected_sizes` (the reference's
    (1695, 444)) raises AssertionError where the splits differ."""
    cov = CovariateTable(covariate_csv)
    train = CovariateVolumeDataset(train_lookup, cov, **dataset_kwargs)
    test = CovariateVolumeDataset(test_lookup, cov, **dataset_kwargs)
    if expected_sizes is not None:
        for what, ds, want in (("train", train, expected_sizes[0]),
                               ("test", test, expected_sizes[1])):
            if len(ds) != want:
                raise AssertionError(f"{what} split {len(ds)} != {want}")
    return train, test


def create_dataloader(dataset, batch_size: int, shuffle: bool = False,
                      contra: bool = False, skip_ids: Sequence[str] = (),
                      **loader_kwargs) -> DataLoader:
    """A loader; with `contra`, a triplet dataset's indices come from a
    `CustomSampler` (shuffled once, when `shuffle`)."""
    sampler = None
    if contra and isinstance(dataset, ContrastiveVolumeDataset):
        sampler = CustomSampler(dataset, skip_ids=skip_ids, shuffle=shuffle)
        shuffle = False
    return DataLoader(dataset, batch_size, sampler=sampler, shuffle=shuffle,
                      **loader_kwargs)


def check_for_longitudinal(paths: Sequence[str]) -> dict:
    """{subject: sessions} for the subjects with more than one among
    `paths`."""
    subject = Counter(extract_id(p).split("/")[0] for p in paths)
    return {sid: n for sid, n in subject.items() if n > 1}
