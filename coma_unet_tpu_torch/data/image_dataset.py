"""`ImageDataset`, the ROI-SUVR-vector regression pipeline's dataset
(counterpart of `coma_unet_tpu/data/image_dataset.py`): rows of per-ROI
SUVR values (and covariate columns) with a target vector, with column
selection and standardization. Tables are read with `data/table.py`, the
standard library's `csv` typed as pandas types them, not with pandas."""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from coma_unet_tpu_torch.data.table import Table, is_numeric, read_csv


class ImageDataset:
    """Tabular (ROI-vector) dataset.

    Args:
      source: a CSV path or a `Table`; one row per scan.
      col_list: feature columns (settable later by `set_col_list`); by
        default the numeric columns.
      target_cols: target columns (by default the features: the pipeline
        regresses tau ROI means).
    """

    def __init__(self, source, col_list: Optional[Sequence[str]] = None,
                 target_cols: Optional[Sequence[str]] = None, transform=None):
        self.table = source if isinstance(source, Table) else read_csv(source)
        self.col_list = list(col_list) if col_list else [
            c for c in self.table.columns if is_numeric(self.table[c])]
        self.target_cols = list(target_cols) if target_cols else self.col_list
        self.transform = transform
        self._mean: Optional[np.ndarray] = None
        self._std: Optional[np.ndarray] = None

    def set_col_list(self, col_list: Sequence[str]) -> None:
        self.col_list = list(col_list)
        self._mean = self._std = None  # the statistics no longer fit the columns

    def set_mean_std(self, mean, std) -> None:
        self._mean = np.asarray(mean, np.float32)
        self._std = np.asarray(std, np.float32)

    def __len__(self) -> int:
        return len(self.table)

    def _row(self, idx: int, cols: Sequence[str]) -> np.ndarray:
        return np.asarray([self.table[c][idx] for c in cols], np.float32)

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        x = self._row(idx, self.col_list)
        if self._mean is not None:
            x = (x - self._mean) / np.where(self._std == 0, 1.0, self._std)
        y = self._row(idx, self.target_cols)
        if self.transform:
            x = self.transform(x)
        return x, y

    def _columns(self, cols: Sequence[str]) -> np.ndarray:
        """[rows, cols] float32, column-major as pandas' `to_numpy` gives
        it: numpy's reductions over the rows then add in the same order."""
        return np.asarray([self.table[c] for c in cols], np.float32).reshape(
            len(cols), len(self)).T

    def get_targets(self) -> np.ndarray:
        return self._columns(self.target_cols)

    def get_mris(self) -> np.ndarray:
        return self._columns(self.col_list)
