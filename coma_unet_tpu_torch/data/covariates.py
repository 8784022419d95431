"""Covariate, quartile and prediction tables (counterpart of
`coma_unet_tpu/data/covariates.py`, without pandas).

`CovariateTable` reads the covariate CSV: columns ADNI_ID / Abeta_Covar /
Age / Sex / Education / Cognition, with the A4 and inference-time aliases
(BID, ABETA, PTGENDER, MMSCORE, SAMPLE_ID); Sex mapped M -> 0, F -> 1 when
the column is not numeric; Age, Education and Cognition MinMax-scaled over
the table, and a missing value replaced by the table's mean in the scaled
space; a missing abeta -> -1; the first row wins for a duplicated id.

`QuartileTable` maps an id to its tau quartile (`quartile_lub`) and, where
the table has the column, to its `Abeta_Covar`.

`PredictionTable` wraps the per-subject per-ROI tau predictions
(id -> {roi_name: {"loc": m, "std": s}}, JSON or a pickled .npy dict),
exports them as dense [R] arrays in `ROI_INDICES` order and merges two
tables.
"""

from __future__ import annotations

import json
import math
from typing import Any, Dict, Optional, Tuple

import numpy as np

from coma_unet_tpu_torch.config import ROI_INDEX_TO_NAME, ROI_INDICES
from coma_unet_tpu_torch.data.table import (
    Table,
    is_na,
    is_numeric,
    nanmean,
    read_csv,
    to_numeric,
)

_COLUMN_ALIASES = {
    "PTGENDER": "Sex",
    "MMSCORE": "Cognition",
    "BID": "ADNI_ID",
    "ABETA": "Abeta_Covar",
    "SAMPLE_ID": "ADNI_ID",
}


def _table(csv_path_or_table) -> Table:
    if isinstance(csv_path_or_table, Table):
        return csv_path_or_table
    return read_csv(str(csv_path_or_table))


def _id_strings(values) -> list:
    """An id column as strings (`astype(str)`): ints without a decimal
    point, floats as numpy writes them, a missing id as None."""
    if is_numeric(values) and not all(isinstance(v, int) for v in values):
        return [None if is_na(v) else str(np.float64(v)) for v in values]
    return [None if is_na(v) else str(v) for v in values]


def _sex_code(value: Any) -> float:
    return {"M": 0.0, "F": 1.0}.get(str(value).strip().upper()[:1], math.nan)


class CovariateTable:
    """id -> (abeta, covars[5]) with MinMax-scaled continuous columns."""

    def __init__(self, csv_path_or_table, id_column: str = "ADNI_ID",
                 scale_education_by_30: bool = False,
                 alias_columns: bool = True):
        table = _table(csv_path_or_table)
        if alias_columns:
            table = table.rename(_COLUMN_ALIASES)
        if id_column not in table and "ADNI_ID" in table:
            id_column = "ADNI_ID"
        cols: Dict[str, list] = {c: list(table[c]) for c in table.columns}
        if "Sex" in cols and not is_numeric(cols["Sex"]):
            cols["Sex"] = [_sex_code(v) for v in cols["Sex"]]
        for col in ("Age", "Education", "Cognition"):
            if col in cols:
                v = to_numeric(cols[col])
                lo, hi = _nanmin(v), _nanmax(v)
                rng = (hi - lo) if hi > lo else 1.0
                cols[col + "_scaled"] = list((v - lo) / rng)
        if scale_education_by_30 and "Education" in cols:
            cols["Education_scaled"] = list(to_numeric(cols["Education"]) / 30.0)
        self.means: Dict[str, float] = {}
        for c in ("Age", "Sex", "Education", "Cognition", "Abeta_Covar"):
            if c in cols:
                src = c + "_scaled" if c + "_scaled" in cols else c
                self.means[c] = nanmean(to_numeric(cols[src]))
        self.columns = cols
        # the first row of an id wins
        self._rows: Dict[str, int] = {}
        for i, sid in enumerate(_id_strings(cols[id_column])):
            if sid is not None:
                self._rows.setdefault(sid, i)

    def __contains__(self, sid: str) -> bool:
        return str(sid) in self._rows

    def _value(self, i: int, col: str) -> float:
        v = self.columns[col][i] if col in self.columns else math.nan
        return math.nan if is_na(v) else v

    def get(self, sid: str, meta_tau: Optional[float] = None
            ) -> Tuple[float, np.ndarray]:
        """(abeta, covars) with covars = [abeta, age, sex, edu, cog]
        (+ meta_tau appended when given). A missing abeta -> -1, a missing
        continuous value -> the table's mean."""
        i = self._rows.get(str(sid))
        if i is not None:
            abeta = self._value(i, "Abeta_Covar")
            abeta = -1.0 if is_na(abeta) else float(abeta)
            vals = []
            for col in ("Age", "Sex", "Education", "Cognition"):
                v = self._value(i, col if col == "Sex" else col + "_scaled")
                vals.append(float(self.means.get(col, 0.0) if is_na(v) else v))
        else:
            abeta = -1.0
            vals = [self.means.get(c, 0.0)
                    for c in ("Age", "Sex", "Education", "Cognition")]
        covars = np.asarray([abeta] + vals, dtype=np.float32)
        if meta_tau is not None:
            covars = np.concatenate([covars, np.asarray([meta_tau], np.float32)])
        return abeta, covars


def _nanmin(v: np.ndarray) -> float:
    return float(np.nanmin(v)) if not np.isnan(v).all() else math.nan


def _nanmax(v: np.ndarray) -> float:
    return float(np.nanmax(v)) if not np.isnan(v).all() else math.nan


def _iterrows(table: Table):
    """Rows as `DataFrame.iterrows` gives them: when every column is
    numeric and one is float, every value of the row is a float."""
    cols = table.columns
    upcast = all(is_numeric(table[c]) for c in cols) and not all(
        all(isinstance(v, int) for v in table[c]) for c in cols)
    for row in table.rows():
        yield {k: float(v) for k, v in row.items()} if upcast else row


def _key(v: Any) -> str:
    return str(np.float64(v)) if isinstance(v, float) else str(v)


class QuartileTable:
    """id -> tau quartile (`quartile_lub`); `abeta`: id -> `Abeta_Covar`
    (empty without the column)."""

    def __init__(self, csv_path_or_table, id_column: str = "ADNI_ID",
                 quartile_column: str = "quartile_lub"):
        table = _table(csv_path_or_table)
        self.map: Dict[str, int] = {
            _key(r[id_column]): int(r[quartile_column])
            for r in _iterrows(table) if not is_na(r[quartile_column])}
        self.abeta: Dict[str, float] = {}
        if "Abeta_Covar" in table:
            self.abeta = {_key(r[id_column]): float(r["Abeta_Covar"])
                          for r in _iterrows(table) if not is_na(r["Abeta_Covar"])}

    def quartile(self, sid: str) -> int:
        return self.map.get(str(sid), -1)


class PredictionTable:
    """Per-subject per-ROI tau predictions with uncertainty.

    Formats accepted:
      * JSON: {id: {roi_name: {"loc": m, "std": s}, ...}}
      * JSON: {id: {"Tau_Meta": {"loc": m, "std": s}}} (meta-tau only)
      * .npy pickle of the same dict
    """

    def __init__(self, source):
        if isinstance(source, dict):
            self.table = source
        elif str(source).endswith(".npy"):
            self.table = np.load(source, allow_pickle=True)
            if isinstance(self.table, np.ndarray):
                self.table = self.table.flat[0]
        else:
            with open(source) as f:
                self.table = json.load(f)
        self.roi_names = [ROI_INDEX_TO_NAME[i] for i in ROI_INDICES]

    def __contains__(self, sid: str) -> bool:
        return str(sid) in self.table

    def merge(self, other: "PredictionTable") -> "PredictionTable":
        """Both tables' subjects; where both hold one, this table's entry."""
        merged = dict(other.table)
        merged.update(self.table)
        return PredictionTable(merged)

    def roi_arrays(self, sid: str) -> Tuple[np.ndarray, np.ndarray]:
        """Dense [R] loc/std arrays in ROI_INDICES order (NaN -> 0)."""
        r = len(self.roi_names)
        loc = np.zeros((r,), np.float32)
        std = np.zeros((r,), np.float32)
        entry = self.table.get(str(sid))
        if entry:
            for i, name in enumerate(self.roi_names):
                d = entry.get(name)
                if d:
                    loc[i] = np.nan_to_num(float(d.get("loc", 0.0)))
                    std[i] = np.nan_to_num(float(d.get("std", 0.0)))
        return loc, std

    def meta_tau(self, sid: str, key: str = "Tau_Meta",
                 field: str = "loc") -> float:
        entry: Optional[Dict[str, Any]] = self.table.get(str(sid))
        if not entry:
            return float("nan")
        if key in entry:
            v = entry[key]
            return float(v[field]) if isinstance(v, dict) else float(v)
        if "pred" in entry:
            return float(entry["pred"])
        return float("nan")
