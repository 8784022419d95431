"""CSV tables with the standard library, typed the way pandas' `read_csv`
types them, so that the port's host side reads and writes the same files
as the JAX package without pandas.

A column whose cells all parse as integers is an int column; one whose
cells parse as numbers, some of them empty or a missing-value marker, is a
float column with NaN for the missing ones (so is a column with no value
at all); any other column holds strings, with NaN for the missing cells.
An empty header cell is named "Unnamed: <position>". Floats are written as
numpy's shortest repr for their dtype (float64 for Python floats), NaN as an
empty cell, as `DataFrame.to_csv` writes them.
"""

from __future__ import annotations

import csv
import math
import re
from typing import Any, Dict, Iterable, List, Optional, Sequence

import numpy as np

# pandas' default missing-value markers
NA_VALUES = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null",
})
_INT = re.compile(r"\s*[+-]?\d+\s*")
_FLOAT = re.compile(
    r"\s*[+-]?(\d+\.?\d*([eE][+-]?\d+)?|\.\d+([eE][+-]?\d+)?|inf(inity)?)\s*",
    re.IGNORECASE)


def is_na(value: Any) -> bool:
    return value is None or (isinstance(value, float) and math.isnan(value))


def _typed(cells: Sequence[str]) -> list:
    present = [c for c in cells if c not in NA_VALUES]
    if present and len(present) == len(cells) and all(
            _INT.fullmatch(c) for c in present):
        return [int(c) for c in cells]
    if all(_FLOAT.fullmatch(c) for c in present):
        return [float("nan") if c in NA_VALUES else float(c) for c in cells]
    return [float("nan") if c in NA_VALUES else c for c in cells]


class Table:
    """Named, typed columns of equal length."""

    def __init__(self, columns: Sequence[str], data: Dict[str, list]):
        self.columns = list(columns)
        self.data = {c: list(data[c]) for c in self.columns}

    def __len__(self) -> int:
        return len(self.data[self.columns[0]]) if self.columns else 0

    def __contains__(self, column: str) -> bool:
        return column in self.data

    def __getitem__(self, column: str) -> list:
        return self.data[column]

    def rows(self) -> List[Dict[str, Any]]:
        return [{c: self.data[c][i] for c in self.columns}
                for i in range(len(self))]

    def rename(self, mapping: Dict[str, str]) -> "Table":
        columns = [mapping.get(c, c) for c in self.columns]
        return Table(columns, {mapping.get(c, c): v for c, v in self.data.items()})

    def drop(self, column: str) -> "Table":
        return Table([c for c in self.columns if c != column], self.data)


def read_csv(path: str) -> Table:
    with open(path, newline="") as f:
        lines = list(csv.reader(f))
    if not lines:
        return Table([], {})
    header = [name if name else f"Unnamed: {i}"
              for i, name in enumerate(lines[0])]
    body = [row for row in lines[1:] if row]
    cells = [[row[i] if i < len(row) else "" for row in body]
             for i in range(len(header))]
    return Table(header, {name: _typed(col) for name, col in zip(header, cells)})


def is_numeric(values: Iterable[Any]) -> bool:
    """True for an int or float column (pandas' `is_numeric_dtype`)."""
    return all(isinstance(v, (int, float, np.integer, np.floating))
               and not isinstance(v, bool) for v in values)


def to_numeric(values: Iterable[Any]) -> np.ndarray:
    """float64 values, NaN where a cell is missing or not a number
    (`pd.to_numeric(errors="coerce")`)."""
    out = []
    for v in values:
        if isinstance(v, str):
            v = float(v) if _FLOAT.fullmatch(v) else float("nan")
        out.append(float("nan") if v is None else float(v))
    return np.asarray(out, np.float64)


def nanmean(values: np.ndarray) -> float:
    """Mean over the values that are not NaN, NaN for none (pandas'
    `Series.mean`: the sum of the values with NaN set to 0, over the
    count)."""
    mask = np.isnan(values)
    count = int((~mask).sum())
    if count == 0:
        return float("nan")
    return float(np.where(mask, 0.0, values).sum() / count)


def format_column(values) -> List[str]:
    """A column's cells as `DataFrame.to_csv` writes them."""
    arr = values if isinstance(values, np.ndarray) else None
    if arr is None and is_numeric(values) and len(values):
        if all(isinstance(v, (int, np.integer)) for v in values):
            return [str(int(v)) for v in values]
        arr = np.asarray(values, np.float64)
    if arr is not None:
        if arr.dtype.kind == "f":
            text = arr.astype(str)
            text[np.isnan(arr)] = ""
            return text.tolist()
        return arr.astype(str).tolist()
    return ["" if is_na(v) else str(v) for v in values]


def write_csv(path: str, header: Optional[Sequence[str]],
              data: Sequence) -> None:
    """Write `data`, one sequence or array per column, under the header row
    `header`, or with no header row when it is None."""
    cells = [format_column(col) for col in data]
    with open(path, "w", newline="") as f:
        writer = csv.writer(f, lineterminator="\n")
        if header is not None:
            writer.writerow(list(header))
        writer.writerows(zip(*cells))


def table_from_rows(rows: Sequence[Dict[str, Any]]) -> Table:
    """`pd.DataFrame(rows)`: a column for every key of any row, in the
    order the keys first appear; a row without a key has NaN there."""
    columns = list(dict.fromkeys(k for r in rows for k in r))
    return Table(columns, {c: [r.get(c, float("nan")) for r in rows]
                           for c in columns})


def write_rows(path: str, rows: Sequence[Dict[str, Any]]) -> None:
    """Write a list of dicts (`pd.DataFrame(rows).to_csv(path,
    index=False)`)."""
    table = table_from_rows(rows)
    write_csv(path, table.columns, [table[c] for c in table.columns])
