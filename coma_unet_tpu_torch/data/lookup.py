"""Lookup-CSV and subject-id bookkeeping (counterpart of
`coma_unet_tpu/data/lookup.py`, without pandas).

The split lookup CSVs have `MRI`, `tau` and `roi` path columns; subject ids
are parsed out of xnat-style paths; a denylist of faulty samples and a
holdout list filter samples; `create_splits_lookup_tables` writes each
fold's test and training lookup CSVs.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Iterable, List, Sequence, Union

from coma_unet_tpu_torch.data.table import (Table, read_csv, table_from_rows,
                                            write_csv)

# faulty samples that `remove_invalid` drops by default; extend via config
INVALID_IDS: tuple = ()


def extract_id(path: str) -> str:
    """Subject id from an xnat-style path: .../a4/<BID>/...,
    .../scan/<id>/<session>/..., .../adni/<PTID>/<session>/...,
    .../ucsf/<id>/..., .../processed/<id>/..., .../outputs/<id>/...; else
    `get_id_from_path`."""
    tokens = [t for t in path.split("/") if t]
    for marker in ("a4", "ucsf", "processed", "outputs"):
        if marker in tokens:
            i = tokens.index(marker)
            if i + 1 < len(tokens):
                return tokens[i + 1]
    for marker in ("scan", "adni"):
        if marker in tokens:
            i = tokens.index(marker)
            return "/".join(tokens[i + 1 : i + 3])
    return get_id_from_path(path)


def get_id_from_path(path: str) -> str:
    """The 4th-from-last path component, joined with the session dir when
    it looks like an ADNI PTID."""
    chunks = [t for t in path.split("/") if t]
    if len(chunks) < 4:
        return chunks[0] if chunks else path
    id_chunk = chunks[-4]
    if "-" in id_chunk:
        return os.path.join(id_chunk, chunks[-3])
    return id_chunk


def load_lookup_csv(path_or_rows: Union[str, Sequence[Dict[str, Any]]],
                    require_columns: Sequence[str] = ("MRI", "tau", "roi"),
                    drop_missing_files: bool = True) -> List[Dict[str, Any]]:
    """A split lookup CSV (or a list of row dicts) as row dicts, without
    the rows whose MRI file is missing."""
    if isinstance(path_or_rows, (str, os.PathLike)):
        table = read_csv(os.fspath(path_or_rows))
        columns, rows = table.columns, table.rows()
    else:
        rows = [dict(r) for r in path_or_rows]
        columns = list(rows[0]) if rows else []
    for c in require_columns:
        if c not in columns:
            raise ValueError(f"lookup table missing column {c!r}")
    if drop_missing_files:
        rows = [r for r in rows
                if isinstance(r["MRI"], str) and os.path.isfile(r["MRI"])]
    return rows


def filter_for_holdout(ids: Iterable[str],
                       holdout_ids: Sequence[str]) -> List[bool]:
    """Keep-mask that excludes the holdout subjects."""
    hs = set(holdout_ids)
    return [i not in hs for i in ids]


def remove_invalid(ids: Iterable[str],
                   invalid: Sequence[str] = INVALID_IDS) -> List[str]:
    """`ids` without the denylisted faulty samples."""
    bad = set(invalid)
    return [i for i in ids if i not in bad]


def create_splits_lookup_tables(all_rows: Union[Table, Sequence[Dict[str, Any]]],
                                fold_ids: Sequence[Sequence[str]],
                                out_dir: str, id_column: str = "tau") -> None:
    """For fold k (from 1), `test_lookup_{k}.csv` with the rows whose
    `extract_id(row[id_column])` is in `fold_ids[k - 1]` and
    `training_lookup_{k}.csv` with the others, in `all_rows`' order and
    columns (a `Table`, or row dicts as `pd.DataFrame(rows)` reads
    them), written as `DataFrame.to_csv(index=False)` writes them."""
    if not isinstance(all_rows, Table):
        all_rows = table_from_rows(list(all_rows))
    os.makedirs(out_dir, exist_ok=True)
    ids = [extract_id(p) for p in all_rows[id_column]]
    for k, test_ids in enumerate(fold_ids):
        test = set(test_ids)
        in_test = [i in test for i in ids]
        for name, keep in (("test", in_test), ("training", [not t for t in in_test])):
            write_csv(os.path.join(out_dir, f"{name}_lookup_{k + 1}.csv"),
                      all_rows.columns,
                      [[v for v, m in zip(all_rows[c], keep) if m]
                       for c in all_rows.columns])
