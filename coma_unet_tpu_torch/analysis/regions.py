"""Per-ROI statistics of volumes (counterpart of
`coma_unet_tpu/analysis/regions.py`, without pandas): one ROI's summary,
one sample's table of them, and the `roi_info_suvr.csv`-style table of
mean SUVR per sample and ROI.

The tables are the port's `data/table.Table` (named columns, one row per
ROI or per sample) where the JAX package returns a DataFrame; the CSV is
byte for byte what `DataFrame.to_csv` writes for the JAX package's frame.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from coma_unet_tpu_torch.config import ROI_INDEX_TO_NAME, ROI_INDICES
from coma_unet_tpu_torch.data.table import Table, write_csv

_STATS = ("mean", "std", "min", "max", "voxels")


def analyze_region(volume: np.ndarray, roi: np.ndarray,
                   roi_index: int) -> Dict[str, float]:
    """{mean, std (ddof 0), min, max, voxels} of `volume` where
    `roi == roi_index`; NaN and 0 voxels for an empty ROI."""
    vals = np.asarray(volume)[roi == roi_index]
    if vals.size == 0:
        return {"mean": float("nan"), "std": float("nan"),
                "min": float("nan"), "max": float("nan"), "voxels": 0}
    return {"mean": float(vals.mean()), "std": float(vals.std()),
            "min": float(vals.min()), "max": float(vals.max()),
            "voxels": int(vals.size)}


def analyze_sample(volume: np.ndarray, roi: np.ndarray,
                   roi_indices: Sequence[int] = ROI_INDICES) -> Table:
    """One row per ROI in `roi_indices` order, columns mean, std, min,
    max, voxels, roi_index and roi_name (the DataFrame's columns)."""
    rows = []
    for idx in roi_indices:
        row = analyze_region(volume, roi, idx)
        row["roi_index"] = idx
        row["roi_name"] = ROI_INDEX_TO_NAME.get(idx, str(idx))
        rows.append(row)
    columns = list(_STATS) + ["roi_index", "roi_name"]
    return Table(columns, {c: [r[c] for r in rows] for c in columns})


def create_roi_suvr_table(samples: Sequence[Dict],
                          roi_indices: Sequence[int] = ROI_INDICES,
                          volume_key: str = "tau",
                          out_csv: Optional[str] = None) -> Table:
    """One row per sample: its id (`sample_id`, "" when missing) in the
    column "sample_id", then one column per ROI of its mean `volume_key`
    inside the ROI (NaN for an empty one), named by `ROI_INDEX_TO_NAME`.
    `out_csv` gets the JAX package's CSV: the ids as an index column with
    an empty header cell, floats as their shortest repr, NaN empty."""
    names = [ROI_INDEX_TO_NAME.get(i, str(i)) for i in roi_indices]
    cols: Dict[str, list] = {name: [] for name in names}
    ids = []
    for s in samples:
        vol = np.asarray(s[volume_key]).squeeze()
        roi = np.asarray(s["roi"]).squeeze()
        ids.append(s.get("sample_id", ""))
        for i, name in zip(roi_indices, names):
            mask = roi == i
            cols[name].append(float(vol[mask].mean()) if mask.any()
                              else float("nan"))
    if out_csv:
        write_csv(out_csv, [""] + names, [ids] + [cols[n] for n in names])
    return Table(["sample_id"] + names, {"sample_id": ids, **cols})
