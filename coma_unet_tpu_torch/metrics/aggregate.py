"""Host-side metric accumulation across evaluation batches, with the
overall / Abeta+ / Abeta- split (the port's own copy of
`coma_unet_tpu/metrics/aggregate.py`).

The eval step emits per-sample partials (`voxel_metrics`, `roi_metrics`);
the accumulator moves them to the host once per batch, sums them, and
finalizes MAE / MAPE% / RSE / RRMSE / SSIM / PSNR / per-ROI MAE, MAPE, RSE,
wRRMSE and per-ROI Pearson r.
"""

from __future__ import annotations

from dataclasses import dataclass
import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from coma_unet_tpu_torch.data.table import write_csv


@dataclass
class MetricResults:
    mae: float
    mape: float
    rse: float
    rrmse: float
    ssim: float
    roi_maes: np.ndarray
    roi_mapes: np.ndarray
    roi_rses: np.ndarray
    roi_wrrmses: np.ndarray
    roi_correlations: np.ndarray
    num_samples: int
    psnr: float = 0.0

    def as_tuple(self):
        """The reference's 10-tuple ordering."""
        return (
            self.mae, self.mape, self.rse, self.rrmse, self.ssim,
            self.roi_maes, self.roi_mapes, self.roi_rses, self.roi_wrrmses,
            self.roi_correlations,
        )


def _host(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


class _Split:
    def __init__(self, num_rois: int):
        self.n = 0
        self.mae = 0.0
        self.mape_num = 0.0
        self.mape_cnt = 0.0
        self.rse = 0.0
        self.rrmse = 0.0
        self.ssim = 0.0
        self.psnr = 0.0
        self.roi_mae = np.zeros(num_rois)
        self.roi_mape_num = np.zeros(num_rois)
        self.roi_mape_cnt = np.zeros(num_rois)
        self.roi_rse = np.zeros(num_rois)
        self.roi_wrrmse = np.zeros(num_rois)
        self.pred_means: List[np.ndarray] = []
        self.gt_means: List[np.ndarray] = []
        self.sample_ids: List[str] = []

    def update(self, vox, roi, sel: np.ndarray, ids: Optional[Sequence[str]]):
        if not sel.any():
            return
        self.n += int(sel.sum())
        self.mae += float(vox["mae"][sel].sum())
        self.mape_num += float(vox["mape_num"][sel].sum())
        self.mape_cnt += float(vox["mape_cnt"][sel].sum())
        self.rse += float(vox["rse"][sel].sum())
        self.rrmse += float(np.nansum(vox["rrmse"][sel]))
        if "ssim" in vox:
            self.ssim += float(vox["ssim"][sel].sum())
        if "psnr" in vox:
            self.psnr += float(vox["psnr"][sel].sum())
        self.roi_mae += roi["mae"][sel].sum(axis=0)
        self.roi_mape_num += roi["mape_num"][sel].sum(axis=0)
        self.roi_mape_cnt += roi["mape_cnt"][sel].sum(axis=0)
        self.roi_rse += roi["rse"][sel].sum(axis=0)
        self.roi_wrrmse += roi["wrrmse"][sel].sum(axis=0)
        self.pred_means.append(roi["pred_mean"][sel])
        self.gt_means.append(roi["gt_mean"][sel])
        if ids is not None:
            self.sample_ids.extend(np.asarray(ids)[sel].tolist())

    def finalize(self) -> MetricResults:
        n = max(self.n, 1)
        r = len(self.roi_mae)
        pred = (np.concatenate(self.pred_means) if self.pred_means
                else np.zeros((0, r)))
        gt = (np.concatenate(self.gt_means) if self.gt_means
              else np.zeros((0, r)))
        corr = np.full(r, np.nan)
        if pred.shape[0] >= 2:
            for i in range(r):
                with np.errstate(invalid="ignore"):
                    corr[i] = np.corrcoef(pred[:, i], gt[:, i])[0, 1]
        return MetricResults(
            mae=self.mae / n,
            mape=self.mape_num / max(self.mape_cnt, 1.0),
            rse=self.rse / n,
            rrmse=self.rrmse / n,
            ssim=self.ssim / n,
            psnr=self.psnr / n,
            roi_maes=self.roi_mae / n,
            roi_mapes=100.0 * self.roi_mape_num / np.maximum(self.roi_mape_cnt, 1.0),
            roi_rses=self.roi_rse / n,
            roi_wrrmses=self.roi_wrrmse / n,
            roi_correlations=corr,
            num_samples=self.n,
        )


class MetricAccumulator:
    """Three-way (overall / pos / neg) accumulator.

    `update(vox, roi, abeta, sample_ids, valid)` takes the outputs of
    `voxel_metrics` / `roi_metrics` (tensors on any device, or arrays) and
    the per-sample abeta status (1 = Abeta+, 0 = Abeta-, -1 = unknown);
    `valid` flags the loader's wrap-padded rows, which count nowhere.
    """

    def __init__(self, num_rois: int):
        self.num_rois = num_rois
        self.overall = _Split(num_rois)
        self.pos = _Split(num_rois)
        self.neg = _Split(num_rois)
        self._voxel_rel_sum: Optional[np.ndarray] = None

    def update(self, vox: Dict, roi: Dict, abeta, sample_ids=None, valid=None):
        vox = {k: _host(v) for k, v in vox.items()}
        roi = {k: _host(v) for k, v in roi.items()}
        abeta = _host(abeta).reshape(-1)
        b = abeta.shape[0]
        valid = (np.ones(b, dtype=bool) if valid is None
                 else _host(valid).reshape(-1).astype(bool))
        if "abs_rel_vol" in vox:
            s = vox["abs_rel_vol"][valid].sum(axis=0).squeeze()
            self._voxel_rel_sum = (s if self._voxel_rel_sum is None
                                   else self._voxel_rel_sum + s)
        self.overall.update(vox, roi, valid, sample_ids)
        self.pos.update(vox, roi, valid & (abeta == 1), sample_ids)
        self.neg.update(vox, roi, valid & (abeta == 0), sample_ids)

    def results(self):
        return (
            self.overall.finalize(),
            self.pos.finalize(),
            self.neg.finalize(),
        )

    def voxel_mape_grid(self) -> Optional[np.ndarray]:
        """100 * mean relative error per voxel (the grid that adaptive voxel
        weights read)."""
        if self._voxel_rel_sum is None or self.overall.n == 0:
            return None
        return 100.0 * self._voxel_rel_sum / self.overall.n

    def save_matrices(self, save_path: str, prefix: str = "") -> None:
        """Write the pred and gt ROI-mean matrices, [R, N], as CSVs with
        one column per sample: `{prefix}{tag}pred_means.csv` and
        `{prefix}{tag}gt_means.csv` for the tags "", "pos_" and "neg_".
        The header row holds the sample ids; a split without ids has no
        header row."""
        os.makedirs(save_path, exist_ok=True)
        for split, tag in ((self.overall, ""), (self.pos, "pos_"),
                           (self.neg, "neg_")):
            if not split.pred_means:
                continue
            header = split.sample_ids if split.sample_ids else None
            for name, means in (("pred", split.pred_means),
                                ("gt", split.gt_means)):
                per_sample = np.concatenate(means)  # [N, R]: the columns
                write_csv(os.path.join(save_path, f"{prefix}{tag}{name}_means.csv"),
                          header, list(per_sample))
