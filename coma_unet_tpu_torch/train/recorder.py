"""Metric recording: per-epoch CSV columns and the progression charts
(counterpart of `coma_unet_tpu/train/recorder.py`).

Each validation adds an `epoch_{E}` column to
`validation_metric_results/{roi_corr, roi_mapes, roi_maes, avg_corr,
roi_rse, roi_rrmses, mape, mae}.csv`, read and written with the `csv`
module (a leading `Unnamed: 0` index column is dropped). The charts are
drawn by matplotlib, imported inside `_plt` only: where it is missing, the
first chart logs once that no PNGs are written, and every chart is skipped.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from coma_unet_tpu_torch.data.table import read_csv, write_csv
from coma_unet_tpu_torch.metrics.aggregate import MetricResults

log = logging.getLogger(__name__)

CSV_FILES = ("roi_corr", "roi_mapes", "roi_maes", "avg_corr", "roi_rse",
             "roi_rrmses", "mape", "mae")


class MetricRecorder:
    """Appends one column per validation epoch to each metric CSV and
    redraws the progression charts."""

    def __init__(self, save_path: str, metric_types: str = ""):
        self.save_path = save_path
        self.prefix = metric_types
        self.dir = os.path.join(save_path, "validation_metric_results")
        os.makedirs(self.dir, exist_ok=True)
        self.history: Dict[str, List] = {k: [] for k in (
            "mae", "mape", "rse", "rrmse", "ssim", "psnr", "avg_corr",
            "roi_maes", "roi_mapes", "roi_rses", "roi_wrrmses", "roi_corrs",
        )}
        self.epochs: List[int] = []

    def _append_col(self, name: str, value, epoch: int) -> None:
        path = os.path.join(self.dir, f"{self.prefix}{name}.csv")
        arr = np.atleast_1d(np.asarray(value, np.float64))
        columns: List[str] = []
        data: Dict[str, object] = {}
        if os.path.exists(path):
            table = read_csv(path)
            if "Unnamed: 0" in table:
                table = table.drop("Unnamed: 0")
            columns, data = table.columns, dict(table.data)
            if columns and len(table) != len(arr):
                raise ValueError(f"{path}: {len(table)} rows, the new column "
                                 f"has {len(arr)}")
        col = f"epoch_{epoch}"
        if col not in data:
            columns = columns + [col]
        data[col] = arr
        write_csv(path, columns, [data[c] for c in columns])

    def record(self, results: MetricResults, epoch: int) -> None:
        avg_corr = float(np.mean(np.nan_to_num(results.roi_correlations, nan=0.0)))
        self.epochs.append(epoch)
        h = self.history
        h["mae"].append(results.mae)
        h["mape"].append(results.mape)
        h["rse"].append(results.rse)
        h["rrmse"].append(results.rrmse)
        h["ssim"].append(results.ssim)
        h["psnr"].append(results.psnr)
        h["avg_corr"].append(avg_corr)
        h["roi_maes"].append(results.roi_maes)
        h["roi_mapes"].append(results.roi_mapes)
        h["roi_rses"].append(results.roi_rses)
        h["roi_wrrmses"].append(results.roi_wrrmses)
        h["roi_corrs"].append(np.nan_to_num(results.roi_correlations, nan=0.0))

        self._append_col("roi_corr", results.roi_correlations, epoch)
        self._append_col("roi_mapes", results.roi_mapes, epoch)
        self._append_col("roi_maes", results.roi_maes, epoch)
        self._append_col("avg_corr", avg_corr, epoch)
        self._append_col("roi_rse", results.roi_rses, epoch)
        self._append_col("roi_rrmses", results.roi_wrrmses, epoch)
        self._append_col("mape", results.mape, epoch)
        self._append_col("mae", results.mae, epoch)

    def plot(self) -> None:
        """Redraw val_MAE.png, val_MAPE.png, ... and the per-ROI progression
        and box-plot charts."""
        xs = np.asarray(self.epochs)
        for key, title, ylabel in (
            ("mae", "Mean Absolute Error", "MAE"),
            ("mape", "Mean Absolute Percent Error", "MAPE"),
            ("rse", "Relative Squared Error", "RSE"),
            ("rrmse", "RRMSE", "RRMSE"),
            ("ssim", "SSIM", "SSIM"),
            ("psnr", "PSNR", "PSNR"),
            ("avg_corr", "Averaged ROI Corr Mean", "Average ROI Corr Mean"),
        ):
            metric_graph(xs, self.history[key], title, "Epochs", ylabel,
                         os.path.join(self.save_path,
                                      f"{self.prefix}val_{ylabel.replace(' ', '_')}"))
        for key, name in (("roi_maes", "MAE"), ("roi_mapes", "MAPE"),
                          ("roi_rses", "RSE"), ("roi_wrrmses", "RRMSE")):
            if self.history[key]:
                plot_progression_chart(
                    np.stack(self.history[key]), xs,
                    os.path.join(self.save_path,
                                 f"{self.prefix}val_ROI_{name}s_progression"),
                    name=name)
        if self.history["roi_corrs"]:
            boxplot_roi_value_progression(
                np.stack(self.history["roi_corrs"]), xs, "Correlation",
                os.path.join(self.save_path, f"{self.prefix}val_ROI_corr"))


# ---------------------------------------------------------------------------
# charts (matplotlib PNGs on the host)
# ---------------------------------------------------------------------------

# the message of matplotlib's import error, once it failed: only the text,
# since the exception's traceback would keep the caller's frames (a training
# run's model and optimizer) alive
_NO_MATPLOTLIB: list = []


def _plt():
    """matplotlib's pyplot on the Agg backend, or None where matplotlib
    does not import (logged once)."""
    if _NO_MATPLOTLIB:
        return None
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError as e:
        _NO_MATPLOTLIB.append(str(e))
        log.warning("matplotlib does not import (%s): no charts (PNGs) are "
                    "written", e)
        return None
    return plt


def loss_graph(series: Sequence[Sequence[float]], path: str,
               labels: Optional[Sequence[str]] = None) -> None:
    plt = _plt()
    if plt is None:
        return
    fig, ax = plt.subplots(figsize=(8, 5))
    for i, ys in enumerate(series):
        if len(ys) == 0:
            continue
        ax.plot(np.arange(len(ys)), ys,
                label=labels[i] if labels else f"series{i}")
    ax.set_xlabel("Epochs")
    ax.set_ylabel("Loss")
    ax.legend()
    fig.savefig(path + ".png", dpi=100, bbox_inches="tight")
    plt.close(fig)


def metric_graph(x, y, title: str, xlabel: str, ylabel: str, path: str) -> None:
    plt = _plt()
    if plt is None:
        return
    fig, ax = plt.subplots(figsize=(8, 5))
    ax.plot(np.asarray(x)[: len(y)], y, marker="o")
    ax.set_title(title)
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    fig.savefig(path + ".png", dpi=100, bbox_inches="tight")
    plt.close(fig)


def plot_progression_chart(arr: np.ndarray, x, path: str,
                           name: str = "MAE") -> None:
    """Per-ROI metric progression: one line per ROI over epochs."""
    plt = _plt()
    if plt is None:
        return
    fig, ax = plt.subplots(figsize=(10, 6))
    for r in range(arr.shape[1]):
        ax.plot(np.asarray(x)[: arr.shape[0]], arr[:, r], alpha=0.5, lw=0.8)
    ax.set_xlabel("Epochs")
    ax.set_ylabel(name)
    ax.set_title(f"Per-ROI {name} progression")
    fig.savefig(path + ".png", dpi=100, bbox_inches="tight")
    plt.close(fig)


def boxplot_roi_value_progression(arr: np.ndarray, x, label: str,
                                  path: str) -> None:
    plt = _plt()
    if plt is None:
        return
    fig, ax = plt.subplots(figsize=(10, 6))
    ax.boxplot([arr[i] for i in range(arr.shape[0])],
               tick_labels=[str(int(e)) for e in np.asarray(x)[: arr.shape[0]]])
    ax.set_xlabel("Epochs")
    ax.set_ylabel(label)
    fig.savefig(path + ".png", dpi=100, bbox_inches="tight")
    plt.close(fig)


def scatter_corr(x, y, save_path: str) -> None:
    """Prediction against ground truth, with the identity line."""
    plt = _plt()
    if plt is None:
        return
    fig, ax = plt.subplots(figsize=(6, 6))
    ax.scatter(x, y, s=8, alpha=0.6)
    lo = min(np.min(x), np.min(y))
    hi = max(np.max(x), np.max(y))
    ax.plot([lo, hi], [lo, hi], "k--", lw=1)
    ax.set_xlabel("ground truth")
    ax.set_ylabel("prediction")
    fig.savefig(save_path + ".png", dpi=100, bbox_inches="tight")
    plt.close(fig)
