"""Batching and prefetching on the host (counterpart of
`coma_unet_tpu/data/pipeline.py`).

A thread pool loads the samples of a batch concurrently (the native NIfTI
reader runs outside the GIL), a producer thread collates whole batches as
numpy and stages up to `prefetch` of them ahead of the consumer, so the
next batch's IO overlaps the current step. For a triplet dataset (one with
`draw`) a pass draws every sample's partners when it starts, in the pass's
index order, before any is read: the same seed then gives the same
partners whatever the number of workers, and a pass cut short (the
training loop's first batch) draws what a whole one does.
The consumer moves a batch to the device (`batch_to_device`); a
`device_put` hook, run in the producer thread, may prepare it for that (the
training loop pins its memory there). A rank of a data-parallel group reads
only its rows of each global batch (`shard`).
"""

from __future__ import annotations

import functools
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from coma_unet_tpu_torch.config import ROI_INDICES
from coma_unet_tpu_torch.data.covariates import PredictionTable
from coma_unet_tpu_torch.utils.profiling import span

# batch keys that stay on the host
HOST_KEYS = ("sample_ids", "tau_paths", "valid")

_LUT_CACHE: Dict[tuple, np.ndarray] = {}
_LUT_SIZE = 4096


def _roi_lut_np(roi_indices=ROI_INDICES) -> np.ndarray:
    key = tuple(roi_indices)
    if key not in _LUT_CACHE:
        lut = np.zeros((_LUT_SIZE,), np.int32)
        for i, idx in enumerate(roi_indices):
            if not 0 <= idx < _LUT_SIZE:
                raise ValueError(f"ROI label {idx} out of LUT range [0,{_LUT_SIZE})")
            lut[idx] = i + 1
        _LUT_CACHE[key] = lut
    return _LUT_CACHE[key]


def compact_roi_np(roi: np.ndarray, roi_indices=ROI_INDICES) -> np.ndarray:
    """Raw ROI labels -> compact ids in [0, R] (0 = background), int32."""
    lut = _roi_lut_np(roi_indices)
    idx = np.clip(roi.astype(np.int64), 0, lut.shape[0] - 1)
    return lut[idx].astype(np.int32)


def _stack_flat(samples: List[Dict], predictions: Optional[PredictionTable],
                prefix: str = "", roi_indices=ROI_INDICES) -> Dict[str, np.ndarray]:
    out = {"mri": np.stack([s["mri"] for s in samples]).astype(np.float32)}
    if "tau" in samples[0]:
        out["tau"] = np.stack([s["tau"] for s in samples]).astype(np.float32)
    roi = np.stack([s["roi"][0] for s in samples])
    out["roi_compact"] = compact_roi_np(roi, roi_indices)
    if "covars" in samples[0]:
        out["covars"] = np.stack([np.asarray(s["covars"], np.float32).reshape(-1)
                                  for s in samples])
        out["abeta"] = np.asarray([s.get("abeta", -1.0) for s in samples],
                                  np.float32)
    r = len(roi_indices)
    locs = np.zeros((len(samples), r), np.float32)
    stds = np.zeros((len(samples), r), np.float32)
    if predictions is not None:
        for i, s in enumerate(samples):
            sid = s.get("sample_id")
            if sid is not None and sid in predictions:
                locs[i], stds[i] = predictions.roi_arrays(sid)
    out["roi_loc"] = locs
    out["roi_std"] = stds
    return {prefix + k: v for k, v in out.items()}


def collate(samples: List[Dict], predictions: Optional[PredictionTable] = None,
            with_triplets: bool = False, roi_indices=ROI_INDICES
            ) -> Dict[str, np.ndarray]:
    """Samples -> the train step's batch dict: {mri, tau, roi_compact,
    covars, abeta, roi_loc, roi_std, sample_ids, tau_paths} of the samples,
    or of their anchors where they nest; with `with_triplets`, nested
    samples add the pos_* and neg_* mirrors of their partners (the tCDS
    loss)."""
    nested = "anchor" in samples[0]
    anchors = [s["anchor"] if nested else s for s in samples]
    batch = _stack_flat(anchors, predictions, roi_indices=roi_indices)
    batch["sample_ids"] = [s.get("sample_id", "") for s in anchors]
    batch["tau_paths"] = [s.get("tau_path", "") for s in anchors]
    if nested and with_triplets:
        for role in ("pos", "neg"):
            batch.update(_stack_flat([s[role] for s in samples], predictions,
                                     role + "_", roi_indices))
    return batch


def shard_rows(n: int, rank: int, size: int) -> slice:
    """Rank `rank`'s rows [r*n/N, (r+1)*n/N) of a global batch of `n`
    split over `size` ranks."""
    if n % size:
        raise ValueError(f"a batch of {n} rows does not split over {size} ranks")
    b = n // size
    return slice(rank * b, (rank + 1) * b)


def pin_batch(batch: Dict) -> Dict:
    """The batch's arrays as tensors in pinned host memory, so that the
    copy to the card can run asynchronously (`non_blocking=True`)."""
    return {k: v if k in HOST_KEYS or not isinstance(v, np.ndarray)
            else torch.from_numpy(v).pin_memory() for k, v in batch.items()}


def batch_to_device(batch: Dict, device: torch.device,
                    skip: Iterable[str] = HOST_KEYS) -> Dict[str, torch.Tensor]:
    """The batch's arrays on `device` (the host keys left out). Pinned
    tensors are copied asynchronously. Recorded as the span
    `data.to_device` (`utils.profiling.span`)."""
    with span("data.to_device"):
        return {k: torch.as_tensor(v).to(device, non_blocking=True)
                for k, v in batch.items() if k not in skip}


def _load_drawn(dataset, with_partners: bool, job) -> Dict:
    idx, partners = job
    return dataset.load(idx, partners if with_partners else None)


class DataLoader:
    """Threaded, double-buffered batch loader.

    Args:
      dataset: indexable dataset returning sample dicts.
      batch_size: samples per batch; the last partial batch is dropped when
        `drop_last`, else padded by wrapping around, its padded rows
        flagged False in the batch's `valid`.
      sampler: iterable of indices; default range(len(dataset)).
      predictions: PredictionTable for the roi_loc/roi_std inputs.
      with_triplets: batches of a triplet dataset carry the pos_*/neg_*
        mirrors (the tCDS loss); without it only the anchors are read.
      shuffle, seed: each pass shuffles with
        `np.random.default_rng(seed + epoch)`, the epoch counting passes.
      num_workers: loader threads.
      prefetch: batches staged ahead.
      device_put: optional function applied to each collated batch in the
        producer thread.
      shard: (rank, size) of a data-parallel group: the loader reads only
        the rank's rows [r*b/N, (r+1)*b/N) of each global batch, which has
        the single-process loader's order, shuffle, wrap-pad and triplet
        partners; `valid` is sliced to match.
    """

    def __init__(self, dataset, batch_size: int,
                 sampler: Optional[Iterable[int]] = None,
                 predictions: Optional[PredictionTable] = None,
                 with_triplets: bool = False,
                 shuffle: bool = False, seed: int = 0, num_workers: int = 4,
                 prefetch: int = 2, drop_last: bool = False,
                 device_put: Optional[Callable] = None,
                 roi_indices=ROI_INDICES, shard: Tuple[int, int] = (0, 1)):
        self.dataset = dataset
        self.batch_size = batch_size
        self.sampler = sampler
        self.predictions = predictions
        self.with_triplets = with_triplets
        self.shuffle = shuffle
        self.seed = seed
        self.num_workers = max(1, num_workers)
        self.prefetch = max(1, prefetch)
        self.drop_last = drop_last
        self.device_put = device_put
        self.roi_indices = roi_indices
        self.shard = (int(shard[0]), int(shard[1]))
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        """The pass count that the next pass shuffles with. For a triplet
        dataset the partners of the passes skipped are drawn (not read),
        so its generator stands where it would after them."""
        draw = getattr(self.dataset, "draw", None)
        if draw is not None:
            for skipped in range(self._epoch, epoch):
                for b in self._batches(skipped)[0]:
                    for i in b:
                        draw(i)
        self._epoch = epoch

    def _batches(self, epoch: int) -> Tuple[List[List[int]], List[int]]:
        """The index batches of pass `epoch` and each one's count of valid
        rows: the last partial batch dropped when `drop_last`, else padded
        by wrapping around."""
        idxs = (list(self.sampler) if self.sampler is not None
                else list(range(len(self.dataset))))
        if self.shuffle:
            rng = np.random.default_rng(self.seed + epoch)
            idxs = [idxs[i] for i in rng.permutation(len(idxs))]
        batches = [idxs[i : i + self.batch_size]
                   for i in range(0, len(idxs), self.batch_size)]
        if batches and self.drop_last and len(batches[-1]) < self.batch_size:
            batches.pop()
        valid_counts = [len(b) for b in batches]
        if (batches and not self.drop_last and len(batches[-1]) < self.batch_size
                and len(idxs) >= self.batch_size):
            need = self.batch_size - len(batches[-1])
            batches[-1] = batches[-1] + idxs[:need]
        return batches, valid_counts

    def __len__(self) -> int:
        n = (len(list(self.sampler)) if self.sampler is not None
             else len(self.dataset))
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self):
        batches, valid_counts = self._batches(self._epoch)
        self._epoch += 1
        if not batches:
            return
        ds = self.dataset
        jobs, load = batches, ds.__getitem__
        if hasattr(ds, "draw"):
            # every partner of the pass, in index order, before any read
            jobs = [[(i, ds.draw(i)) for i in b] for b in batches]
            load = functools.partial(_load_drawn, ds, self.with_triplets)

        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for b, n_valid in zip(jobs, valid_counts):
                        rows = shard_rows(len(b), *self.shard)
                        samples = list(pool.map(load, b[rows]))
                        batch = collate(samples, self.predictions,
                                        self.with_triplets, self.roi_indices)
                        batch["valid"] = (np.arange(len(b)) < n_valid)[rows]
                        if self.device_put is not None:
                            batch = self.device_put(batch)
                        if not put(batch):
                            return
                put(None)
            except Exception as e:  # handed to the consumer, which raises it
                put(e)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                item = out_q.get()
                if item is None:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
