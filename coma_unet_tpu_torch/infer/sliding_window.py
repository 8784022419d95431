"""Full-volume synthesis, and sliding-window synthesis with Gaussian
overlap blending (counterpart of `coma_unet_tpu/infer/sliding_window.py`).

The volume is tiled into overlapping patches, the model's forward runs on
batches of patches, and the predictions are blended with a Gaussian
importance map and normalized, on the host in numpy as in the JAX package.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Callable, Sequence, Tuple

import numpy as np
import torch

from coma_unet_tpu_torch.models.registry import apply_model
from coma_unet_tpu_torch.utils.profiling import span


def _grid_starts(size: int, patch: int, stride: int) -> Sequence[int]:
    if size <= patch:
        return [0]
    starts = list(range(0, size - patch + 1, stride))
    if starts[-1] != size - patch:
        starts.append(size - patch)
    return starts


@lru_cache(maxsize=16)
def gaussian_importance_map(
    patch: Tuple[int, int, int], sigma_scale: float = 0.125
) -> np.ndarray:
    """MONAI-style Gaussian blending weights: peak at the patch center,
    sigma = sigma_scale * patch size per axis."""
    maps = []
    for p in patch:
        xs = np.arange(p) - (p - 1) / 2.0
        sigma = max(p * sigma_scale, 1e-3)
        maps.append(np.exp(-0.5 * (xs / sigma) ** 2))
    w = maps[0][:, None, None] * maps[1][None, :, None] * maps[2][None, None, :]
    w = w / w.max()
    return np.maximum(w, 1e-4).astype(np.float32)


def make_infer_fn(model: torch.nn.Module) -> Callable:
    """Inference forward: (mri, covars, roi_loc, roi_std, roi_compact) ->
    out [B, 1, D, H, W] f32 on the model's device, for any registry model.
    Inputs may be numpy arrays or tensors; they move to the model's
    device. Each call is recorded as the span `infer.forward`
    (`utils.profiling.span`)."""
    device = next(model.parameters()).device

    @torch.inference_mode()
    def infer(mri, covars, roi_loc, roi_std, roi_compact):
        with span("infer.forward"):
            args = [torch.as_tensor(a, device=device)
                    for a in (mri, covars, roi_loc, roi_std, roi_compact)]
            return apply_model(model, *args, with_projections=False).out

    return infer


def sliding_window_inference(
    infer_fn: Callable,
    mri: np.ndarray,
    covars: np.ndarray,
    roi_loc: np.ndarray,
    roi_std: np.ndarray,
    roi_compact: np.ndarray,
    patch_size: Tuple[int, int, int] = (128, 128, 128),
    overlap: float = 0.25,
    batch_size: int = 4,
    sigma_scale: float = 0.125,
) -> np.ndarray:
    """Synthesize a full volume larger than the training patch.

    Args:
      infer_fn: forward from `make_infer_fn` (or any callable with the same
        signature).
      mri: [1, 1, D, H, W]; roi_compact: [1, D, H, W]; covars [1, K];
        roi_loc/roi_std [1, R].

    Returns [1, 1, D, H, W] float32.
    """
    if mri.ndim != 5 or mri.shape[0] != 1:
        raise ValueError(f"mri must be [1, 1, D, H, W], got {mri.shape}")
    spatial = mri.shape[2:]
    patch = tuple(min(p, s) for p, s in zip(patch_size, spatial))
    strides = tuple(max(1, int(p * (1.0 - overlap))) for p in patch)
    grids = [
        _grid_starts(s, p, st) for s, p, st in zip(spatial, patch, strides)
    ]
    positions = [
        (z, y, x) for z in grids[0] for y in grids[1] for x in grids[2]
    ]

    weight = gaussian_importance_map(patch, sigma_scale)
    out = np.zeros((1, 1) + tuple(spatial), np.float32)
    norm = np.zeros(tuple(spatial), np.float32)

    mri = np.asarray(mri, np.float32)
    roi_compact = np.asarray(roi_compact)

    def tile(a):
        a = np.asarray(a)
        return np.repeat(a.reshape(1, a.shape[-1]), batch_size, axis=0)

    cov, loc, std = tile(covars), tile(roi_loc), tile(roi_std)
    for i in range(0, len(positions), batch_size):
        chunk = positions[i : i + batch_size]
        mris, rois = [], []
        for (z, y, x) in chunk:
            box = (slice(z, z + patch[0]), slice(y, y + patch[1]),
                   slice(x, x + patch[2]))
            mris.append(mri[(0, slice(None)) + box])
            rois.append(roi_compact[(0,) + box])
        # pad the last chunk so every call sees the same batch size
        while len(mris) < batch_size:
            mris.append(mris[-1])
            rois.append(rois[-1])
        pred = infer_fn(np.stack(mris), cov, loc, std, np.stack(rois))
        pred = np.asarray(pred.float().cpu() if torch.is_tensor(pred) else pred)
        for j, (z, y, x) in enumerate(chunk):
            out[0, 0, z : z + patch[0], y : y + patch[1], x : x + patch[2]] += (
                pred[j, 0] * weight
            )
            norm[z : z + patch[0], y : y + patch[1], x : x + patch[2]] += weight
    out[0, 0] /= np.maximum(norm, 1e-8)
    return out
