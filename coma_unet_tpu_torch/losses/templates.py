"""Quartile templates for the N-pair decoder-supervision loss (counterpart
of `coma_unet_tpu/losses/templates.py`): the 8 mean-tau template volumes
(abeta +/- x quartile 1-4) loaded, 2 mm-resampled and flattened into
embedding vectors; a sample's matching template is its positive and the
other 7 its negatives."""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np

from coma_unet_tpu_torch.io.volume import load_nifti_vol
from coma_unet_tpu_torch.ops.preprocess import center_pad_crop


def load_quartile_templates(pos_paths: Sequence[str], neg_paths: Sequence[str],
                            target: Sequence[int] = (128, 128, 128),
                            resize: bool = True) -> Dict[str, np.ndarray]:
    """{'pos': [4, V], 'neg': [4, V]}: each template volume padded or
    cropped to `target` and flattened, float32."""

    def _load(paths):
        return np.stack([
            center_pad_crop(load_nifti_vol(p, resize=resize), tuple(target))
            .reshape(-1).astype(np.float32) for p in paths])

    return {"pos": _load(pos_paths), "neg": _load(neg_paths)}


def select_npair_templates(templates: Dict[str, np.ndarray], abeta: float,
                           quartile: int) -> Tuple[np.ndarray, np.ndarray]:
    """(the positive template [V], the negatives [7, V]) of one sample: the
    template of its abeta status and quartile (1-4) is the positive; the
    other 3 of its status and all 4 of the other are the negatives."""
    q = int(quartile) - 1
    own, other = ("pos", "neg") if abeta == 1 else ("neg", "pos")
    negs = np.concatenate([np.delete(templates[own], q, axis=0), templates[other]],
                          axis=0)
    return templates[own][q], negs
