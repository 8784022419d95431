"""The attention maps as NIfTI (counterpart of
`coma_unet_tpu/analysis/attention.py`): the model returns each attention
gate's psi map with its output, so the export is one forward and the
writes."""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

import numpy as np
import torch

from coma_unet_tpu_torch.io.volume import write_tensor_to_nii
from coma_unet_tpu_torch.models.registry import (apply_model, device_args,
                                                 eval_mode, has_attention_maps)


def export_attention_maps(model: torch.nn.Module, batch, save_path: str,
                          sample_ids: Optional[Sequence[str]] = None,
                          spacing=(2.0, 2.0, 2.0)) -> List[str]:
    """Run one forward of `batch` (arrays or tensors, moved to the model's
    device; the model in eval mode, as the JAX package's `train=False`)
    and write each level's psi map of each sample as
    `<save_path>/<sid>_attn_level{i}.nii`; returns the written paths. A
    model whose output carries no psi maps (the baselines) raises
    ValueError before anything is written."""
    if not has_attention_maps(model):
        raise ValueError(f"{type(model).__name__} returns no attention maps "
                         f"to export")
    args = device_args(model, batch)
    with eval_mode(model), torch.inference_mode():
        outs = apply_model(model, *args, with_projections=False)
    os.makedirs(save_path, exist_ok=True)
    b = args[0].shape[0]
    ids = sample_ids or [f"sample{j}" for j in range(b)]
    written = []
    for level, psi in enumerate(outs.attention):
        arr = psi.float().cpu().numpy()  # [B, 1, D, H, W]
        for j in range(b):
            sid = str(ids[j]).replace("/", "_")
            path = os.path.join(save_path, f"{sid}_attn_level{level}.nii")
            write_tensor_to_nii(np.asarray(arr[j]), path, spacing=spacing)
            written.append(path)
    return written
