"""Inference entry points of the port."""

from coma_unet_tpu_torch.infer.sliding_window import (  # noqa: F401
    gaussian_importance_map,
    make_infer_fn,
    sliding_window_inference,
)
