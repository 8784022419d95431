"""Evaluation metrics of the port (counterpart of `coma_unet_tpu/metrics/`):
per-sample voxel and per-ROI metrics on the device, and the host-side
accumulator with the overall / Abeta+ / Abeta- split."""

from coma_unet_tpu_torch.metrics.aggregate import (  # noqa: F401
    MetricAccumulator,
    MetricResults,
)
from coma_unet_tpu_torch.metrics.roi import roi_metrics  # noqa: F401
from coma_unet_tpu_torch.metrics.voxel import voxel_metrics  # noqa: F401
