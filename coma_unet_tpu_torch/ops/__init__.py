"""Tensor ops of the port. The four kernel families (`s1`, `s2`, `t2`,
`norm_act`) each have a wrapper that launches a hand-written CUDA kernel for
a CUDA tensor and runs the plain PyTorch version for a CPU tensor."""

from coma_unet_tpu_torch.ops._build import (  # noqa: F401
    FAMILIES,
    LAUNCHES,
    PLAIN_ON_CPU,
    PLAIN_ON_CUDA,
    reset_counts,
)
from coma_unet_tpu_torch.ops.conv3d import conv3d_s1, conv3d_s1_plain  # noqa: F401
from coma_unet_tpu_torch.ops.conv3d_strided import (  # noqa: F401
    conv3d_s2,
    conv3d_s2_plain,
    conv3d_t2,
    conv3d_t2_plain,
)
from coma_unet_tpu_torch.ops.norm_act import norm_act, norm_act_plain  # noqa: F401
from coma_unet_tpu_torch.ops.roi import (  # noqa: F401
    compact_roi,
    make_roi_lut,
    paint_roi_values,
)
