"""Tensor ops of the port. Each kernel family has a wrapper that launches a
hand-written CUDA kernel for a CUDA tensor and runs the plain PyTorch
version for a CPU tensor: the forward families `s1`, `s2`, `t2`,
`norm_act` (`FWD_FAMILIES`) and the backward families `s1_dw`,
`strided_dw`, `norm_act_bwd` (`BWD_FAMILIES`). `conv3d_s1`, `conv3d_s2`,
`conv3d_t2` and `norm_act` are autograd Functions whose backward runs
kernels too."""

from coma_unet_tpu_torch.ops._build import (  # noqa: F401
    BWD_FAMILIES,
    FAMILIES,
    FWD_FAMILIES,
    LAUNCHES,
    PLAIN_ON_CPU,
    PLAIN_ON_CUDA,
    reset_counts,
)
from coma_unet_tpu_torch.ops.conv3d import (  # noqa: F401
    conv3d_s1,
    conv3d_s1_dw,
    conv3d_s1_dw_plain,
    conv3d_s1_plain,
)
from coma_unet_tpu_torch.ops.conv3d_strided import (  # noqa: F401
    conv3d_s2,
    conv3d_s2_plain,
    conv3d_strided_dw,
    conv3d_strided_dw_plain,
    conv3d_t2,
    conv3d_t2_plain,
)
from coma_unet_tpu_torch.ops.norm_act import (  # noqa: F401
    norm_act,
    norm_act_bwd,
    norm_act_bwd_plain,
    norm_act_forward,
    norm_act_plain,
)
from coma_unet_tpu_torch.ops.roi import (  # noqa: F401
    compact_roi,
    make_roi_lut,
    paint_roi_values,
    roi_weight_mask,
)
