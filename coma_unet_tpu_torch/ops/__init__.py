"""Tensor ops of the port. Each kernel family has a wrapper that launches a
hand-written CUDA kernel for a CUDA tensor and runs the plain PyTorch
version for a CPU tensor: the forward families `s1`, `s2`, `t2`,
`norm_act` (`FWD_FAMILIES`), the backward families `s1_dw`,
`strided_dw`, `norm_act_bwd` (`BWD_FAMILIES`), K4's two halves
`norm_stats` and `norm_apply` for the depth-sharded forward
(`SLAB_FAMILIES`) and the standalone `phase_split` (`ENTRY_FAMILIES`), each
also in its float32 form (`s1_f32` and so on: `F32_FAMILIES`,
`FWD_FAMILIES_F32`, ...), which a CUDA tensor of dtype float32 launches.
`conv3d_s1`, `conv3d_s2`, `conv3d_t2`
and `norm_act` are autograd Functions whose backward runs kernels too;
`instance_norm` and `conv3d_w64` are entry points over K4 and K1. The
per-ROI sums and SSIM of the metric suite, `gaussian_smooth` and
`resize_nearest_device` are PyTorch built-ins, as the JAX package leaves
them to XLA; `resize_nearest`, `resize_linear` and `center_pad_crop` run
on the host in numpy."""

from coma_unet_tpu_torch.ops._build import (  # noqa: F401
    BWD_FAMILIES,
    BWD_FAMILIES_F32,
    ENTRY_FAMILIES,
    ENTRY_FAMILIES_F32,
    F32_FAMILIES,
    FAMILIES,
    FWD_FAMILIES,
    FWD_FAMILIES_F32,
    LAUNCHES,
    PLAIN_ON_CPU,
    PLAIN_ON_CUDA,
    PATH_FAMILIES,
    PATH_FAMILIES_F32,
    SLAB_FAMILIES,
    SLAB_FAMILIES_F32,
    reset_counts,
)
from coma_unet_tpu_torch.ops.conv3d import (  # noqa: F401
    conv3d_s1,
    conv3d_s1_dw,
    conv3d_s1_dw_plain,
    conv3d_s1_plain,
    conv3d_w64,
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
    instance_norm,
    merge_partials,
    norm_act,
    norm_act_bwd,
    norm_act_bwd_plain,
    norm_act_forward,
    norm_act_plain,
    norm_apply,
    norm_apply_plain,
    norm_stats,
    norm_stats_plain,
)
from coma_unet_tpu_torch.ops.phase_split import (  # noqa: F401
    hsplit,
    hsplit_plain,
)
from coma_unet_tpu_torch.ops.preprocess import center_pad_crop  # noqa: F401
from coma_unet_tpu_torch.ops.resize import (  # noqa: F401
    resize_linear,
    resize_nearest,
    resize_nearest_device,
)
from coma_unet_tpu_torch.ops.roi import (  # noqa: F401
    compact_roi,
    make_roi_lut,
    paint_roi_values,
    roi_counts,
    roi_reduce,
    roi_sums,
    roi_weight_mask,
)
from coma_unet_tpu_torch.ops.smooth import gaussian_smooth  # noqa: F401
from coma_unet_tpu_torch.ops.ssim import ssim3d  # noqa: F401
