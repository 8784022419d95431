"""Training losses of the port (counterpart of `coma_unet_tpu/losses/`)."""

from coma_unet_tpu_torch.losses.composite import (  # noqa: F401
    GenerativeContrastiveLoss,
    LossOutputs,
)
from coma_unet_tpu_torch.losses.contrastive import (  # noqa: F401
    cluster_npair_loss,
    heteroscedastic_loss,
    npair_loss,
    rnc_loss,
    triplet_loss,
    truncated_cds,
)
from coma_unet_tpu_torch.losses.roi_losses import (  # noqa: F401
    make_voxel_weights,
    roi_mse,
    roi_rrmse,
    roi_rse,
    update_roi_weights,
    update_voxel_weights,
)
from coma_unet_tpu_torch.losses.weighted import (  # noqa: F401
    weighted_cc,
    weighted_cccl,
    weighted_l1,
    weighted_mse,
)
