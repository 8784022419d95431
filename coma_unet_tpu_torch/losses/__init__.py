"""Training losses of the port (counterpart of `coma_unet_tpu/losses/`)."""

from coma_unet_tpu_torch.losses.composite import (  # noqa: F401
    GenerativeContrastiveLoss,
    LossOutputs,
)
from coma_unet_tpu_torch.losses.contrastive import (  # noqa: F401
    rnc_loss,
    triplet_loss,
    truncated_cds,
)
from coma_unet_tpu_torch.losses.roi_losses import (  # noqa: F401
    make_voxel_weights,
    roi_mse,
)
