"""Models of the port: the flagship ContraAttnUNet and its blocks."""

from coma_unet_tpu_torch.models.attention_unet import (  # noqa: F401
    AttentionUNet,
    UNetFeatures,
)
from coma_unet_tpu_torch.models.contra import (  # noqa: F401
    ContraAttnUNet,
    ContraOutputs,
)
