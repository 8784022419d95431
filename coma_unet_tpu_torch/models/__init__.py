"""Models of the port: the flagship ContraAttnUNet, its blocks, and the
registry's baselines."""

from coma_unet_tpu_torch.models.attention_unet import (  # noqa: F401
    AttentionUNet,
    UNetFeatures,
)
from coma_unet_tpu_torch.models.blocks import (  # noqa: F401
    AttentionGate,
    CondConvolution,
    ConvBlock,
    Convolution,
    ProjectionHead,
    StackedFusionConvLayers,
    UpBlock,
)
from coma_unet_tpu_torch.models.contra import (  # noqa: F401
    ContraAttnUNet,
    ContraOutputs,
)
from coma_unet_tpu_torch.models.registry import (  # noqa: F401
    MODEL_TYPES,
    PlainAttentionUNet,
    PlainOutputs,
    apply_model,
    build_model,
)
