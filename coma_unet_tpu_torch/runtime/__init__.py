"""The port's native host runtime (counterpart of `coma_unet_tpu/runtime/`):
the C++ NIfTI reader, built with g++ at first use."""

from coma_unet_tpu_torch.runtime.native import (  # noqa: F401
    load_batch_native,
    load_volume_native,
)
