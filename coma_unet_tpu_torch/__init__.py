"""CoMA-UNet in PyTorch with hand-written CUDA kernels for NVIDIA Hopper.

A port of the JAX package `coma_unet_tpu`, which stays the reference: the
same model, parameter names and NCDHW layouts, checked against it on the
CPU (`tests/test_torch_port_*.py`). The kernels that the JAX package wrote
in Pallas for the TPU are CUDA kernels here (`csrc/`), built at first use
(`ops/_build.py`). This package imports neither JAX nor flax; from the JAX
package it reads only the configuration file (`config.py`).

Ported so far: the serving forward of the flagship ContraAttnUNet
(`models/`, `infer/`).
"""

from coma_unet_tpu_torch.config import ModelConfig  # noqa: F401
from coma_unet_tpu_torch.models.attention_unet import (  # noqa: F401
    AttentionUNet,
    UNetFeatures,
)
from coma_unet_tpu_torch.models.contra import (  # noqa: F401
    ContraAttnUNet,
    ContraOutputs,
)
