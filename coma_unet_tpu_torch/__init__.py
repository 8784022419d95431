"""CoMA-UNet in PyTorch with hand-written CUDA kernels for NVIDIA Hopper.

A port of the JAX package `coma_unet_tpu`, which stays the reference: the
same model, parameter names and NCDHW layouts, checked against it on the
CPU (`tests/test_torch_port_*.py`). The kernels that the JAX package wrote
in Pallas for the TPU are CUDA kernels here (`csrc/`), built at first use
(`ops/_build.py`). This package imports neither JAX nor flax, and needs no
file of the JAX package: its configuration (`config.py`) is its own copy.

Ported so far: the serving forward of the flagship ContraAttnUNet
(`models/`, `infer/`), its train step (`losses/`, `train/`), whose
backward runs through hand-written kernels too, and its eval step with the
metric suite (`metrics/`), at 128^3 and in template space at 216^3; the
loop, the data pipeline and the CLI; the model registry and the seven
baselines (`models/registry.py`, `baselines.py`, `swin.py`); data
parallelism and depth-sharded (spatial) inference over a
`torch.distributed` group (`parallel/`); the analysis (`analysis/`: the
attention export, the embedding probe, per-ROI statistics) and the
profiler (`utils/profiling.py`). Models build
on the GPU unless asked for the CPU (`device="cpu"`).
"""

from coma_unet_tpu_torch.config import (  # noqa: F401
    DataConfig,
    ExperimentConfig,
    LossConfig,
    ModelConfig,
    ROI_INDICES,
    ROI_NAMES,
    TEMPLATE_ROI_INDICES,
    TrainConfig,
)
from coma_unet_tpu_torch.models.attention_unet import (  # noqa: F401
    AttentionUNet,
    UNetFeatures,
)
from coma_unet_tpu_torch.models.contra import (  # noqa: F401
    ContraAttnUNet,
    ContraOutputs,
)
from coma_unet_tpu_torch.models.registry import (  # noqa: F401
    MODEL_TYPES,
    apply_model,
    build_model,
)
