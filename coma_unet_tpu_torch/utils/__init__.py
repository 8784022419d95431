"""Utilities of the port: logging set-up, profiling and the program's
spans."""

from coma_unet_tpu_torch.utils.logging import setup_logging  # noqa: F401
from coma_unet_tpu_torch.utils.profiling import (  # noqa: F401
    SPANS,
    StepTimer,
    span,
    trace,
)
