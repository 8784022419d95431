"""Utilities of the port: logging set-up and profiling."""

from coma_unet_tpu_torch.utils.logging import setup_logging  # noqa: F401
from coma_unet_tpu_torch.utils.profiling import StepTimer, trace  # noqa: F401
