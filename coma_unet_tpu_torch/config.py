"""The model, loss and training configurations, shared with the JAX package.

`coma_unet_tpu/config.py` imports only the standard library, but importing it
as `coma_unet_tpu.config` first runs `coma_unet_tpu/__init__.py`, which
imports JAX and flax. The port must run where JAX is not installed, so it
loads that one file by path, as a module of its own.
"""

from __future__ import annotations

import importlib.util
import sys
from pathlib import Path

_SOURCE = Path(__file__).resolve().parents[1] / "coma_unet_tpu" / "config.py"
_NAME = "coma_unet_tpu_torch._reference_config"


def _load():
    if _NAME in sys.modules:
        return sys.modules[_NAME]
    spec = importlib.util.spec_from_file_location(_NAME, _SOURCE)
    module = importlib.util.module_from_spec(spec)
    # dataclasses resolve string annotations through sys.modules
    sys.modules[_NAME] = module
    spec.loader.exec_module(module)
    return module


_CONFIG = _load()
ModelConfig = _CONFIG.ModelConfig
LossConfig = _CONFIG.LossConfig
TrainConfig = _CONFIG.TrainConfig

__all__ = ["LossConfig", "ModelConfig", "TrainConfig"]
