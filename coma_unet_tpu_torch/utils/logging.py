"""Logging set-up with the per-run log file (counterpart of
`coma_unet_tpu/utils/logging.py`)."""

from __future__ import annotations

import logging
import sys
from typing import Optional


def setup_logging(log_file: Optional[str] = None,
                  level: int = logging.INFO) -> None:
    handlers = [logging.StreamHandler(sys.stderr)]
    if log_file:
        handlers.append(logging.FileHandler(log_file))
    logging.basicConfig(level=level,
                        format="%(asctime)s %(name)s %(levelname)s %(message)s",
                        handlers=handlers, force=True)
