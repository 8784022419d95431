"""Optimizer and learning-rate control (counterpart of
`coma_unet_tpu/train/optim.py`).

optax `adamw` decays every leaf, biases included, and applies
lr * (m_hat / (sqrt(v_hat) + eps) + wd * p) to the old parameters;
`torch.optim.AdamW` over all parameters in one group is the same update.
The plateau controller runs on the host between epochs, as in the JAX
package.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable

import torch


def make_optimizer(params: Iterable[torch.nn.Parameter], lr: float,
                   weight_decay: float = 0.01,
                   grad_acc: int = 1) -> torch.optim.AdamW:
    """AdamW with optax's defaults (betas 0.9 / 0.999, eps 1e-8)."""
    if grad_acc > 1:
        raise NotImplementedError(
            "gradient accumulation comes with the training loop")
    return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=weight_decay)


def get_lr(optimizer: torch.optim.Optimizer) -> float:
    return float(optimizer.param_groups[0]["lr"])


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr


@dataclass
class ReduceLROnPlateau:
    """torch `ReduceLROnPlateau` semantics as the JAX package keeps them:
    mode "min", relative threshold, no cooldown."""

    patience: int = 5
    factor: float = 0.1
    threshold: float = 1e-4
    min_lr: float = 0.0
    best: float = float("inf")
    num_bad_epochs: int = 0

    def step(self, metric: float, current_lr: float) -> float:
        """Return the (possibly reduced) learning rate."""
        if metric < self.best * (1.0 - self.threshold):
            self.best = metric
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
        if self.num_bad_epochs > self.patience:
            self.num_bad_epochs = 0
            return max(current_lr * self.factor, self.min_lr)
        return current_lr

    def state_dict(self) -> dict:
        return dict(vars(self))

    def load_state_dict(self, d: dict) -> None:
        for k, v in d.items():
            setattr(self, k, v)
