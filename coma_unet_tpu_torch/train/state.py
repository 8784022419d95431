"""Train state (counterpart of `coma_unet_tpu/train/state.py`): the model
holds the parameters, the optimizer its state; `step` counts the updates."""

from __future__ import annotations

from dataclasses import dataclass

import torch

from coma_unet_tpu_torch.train.optim import make_optimizer


@dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer

    @property
    def step(self) -> int:
        """Updates applied so far: the optimizer's own count, so it advances
        with every `optimizer.step()` and comes back with its state dict."""
        return max((int(s["step"]) for s in self.optimizer.state.values()
                    if "step" in s), default=0)


def create_train_state(model: torch.nn.Module, lr: float,
                       weight_decay: float = 0.01) -> TrainState:
    return TrainState(model, make_optimizer(model.parameters(), lr,
                                            weight_decay))
