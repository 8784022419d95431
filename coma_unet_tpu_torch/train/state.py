"""Train state (counterpart of `coma_unet_tpu/train/state.py`): the model
holds the parameters, the optimizer its state; `step` counts the updates as
flax's `TrainState.step` does; `param_count` counts the parameters."""

from __future__ import annotations

from dataclasses import dataclass

import torch

from coma_unet_tpu_torch.train.optim import (
    MultiSteps,
    Optimizer,
    inner_steps,
    make_optimizer,
)


@dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: Optimizer

    @property
    def step(self) -> int:
        """`apply_gradients` calls so far, flax's count: the AdamW updates,
        or with gradient accumulation every micro-batch. It comes from the
        optimizer's state, so it comes back with its state dict."""
        if isinstance(self.optimizer, MultiSteps):
            return self.optimizer.steps
        return inner_steps(self.optimizer)


def create_train_state(model: torch.nn.Module, lr: float,
                       weight_decay: float = 0.01,
                       grad_acc: int = 1) -> TrainState:
    return TrainState(model, make_optimizer(model.parameters(), lr,
                                            weight_decay, grad_acc))


def param_count(model: torch.nn.Module) -> int:
    """The number of parameter elements (buffers such as batch norm's
    running statistics left out, as flax keeps them out of `params`)."""
    return sum(p.numel() for p in model.parameters())
