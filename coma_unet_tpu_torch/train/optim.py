"""Optimizer and learning-rate control (counterpart of
`coma_unet_tpu/train/optim.py`).

optax `adamw` decays every leaf, biases included, and applies
lr * (m_hat / (sqrt(v_hat) + eps) + wd * p) to the old parameters;
`torch.optim.AdamW` over all parameters in one group is the same update.
Gradient accumulation (`grad_acc` > 1) wraps it in `MultiSteps`, optax's
`MultiSteps` semantics. The plateau controller runs on the host between
epochs, as in the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, Union

import torch


class MultiSteps:
    """optax `MultiSteps(every_k_schedule=k)` over a torch optimizer: each
    `step()` folds the parameters' `.grad` into a running mean (Welford's
    update, acc + (g - acc) / (n + 1), a missing gradient read as 0), and
    every k-th call the inner optimizer steps on the mean of the k
    micro-batch gradients. `param_groups` are the inner optimizer's, so
    `get_lr` and `set_lr` reach it. `steps` counts every call, as flax's
    `TrainState.step` counts `apply_gradients`."""

    def __init__(self, inner: torch.optim.Optimizer, every_k: int):
        self.inner = inner
        self.every_k = every_k
        self.mini_step = 0
        self._acc: Dict[torch.nn.Parameter, torch.Tensor] = {}

    @property
    def param_groups(self):
        return self.inner.param_groups

    @property
    def state(self):
        return self.inner.state

    @property
    def steps(self) -> int:
        return inner_steps(self.inner) * self.every_k + self.mini_step

    def _params(self):
        return [p for g in self.inner.param_groups for p in g["params"]]

    def zero_grad(self, set_to_none: bool = True) -> None:
        self.inner.zero_grad(set_to_none=set_to_none)

    @torch.no_grad()
    def step(self) -> None:
        n = self.mini_step
        for p in self._params():
            if p.grad is None and p not in self._acc:
                continue
            acc = self._acc.get(p)
            if acc is None:
                acc = self._acc[p] = torch.zeros_like(p)
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            acc.add_((g - acc) / (n + 1))
        self.mini_step = n + 1
        if self.mini_step < self.every_k:
            return
        for p in self._params():
            p.grad = self._acc.get(p)
        self.inner.step()
        self._acc.clear()
        self.mini_step = 0

    def state_dict(self) -> dict:
        params = self._params()
        return {"inner": self.inner.state_dict(), "mini_step": self.mini_step,
                "acc": {i: self._acc[p] for i, p in enumerate(params)
                        if p in self._acc}}

    def load_state_dict(self, d: dict) -> None:
        self.inner.load_state_dict(d["inner"])
        self.mini_step = int(d["mini_step"])
        params = self._params()
        self._acc = {params[int(i)]: t.to(params[int(i)].device)
                     for i, t in d["acc"].items()}


Optimizer = Union[torch.optim.Optimizer, MultiSteps]


def make_optimizer(params: Iterable[torch.nn.Parameter], lr: float,
                   weight_decay: float = 0.01, grad_acc: int = 1) -> Optimizer:
    """AdamW with optax's defaults (betas 0.9 / 0.999, eps 1e-8), wrapped
    in `MultiSteps` when `grad_acc` > 1."""
    adamw = torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                              weight_decay=weight_decay)
    return MultiSteps(adamw, grad_acc) if grad_acc > 1 else adamw


def inner_steps(optimizer: torch.optim.Optimizer) -> int:
    """The updates a torch optimizer has applied: its own count, which
    comes back with its state dict."""
    return max((int(s["step"]) for s in optimizer.state.values()
                if "step" in s), default=0)


def get_lr(optimizer: Optimizer) -> float:
    return float(optimizer.param_groups[0]["lr"])


def set_lr(optimizer: Optimizer, lr: float) -> None:
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
