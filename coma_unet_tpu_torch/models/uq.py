"""Uncertainty-quantification heads and the classifier MLP (counterpart of
`coma_unet_tpu/models/uq.py`):

- `MLP`: a softmax classifier head (reserved for ABeta classification in
  the original, kept for parity);
- `AleatoricUncertaintyNet`: predicts log sigma^2 from (x, q_hat) for
  `heteroscedastic_loss`; confidence = 1 / (1 + sigma^2).

flax reads the input width from the first call; these modules take it at
construction. Both build on the GPU unless `device` says otherwise, with
flax Dense's init drawn from `generator`.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from coma_unet_tpu_torch.models.blocks import Dense


class MLP(nn.Module):
    """forward(x [B, in_features]) -> class probabilities [B, num_classes]:
    ReLU Dense layers `fc{i}`, then `out` and a softmax."""

    def __init__(self, in_features: int, hidden_layers: Sequence[int],
                 num_classes: int, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        widths = [in_features] + list(hidden_layers)
        for i, (a, b) in enumerate(zip(widths, widths[1:])):
            setattr(self, f"fc{i}", Dense(a, b, dtype=torch.float32, device=device,
                                          generator=generator))
        self.depth = len(hidden_layers)
        self.out = Dense(widths[-1], num_classes, dtype=torch.float32, device=device,
                         generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.depth):
            x = torch.relu(getattr(self, f"fc{i}")(x))
        return torch.softmax(self.out(x), dim=-1)


class AleatoricUncertaintyNet(nn.Module):
    """forward(x [B, F] or [B, 1, F], q_hat [B]) -> (sigma2 [B, 1],
    confidence [B, 1])."""

    def __init__(self, in_features: int, hidden: int = 64, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(dtype=torch.float32, device=device, generator=generator)
        self.fc1 = Dense(in_features + 1, hidden, **kw)
        self.fc2 = Dense(hidden, hidden, **kw)
        self.out = Dense(hidden, 1, **kw)

    def forward(self, x: torch.Tensor, q_hat: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        if x.dim() == 3:
            x = x.squeeze(1)
        h = torch.cat([x, q_hat[:, None]], dim=-1).float()
        h = torch.relu(self.fc1(h))
        h = torch.relu(self.fc2(h))
        sigma2 = torch.exp(self.out(h))
        return sigma2, 1.0 / (1.0 + sigma2)
