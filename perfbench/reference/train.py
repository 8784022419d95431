"""Plain reference of the training step: the composite loss (per-sample
RoiMSE summed over the batch, plus Rank-N-Contrast on the deepest
projection for the flagship) and AdamW, in PyTorch float32.

A frozen copy of the arithmetic the paper's `run.sh` trains with: RoiMSE
is the mean squared error of a sample times the mean of its ROI weight
mask (0 in the background, w_i in ROI i); RnC (Zha et al. 2023) takes the
L1 distance of the covariate vectors as the label distance and
-||f_i - f_j|| / t as the logit; AdamW (Loshchilov and Hutter 2019) decays
every leaf that has a gradient, with the bias-corrected moments of Adam.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from perfbench.reference.model import EXACT, Params, Precision, forward


def roi_mse(pred, gt, compact, roi_weights) -> torch.Tensor:
    """Per sample [B]."""
    b = pred.shape[0]
    se = (pred.reshape(b, -1) - gt.reshape(b, -1)).square().mean(-1)
    r = roi_weights.shape[0]
    table = torch.cat([roi_weights.new_zeros(1), roi_weights])
    ids = compact.reshape(b, -1).long()
    mask = table[torch.where((ids >= 1) & (ids <= r), ids, 0)]
    return se * mask.mean(-1)


def _drop_diag(m: torch.Tensor) -> torch.Tensor:
    """[n, n] -> [n, n - 1] without the diagonal."""
    n = m.shape[0]
    return m.reshape(-1)[1:].reshape(n - 1, n + 1)[:, :-1].reshape(n, n - 1)


def rnc(features: torch.Tensor, labels: torch.Tensor,
        temperature: float) -> torch.Tensor:
    n = features.shape[0]
    if n < 2:
        return features.new_zeros(())
    ld = (labels[:, None, :] - labels[None, :, :]).abs().sum(-1)
    d = torch.linalg.vector_norm(features[:, None, :] - features[None, :, :]
                                 + 1e-12, dim=-1)
    logits = -d / temperature
    logits = logits - logits.max(dim=1, keepdim=True).values.detach()
    lg, ex, ldn = (_drop_diag(m) for m in (logits, torch.exp(logits), ld))
    # j counts for the pair (i, k) where label_diff(i, j) >= label_diff(i, k)
    neg = (ldn[:, None, :] >= ldn[:, :, None]).float()
    denom = (neg * ex[:, None, :]).sum(-1)
    return -(lg - torch.log(denom)).sum() / (n * (n - 1))


def loss(p: Params, model_type: str, cfg: dict, lcfg: dict,
         batch: Dict[str, torch.Tensor], roi_weights: torch.Tensor,
         prec: Precision = EXACT, outs: Optional[list] = None) -> torch.Tensor:
    """The step's loss; `outs`, when given, receives the forward's `out`."""
    contra = model_type == "ContraAttnUNET"
    out, projections = forward(p, model_type, cfg, batch["mri"],
                               batch["covars"], batch["roi_loc"],
                               batch["roi_std"], batch["roi_compact"],
                               with_projections=contra, prec=prec)
    if outs is not None:
        outs.append(out.detach())
    total = lcfg["gen_weight"] * roi_mse(out, batch["tau"].float(),
                                         batch["roi_compact"], roi_weights).sum()
    if contra:
        if not lcfg["rnc"] or lcfg["reg_weight"] != 0.0:
            raise ValueError("the reference's loss is RoiMSE + RnC, with no "
                             "pred-space term")
        cov = batch["covars"].reshape(out.shape[0], -1).float()
        total = total + lcfg["ds_reg_weight"] * rnc(
            projections[-1], cov, lcfg["rnc_temperature"])
    return total


class AdamW:
    """torch's AdamW arithmetic over the leaves that have a gradient."""

    def __init__(self, lr: float, weight_decay: float,
                 betas=(0.9, 0.999), eps: float = 1e-8):
        self.lr, self.wd, self.betas, self.eps = lr, weight_decay, betas, eps
        self.m: Dict[str, torch.Tensor] = {}
        self.v: Dict[str, torch.Tensor] = {}
        self.t: Dict[str, int] = {}

    @torch.no_grad()
    def step(self, p: Params, grads: Dict[str, Optional[torch.Tensor]]) -> None:
        b1, b2 = self.betas
        for name, g in grads.items():
            if g is None:
                continue
            t = self.t[name] = self.t.get(name, 0) + 1
            m = self.m.setdefault(name, torch.zeros_like(g))
            v = self.v.setdefault(name, torch.zeros_like(g))
            m.mul_(b1).add_(g, alpha=1.0 - b1)
            v.mul_(b2).addcmul_(g, g, value=1.0 - b2)
            w = p[name]
            w.mul_(1.0 - self.lr * self.wd)
            denom = (v.sqrt() / (1.0 - b2 ** t) ** 0.5).add_(self.eps)
            w.addcdiv_(m, denom, value=-self.lr / (1.0 - b1 ** t))


def train_steps(p: Params, model_type: str, cfg: dict, lcfg: dict,
                batches: List[Dict[str, torch.Tensor]],
                roi_weights: torch.Tensor, lr: float, weight_decay: float,
                prec: Precision = EXACT):
    """Run one step per batch from the weights `p` (updated in place).
    Returns (losses [steps] as floats, the first step's gradients by
    leaf, None where a leaf has none, the first step's `out`)."""
    opt = AdamW(lr, weight_decay)
    names = list(p)
    losses, first, outs = [], None, []
    for batch in batches:
        leaves = [p[n].requires_grad_(True) for n in names]
        total = loss(p, model_type, cfg, lcfg, batch, roi_weights, prec,
                     outs if not outs else None)
        grads = torch.autograd.grad(total, leaves, allow_unused=True)
        for leaf in leaves:
            leaf.requires_grad_(False)
        grads = dict(zip(names, grads))
        if first is None:
            first = {n: None if g is None else g.detach().clone()
                     for n, g in grads.items()}
        losses.append(float(total.detach()))
        opt.step(p, grads)
        del total, grads
    return losses, first, outs[0]
