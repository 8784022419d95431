"""Contrastive losses (counterpart of `coma_unet_tpu/losses/contrastive.py`:
`rnc_loss`, `triplet_loss`, `truncated_cds`), as closed-form broadcast
reductions. `valid` ([N] 0/1) drops the loader's wrap-padded rows from every
term, so each loss equals its value on the valid subset.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch


def _drop_diag(m: torch.Tensor) -> torch.Tensor:
    """[n, n] -> [n, n - 1] without the diagonal."""
    n = m.shape[0]
    return m.reshape(-1)[1:].reshape(n - 1, n + 1)[:, :-1].reshape(n, n - 1)


def rnc_loss(features: torch.Tensor, labels: torch.Tensor,
             temperature: float = 2.0,
             valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Rank-N-Contrast on features [N, F] with labels [N, L] (the full
    covariate vector in the trainer; the label distance is L1):

        -1/(m(m-1)) sum_{i,k} [logit(i,k)
            - log sum_j 1[d_l(i,j) >= d_l(i,k)] exp(logit(i,j))]

    with logit(i,j) = -||f_i - f_j|| / t, the diagonal removed. Fewer than
    two samples have no ranking pairs: the loss is 0 with no gradient."""
    if labels.dim() == 1:
        labels = labels[:, None]
    n = features.shape[0]
    if n < 2:
        return features.new_zeros((), dtype=torch.float32)
    f = features.float()
    lab = labels.float()
    label_diffs = (lab[:, None, :] - lab[None, :, :]).abs().sum(dim=-1)
    d = torch.linalg.vector_norm(f[:, None, :] - f[None, :, :] + 1e-12, dim=-1)
    logits = -d / temperature
    # per-row stability shift; it cancels in logits - log(denom)
    logits = logits - logits.max(dim=1, keepdim=True).values.detach()
    logits_nd = _drop_diag(logits)
    exp_nd = _drop_diag(torch.exp(logits))
    ld_nd = _drop_diag(label_diffs)
    # neg_mask[i, k, j] = 1 if label_diff(i, j) >= label_diff(i, k)
    neg_mask = (ld_nd[:, None, :] >= ld_nd[:, :, None]).float()
    if valid is None:
        denom = (neg_mask * exp_nd[:, None, :]).sum(dim=-1)
        return -(logits_nd - torch.log(denom)).sum() / (n * (n - 1))
    v = valid.reshape(-1).float()
    v_nd = _drop_diag(v[None, :].expand(n, n))
    w = v[:, None] * v_nd
    denom = (neg_mask * (exp_nd * v_nd)[:, None, :]).sum(dim=-1)
    # the j = k term keeps denom > 0 wherever w > 0; the where keeps the
    # gradient of masked pairs free of nan * 0
    denom = torch.where(w > 0, denom, torch.ones_like(denom))
    m = v.sum()
    return -((logits_nd - torch.log(denom)) * w).sum() / torch.clamp(
        m * (m - 1.0), min=1.0)


def triplet_loss(anchor: torch.Tensor, positive: torch.Tensor,
                 negative: torch.Tensor, margin: float = 1.0,
                 valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """torch `TripletMarginWithDistanceLoss` (pairwise L2, mean over the
    valid samples)."""
    eps = 1e-6
    d_ap = torch.linalg.vector_norm(anchor - positive + eps, dim=-1)
    d_an = torch.linalg.vector_norm(anchor - negative + eps, dim=-1)
    hinge = torch.clamp(d_ap - d_an + margin, min=0.0)
    if valid is None:
        return hinge.mean()
    v = valid.reshape(-1).to(hinge.dtype)
    return (hinge * v).sum() / torch.clamp(v.sum(), min=1.0)


def truncated_cds(anchor_projs: Sequence[torch.Tensor],
                  pos_projs: Sequence[torch.Tensor],
                  neg_projs: Sequence[torch.Tensor], weights: Sequence[float],
                  margin: float = 1.0,
                  valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Truncated contrastive deep supervision: sum_i w_i *
    triplet(anchor_i, pos_i, neg_i) over the per-level projections."""
    total = torch.zeros((), dtype=torch.float32,
                        device=anchor_projs[0].device)
    for w, a, p, ng in zip(weights, anchor_projs, pos_projs, neg_projs):
        total = total + w * triplet_loss(a, p, ng, margin=margin, valid=valid)
    return total
