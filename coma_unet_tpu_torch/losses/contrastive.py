"""Contrastive losses (counterpart of `coma_unet_tpu/losses/contrastive.py`:
`rnc_loss`, `triplet_loss`, `truncated_cds`, `npair_loss`,
`cluster_npair_loss`, `heteroscedastic_loss`), as closed-form broadcast
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


def _cosine(a: torch.Tensor, b: torch.Tensor, dim: int = -1) -> torch.Tensor:
    an = a / torch.clamp(torch.linalg.norm(a, dim=dim, keepdim=True), min=1e-8)
    bn = b / torch.clamp(torch.linalg.norm(b, dim=dim, keepdim=True), min=1e-8)
    return torch.sum(an * bn, dim=dim)


def npair_loss(anchor: torch.Tensor, pos_template: torch.Tensor,
               neg_templates: torch.Tensor) -> torch.Tensor:
    """The template N-pair loss: softmax over the cosine similarity to the
    matching abeta-x-quartile template against the other 7. anchor [B, E];
    pos_template [E] or [B, E]; neg_templates [M, E]."""
    if pos_template.dim() == 1:
        pos_template = pos_template[None, :]
    pos_sim = _cosine(anchor, pos_template)                          # [B]
    neg_sim = _cosine(anchor[:, None, :], neg_templates[None, :, :])  # [B, M]
    numerator = torch.exp(pos_sim)
    denominator = numerator + torch.sum(torch.exp(neg_sim), dim=-1)
    return torch.mean(-torch.log(numerator / denominator))


def cluster_npair_loss(anchor_projs: Sequence[torch.Tensor],
                       pos_projs: Sequence[torch.Tensor],
                       neg_projs: Sequence[torch.Tensor],
                       temperature: float = 1.0) -> torch.Tensor:
    """`ClusterNPairLoss`: the N-pair loss per level with several
    negatives, summed over the levels; neg_projs[i] is [B, M, F]."""
    total = anchor_projs[0].new_zeros((), dtype=torch.float32)
    for a, p, ng in zip(anchor_projs, pos_projs, neg_projs):
        num = torch.exp(_cosine(a, p) / temperature)
        den = num + torch.sum(torch.exp(_cosine(a[:, None, :], ng) / temperature), dim=-1)
        total = total + torch.mean(-torch.log(num / den))
    return total


def heteroscedastic_loss(q: torch.Tensor, q_hat: torch.Tensor,
                         sigma2: torch.Tensor) -> torch.Tensor:
    """`HeteroscedasticLoss`: mean of (q - q_hat)^2 / (2 sigma^2) +
    log sigma^2."""
    return torch.mean(torch.square(q - q_hat) / (2.0 * sigma2) + torch.log(sigma2))
