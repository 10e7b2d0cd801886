"""Contrastive losses over similarity matrices.

Port of ``antmmf_tpu/modules/losses/contrastive.py:26-116``: ``cross_en``
(InfoNCE with diagonal positives), ``symmetric_cross_en`` (its CLIP-style
t2v + v2t mean), ``mil_nce`` (several positives a row), ``neg_nce`` (the
softmax over the positive and the hard negatives only), ``neg_nce_dmae``
(DMAE's NegNCE: CE on the diagonal plus a penalty on hard negatives) and
``moco_nce`` (a positive key against a queue of negatives). Inputs are
similarities, already temperature-scaled; every loss computes in fp32.
Masked logits hold ``finfo(float32).min``, as in the JAX package, so a row
whose entries are all masked gives 0 and never NaN.
"""

from __future__ import annotations

import torch

NEG_INF = torch.finfo(torch.float32).min


def cross_en(sim: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """InfoNCE with diagonal positives along ``dim`` (rows by default)."""
    logp = torch.log_softmax(sim.float(), dim=dim)
    return -torch.diagonal(logp).mean()


def symmetric_cross_en(sim: torch.Tensor) -> torch.Tensor:
    """(t2v + v2t)/2 on a square similarity matrix."""
    return 0.5 * (cross_en(sim, dim=-1) + cross_en(sim, dim=-2))


def mil_nce(sim: torch.Tensor, pos_mask: torch.Tensor) -> torch.Tensor:
    """-log(Σ_pos exp(s) / Σ_all exp(s)), averaged over the rows that have a
    positive. ``pos_mask`` [N, M], nonzero on positives."""
    sim = sim.float()
    pos = pos_mask.float() > 0
    all_lse = torch.logsumexp(sim, dim=-1)
    pos_lse = torch.logsumexp(torch.where(pos, sim, NEG_INF), dim=-1)
    has_pos = pos.sum(-1) > 0
    per_row = torch.where(has_pos, all_lse - pos_lse, 0.0)
    return per_row.sum() / has_pos.sum().clamp(min=1)


def neg_nce(sim: torch.Tensor, margin: float = 0.0, neg_weight: float = 1.0) -> torch.Tensor:
    """The softmax denominator keeps the diagonal positive and the hard
    negatives, those within ``margin`` of the positive, each weighted by
    ``neg_weight``."""
    sim = sim.float()
    eye = torch.eye(sim.shape[0], sim.shape[1], dtype=torch.bool, device=sim.device)
    pos = torch.where(eye, sim, 0.0).sum(-1, keepdim=True)
    hard = ~eye & (sim >= pos - margin)
    weights = torch.where(eye, 1.0, torch.where(hard, float(neg_weight), 0.0))
    logits = torch.where(weights > 0, sim + torch.log(weights.clamp(min=1e-30)), NEG_INF)
    return -torch.diagonal(torch.log_softmax(logits, dim=-1)).mean()


def neg_nce_dmae(sim: torch.Tensor, logit_scale: float = 100.0, c_pos: float = 1.0,
                 c_neg: float = 0.5, margin: float = 0.0) -> torch.Tensor:
    """DMAE's NegNCE: CE on the diagonal of softmax(sim · logit_scale), with p
    clipped to [1e-6, 1 − 1e-6], plus ``c_neg`` × the mean of −log(1 − p)
    over the hard negatives: the off-diagonal entries within ``margin`` of
    the diagonal in their row or in their column."""
    sim = sim.float()
    p = torch.softmax(sim * logit_scale, dim=-1).clamp(1e-6, 1 - 1e-6)
    diag = torch.diagonal(sim)
    eye = torch.eye(sim.shape[0], dtype=torch.bool, device=sim.device)
    max_margin = torch.relu(margin + sim - diag[:, None]) + torch.relu(margin + sim - diag[None, :])
    hard = (max_margin > 0.0) & ~eye
    loss_pos = -torch.log(torch.diagonal(p))
    neg_terms = torch.where(hard, -torch.log(1.0 - p), 0.0)
    return c_pos * loss_pos.mean() + c_neg * neg_terms.sum() / hard.sum().clamp(min=1)


def moco_nce(query: torch.Tensor, key_pos: torch.Tensor, queue: torch.Tensor,
             temperature: float = 0.07) -> torch.Tensor:
    """MoCo InfoNCE: the positive from the momentum key (no gradient), the
    negatives from the queue [K, C] (no gradient), positive in column 0."""
    key_pos, queue = key_pos.detach(), queue.detach()
    l_pos = (query * key_pos).sum(-1, keepdim=True)
    logits = torch.cat([l_pos, query @ queue.T], dim=1) / temperature
    return -torch.log_softmax(logits.float(), dim=-1)[:, 0].mean()
