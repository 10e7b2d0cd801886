"""Contrastive losses over similarity matrices.

Port of ``antmmf_tpu/modules/losses/contrastive.py:26-36``: ``cross_en``
(InfoNCE with diagonal positives) and ``symmetric_cross_en`` (its CLIP-style
t2v + v2t mean). Inputs are fp32 similarities, already temperature-scaled.
MIL-NCE, NegNCE and the MoCo losses are not ported yet.
"""

from __future__ import annotations

import torch


def cross_en(sim: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """InfoNCE with diagonal positives along ``dim`` (rows by default)."""
    logp = torch.log_softmax(sim.float(), dim=dim)
    return -torch.diagonal(logp).mean()


def symmetric_cross_en(sim: torch.Tensor) -> torch.Tensor:
    """(t2v + v2t)/2 on a square similarity matrix."""
    return 0.5 * (cross_en(sim, dim=-1) + cross_en(sim, dim=-2))
