"""The pretraining-head contract.

Port of ``antmmf_tpu/modules/transformers/heads/base.py``: a head computes
predictions in ``forward`` and scores them with ``loss_metric(predictions,
targets, ...)``, which returns ``{"losses": {name: scalar}, "metrics":
{name: scalar}}``; the owning model merges both dictionaries into its
output. Heads register under the port's registry kind ``head``.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
from torch import nn

from antmmf_torch.common.registry import registry

register_head = registry.register_head


class PredictableHead(nn.Module):
    @staticmethod
    def loss_metric(predictions: torch.Tensor, *targets: Any) -> Dict[str, Dict[str, torch.Tensor]]:
        raise NotImplementedError


def masked_cross_entropy(logits: torch.Tensor, labels: torch.Tensor, valid: torch.Tensor):
    """(mean NLL, accuracy) over the ``valid`` positions of fp32 ``logits``
    [..., C] and int ``labels`` [...]; the denominator is clamped to 1, so a
    batch without a valid position scores 0 and 0."""
    labels = torch.where(valid, labels, torch.zeros_like(labels))
    nll = -torch.log_softmax(logits.float(), dim=-1).gather(-1, labels[..., None])[..., 0]
    denom = valid.sum().clamp(min=1)
    loss = torch.where(valid, nll, torch.zeros_like(nll)).sum() / denom
    acc = ((logits.argmax(-1) == labels) & valid).sum() / denom
    return loss, acc
