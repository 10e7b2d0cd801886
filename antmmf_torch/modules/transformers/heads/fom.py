"""Frame-order-modeling head: each frame's original position.

Port of ``antmmf_tpu/modules/transformers/heads/fom.py``: ``classifier``
(Linear to ``max_positions``), fp32 logits [B, N, P]; ``loss_metric`` is
the cross-entropy and accuracy over the valid frames.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from antmmf_torch.modules.transformers.heads.base import (
    PredictableHead,
    masked_cross_entropy,
    register_head,
)


@register_head("fom")
class FOMHead(PredictableHead):
    def __init__(self, in_features: int, max_positions: int, dtype=torch.bfloat16,
                 device=None):
        super().__init__()
        self.classifier = nn.Linear(in_features, max_positions, dtype=dtype, device=device)

    def forward(self, clip_sequence: torch.Tensor) -> torch.Tensor:
        """[B, N, C] → fp32 [B, N, max_positions]."""
        return self.classifier(clip_sequence).float()

    @staticmethod
    def loss_metric(logits: torch.Tensor, order_targets: torch.Tensor, valid: torch.Tensor
                    ) -> Dict[str, Dict[str, torch.Tensor]]:
        """``order_targets`` int [B, N] original positions; ``valid`` bool [B, N]."""
        loss, acc = masked_cross_entropy(logits, order_targets, valid)
        return {"losses": {"fom_loss": loss}, "metrics": {"fom_acc": acc}}
