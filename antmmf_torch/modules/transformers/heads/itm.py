"""Video-text matching head: a binary classifier over the pooled pair.

Port of ``antmmf_tpu/modules/transformers/heads/itm.py``: ``transform``
(Linear) → tanh → ``classifier`` (Linear to 2), fp32 logits; ``loss_metric``
is the mean cross-entropy and accuracy against 0/1 labels.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from antmmf_torch.modules.transformers.heads.base import PredictableHead, register_head


@register_head("itm")
class ITMHead(PredictableHead):
    def __init__(self, hidden_size: int = 768, dtype=torch.bfloat16, device=None):
        super().__init__()
        self.transform = nn.Linear(hidden_size, hidden_size, dtype=dtype, device=device)
        self.classifier = nn.Linear(hidden_size, 2, dtype=dtype, device=device)

    def forward(self, pooled_output: torch.Tensor) -> torch.Tensor:
        """[B, C] → fp32 [B, 2]."""
        return self.classifier(torch.tanh(self.transform(pooled_output))).float()

    @staticmethod
    def loss_metric(logits: torch.Tensor, labels: torch.Tensor
                    ) -> Dict[str, Dict[str, torch.Tensor]]:
        nll = -torch.log_softmax(logits, dim=-1).gather(-1, labels[:, None])[:, 0]
        acc = (logits.argmax(-1) == labels).float().mean()
        return {"losses": {"itm_loss": nll.mean()}, "metrics": {"itm_acc": acc}}
