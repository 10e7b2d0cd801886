"""Masked-region-classification head over the detector's class distribution.

Port of ``antmmf_tpu/modules/transformers/heads/mrc.py``: ``transform``
(Linear) → exact GELU → ``transform_norm`` (fp32 LayerNorm, eps 1e-6, cast
to the compute dtype) → ``decoder`` (Linear to the detector's classes),
fp32 logits. ``loss_metric`` is KL(p ‖ softmax(logits)) summed over the
masked regions (``region_to_predict`` 1) and divided by their count over
the batch (at least 1), with ``mrc_acc``: the share of masked regions whose
logits' argmax is the distribution's (first index on ties, both sides).
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from antmmf_torch.modules.layers import LayerNorm
from antmmf_torch.modules.transformers.heads.base import PredictableHead, register_head


@register_head("mrc")
class MRCHead(PredictableHead):
    loss_name = "masked_region_classification"

    def __init__(self, hidden_size: int = 768, vocab_size: int = 80, dtype=torch.bfloat16,
                 device=None):
        super().__init__()
        self.transform = nn.Linear(hidden_size, hidden_size, dtype=dtype, device=device)
        self.transform_norm = LayerNorm(hidden_size, 1e-6, dtype, device)
        self.decoder = nn.Linear(hidden_size, vocab_size, dtype=dtype, device=device)

    def forward(self, sequence_output: torch.Tensor) -> torch.Tensor:
        """[B, R, C] region states → fp32 [B, R, vocab_size]."""
        x = self.transform_norm(F.gelu(self.transform(sequence_output)))
        return self.decoder(x).float()

    def loss_metric(self, logits: torch.Tensor, region_to_predict: torch.Tensor,
                    region_cls_dis: torch.Tensor) -> Dict[str, Dict[str, torch.Tensor]]:
        logp = torch.log_softmax(logits.float(), dim=-1)
        p = region_cls_dis.float()
        kl = p * (torch.log(p.clamp(min=1e-12)) - logp)
        mask = region_to_predict == 1
        denom = mask.sum().clamp(min=1)
        loss = torch.where(mask[..., None], kl, torch.zeros_like(kl)).sum() / denom
        acc = ((p.argmax(-1) == logits.argmax(-1)) & mask).sum() / denom
        return {"losses": {self.loss_name: loss}, "metrics": {"mrc_acc": acc}}
