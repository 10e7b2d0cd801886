"""Masked-language-modeling head with a decoder tied to the word embedding.

Port of ``antmmf_tpu/modules/transformers/heads/mlm.py``: ``transform``
(Linear) → exact GELU → ``transform_norm`` (fp32 LayerNorm cast back to the
compute dtype) → logits against the word-embedding table the caller passes
in, plus an fp32 ``decoder_bias``. The table is the embedding's own
parameter, so the loss's gradient reaches the word embedding. As the JAX
einsum with ``preferred_element_type=float32``, the logits are fp32 sums of
the compute-dtype operands: both are widened to fp32 (exact from bf16) and
multiplied in fp32. ``loss_metric`` scores the positions whose label is not
-1.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from antmmf_torch.common.constants import LM_IGNORE_INDEX
from antmmf_torch.modules.layers import LayerNorm
from antmmf_torch.modules.transformers.heads.base import (
    PredictableHead,
    masked_cross_entropy,
    register_head,
)


@register_head("mlm")
class MLMHead(PredictableHead):
    def __init__(self, in_features: int, vocab_size: int, hidden_size: int,
                 layer_norm_eps: float = 1e-12, dtype=torch.bfloat16, device=None):
        super().__init__()
        self.transform = nn.Linear(in_features, hidden_size, dtype=dtype, device=device)
        self.transform_norm = LayerNorm(hidden_size, layer_norm_eps, dtype, device)
        self.decoder_bias = nn.Parameter(torch.zeros(vocab_size, device=device))

    def forward(self, sequence_output: torch.Tensor,
                embedding_table: torch.Tensor) -> torch.Tensor:
        """[B, L, C] and the tied table [V, H] → fp32 logits [B, L, V]."""
        x = self.transform_norm(F.gelu(self.transform(sequence_output)))
        return torch.matmul(x.float(), embedding_table.float().t()) + self.decoder_bias

    @staticmethod
    def loss_metric(logits: torch.Tensor, lm_label_ids: torch.Tensor
                    ) -> Dict[str, Dict[str, torch.Tensor]]:
        loss, acc = masked_cross_entropy(logits, lm_label_ids, lm_label_ids != LM_IGNORE_INDEX)
        return {"losses": {"masked_lm_loss": loss}, "metrics": {"masked_lm_acc": acc}}
