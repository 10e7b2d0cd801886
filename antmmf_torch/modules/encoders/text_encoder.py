"""Text tower: BERT encoder (embeddings + post-LN stack + pooler).

Port of ``antmmf_tpu/modules/encoders/text_encoder.py``: ``sequence_output``
[B, L, C] and ``pooled_output`` = tanh(pooler(CLS)) [B, C]. ``dropout``
(the JAX default 0.1) drops after the embeddings' LayerNorm and inside the
stack; the word-importance pass runs without draws, as JAX runs it
deterministic.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from antmmf_torch.modules.embeddings import TextEmbeddings
from antmmf_torch.modules.layers import draws, make_attention_mask
from antmmf_torch.modules.transformers.base import TransformerEncoder

PRESETS = {
    "bert_base": dict(num_layers=12, hidden_size=768, num_heads=12, vocab_size=30522),
    "bert_small": dict(num_layers=4, hidden_size=512, num_heads=8, vocab_size=30522),
    "bert_chinese_base": dict(num_layers=12, hidden_size=768, num_heads=12,
                              vocab_size=21128),
    "bert_tiny_test": dict(num_layers=2, hidden_size=64, num_heads=2, vocab_size=30522),
    "bert_chinese_tiny_test": dict(num_layers=2, hidden_size=64, num_heads=2,
                                   vocab_size=21128),
}


class BertEncoder(nn.Module):
    def __init__(self, vocab_size: int = 30522, hidden_size: int = 768,
                 num_layers: int = 12, num_heads: int = 12, mlp_ratio: float = 4.0,
                 max_position_embeddings: int = 512, type_vocab_size: int = 2,
                 layer_norm_eps: float = 1e-12, dtype=torch.bfloat16, device=None,
                 dropout: float = 0.1):
        super().__init__()
        self.embeddings = TextEmbeddings(vocab_size, hidden_size, max_position_embeddings,
                                         type_vocab_size, layer_norm_eps, dtype, device,
                                         dropout)
        self.encoder = TransformerEncoder(
            hidden_size, num_layers, num_heads, mlp_ratio, "gelu_exact", "post",
            layer_norm_eps, dtype=dtype, device=device, dropout=dropout)
        self.pooler = nn.Linear(hidden_size, hidden_size, dtype=dtype, device=device)

    def embeddings_apply(self, input_ids: torch.Tensor,
                         segment_ids: Optional[torch.Tensor] = None,
                         extra: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.embeddings(input_ids, segment_ids, extra)

    def word_importance(self, input_ids: torch.Tensor, input_mask: torch.Tensor,
                        segment_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        """fp32 [B, L]: each token's attention column mass, mean over heads,
        summed over queries and layers."""
        with draws(None, active=False):
            x = self.embeddings(input_ids, segment_ids)
            return self.encoder(x, make_attention_mask(input_mask), return_importance=True)[1]

    def forward(self, input_ids: torch.Tensor, input_mask: Optional[torch.Tensor] = None,
                segment_ids: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        if input_mask is None:
            input_mask = torch.ones_like(input_ids)
        x = self.embeddings(input_ids, segment_ids)
        x = self.encoder(x, make_attention_mask(input_mask))
        return {"sequence_output": x, "pooled_output": torch.tanh(self.pooler(x[:, 0]))}
