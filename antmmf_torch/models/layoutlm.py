"""LayoutLM's 2D layout embeddings.

Port of ``LayoutEmbeddings`` of ``antmmf_tpu/models/layoutlm.py``: four
tables of ``max_position`` rows (``x_embed``, ``y_embed``, ``w_embed``,
``h_embed``) over bucketised box corners. x and y tables serve both
corners; the width and height are x1 − x0 and y1 − y0. Every index is
clipped to [0, max_position − 1], so a negative width reads row 0. The six
lookups are summed in the compute dtype in JAX's order. The ``layoutlm``
model itself is not ported.
"""

from __future__ import annotations

import torch
from torch import nn


class LayoutEmbeddings(nn.Module):
    def __init__(self, hidden_size: int, max_position: int = 1024, dtype=torch.bfloat16,
                 device=None):
        super().__init__()
        self.max_position = max_position
        kw = dict(dtype=dtype, device=device)
        self.x_embed = nn.Embedding(max_position, hidden_size, **kw)
        self.y_embed = nn.Embedding(max_position, hidden_size, **kw)
        self.w_embed = nn.Embedding(max_position, hidden_size, **kw)
        self.h_embed = nn.Embedding(max_position, hidden_size, **kw)

    def forward(self, bbox: torch.Tensor) -> torch.Tensor:
        """bbox int[B, L, 4] (x0, y0, x1, y1) → [B, L, hidden_size]."""
        bbox = bbox.long()

        def clip(v):
            return v.clamp(0, self.max_position - 1)

        x0, y0, x1, y1 = bbox.unbind(-1)
        return (self.x_embed(clip(x0)) + self.y_embed(clip(y0)) + self.x_embed(clip(x1))
                + self.y_embed(clip(y1)) + self.w_embed(clip(x1 - x0))
                + self.h_embed(clip(y1 - y0)))
