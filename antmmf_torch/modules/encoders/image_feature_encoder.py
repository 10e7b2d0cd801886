"""Region-feature encoders: projections over precomputed detector features.

Port of ``antmmf_tpu/modules/encoders/image_feature_encoder.py``
(``ImageFeatureEncoder``): ``identity`` returns the features;
``projection`` is ``proj`` (Linear) → ``norm`` (fp32 LayerNorm cast to the
compute dtype) → dropout; ``spatial_projection`` adds ``spatial_proj`` of
the boxes with their w·h appended before the norm. flax infers the spatial
kernel's width from the first boxes it sees; a torch Linear needs it up
front, so it is ``box_dim`` + 1: ``RegionProcessor`` emits 5-wide boxes
(xyxy and the area), so the kernel is [6, C] and the area is counted
twice, as in the JAX tree. Dropout (rate 0.1 by default, as in JAX) draws
from the generator the caller passes and runs only when the call is not
deterministic.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from antmmf_torch.modules.layers import Dropout, LayerNorm

TYPES = ("identity", "projection", "spatial_projection")


class ImageFeatureEncoder(nn.Module):
    def __init__(self, encoder_type: str = "projection", in_dim: int = 2048,
                 out_dim: int = 768, box_dim: int = 4, dropout: float = 0.1,
                 dtype=torch.float32, device=None):
        super().__init__()
        if encoder_type not in TYPES:
            raise ValueError(f"encoder_type {encoder_type!r}: one of {TYPES}")
        self.encoder_type = encoder_type
        self.dtype = dtype
        if encoder_type == "identity":
            return
        kw = dict(dtype=dtype, device=device)
        self.proj = nn.Linear(in_dim, out_dim, **kw)
        if encoder_type == "spatial_projection":
            self.spatial_proj = nn.Linear(box_dim + 1, out_dim, **kw)
        self.norm = LayerNorm(out_dim, dtype=dtype, device=device)
        self.dropout = Dropout(dropout)

    def forward(self, features: torch.Tensor, boxes: Optional[torch.Tensor] = None,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """features [B, R, D], boxes [B, R, box_dim] normalised (xyxy first)
        → [B, R, out_dim]."""
        if self.encoder_type == "identity":
            return features
        x = self.proj(features.to(self.dtype))
        if self.encoder_type == "spatial_projection" and boxes is not None:
            boxes = boxes.float()
            w = boxes[..., 2] - boxes[..., 0]
            h = boxes[..., 3] - boxes[..., 1]
            spatial = torch.cat([boxes, (w * h)[..., None]], dim=-1)
            x = x + self.spatial_proj(spatial.to(self.dtype))
        return self.dropout(self.norm(x), deterministic, generator)
