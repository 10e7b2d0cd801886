"""Text and visual embeddings.

Port of ``antmmf_tpu/modules/embeddings.py``: ``TextEmbeddings`` (word +
position + token type, plus an optional additive ``extra`` such as
LayoutLM's box embeddings, then fp32 LayerNorm and dropout), ``PatchEmbed``
(the stride-p VALID convolution over NHWC images with an HWIO kernel) and
``VisualEmbeddings`` (patches + CLS token + learned positions, then
dropout). The dropout rates default to the JAX modules' (0.1 and 0).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from antmmf_torch.modules.layers import Dropout, LayerNorm, normal_


class TextEmbeddings(nn.Module):
    """BERT-style: word + learned position + token type, then LayerNorm and
    dropout."""

    def __init__(self, vocab_size: int, hidden_size: int,
                 max_position_embeddings: int = 512, type_vocab_size: int = 2,
                 layer_norm_eps: float = 1e-12, dtype=torch.bfloat16, device=None,
                 dropout: float = 0.1):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.word_embeddings = nn.Embedding(vocab_size, hidden_size, **kw)
        self.position_embeddings = nn.Embedding(max_position_embeddings, hidden_size, **kw)
        self.token_type_embeddings = nn.Embedding(type_vocab_size, hidden_size, **kw)
        self.layer_norm = LayerNorm(hidden_size, layer_norm_eps, dtype, device)
        self.dropout = Dropout(dropout)

    def forward(self, input_ids: torch.Tensor, segment_ids: Optional[torch.Tensor] = None,
                extra: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``extra`` [B, L, C] is summed in before the LayerNorm."""
        L = input_ids.shape[1]
        if segment_ids is None:
            segment_ids = torch.zeros_like(input_ids)
        positions = torch.arange(L, device=input_ids.device)[None, :]
        x = (self.word_embeddings(input_ids) + self.position_embeddings(positions)
             + self.token_type_embeddings(segment_ids))
        if extra is not None:
            x = x + extra.to(x.dtype)
        return self.dropout(self.layer_norm(x))


class PatchConv(nn.Linear):
    """The stride-p VALID convolution over images [B, H, W, 3] → patch
    tokens [B, N, C], written as a reshape and one matrix product with
    ``weight`` [C, p·p·3] (flax's HWIO kernel flattened in (h, w, in)
    order): the same products, and no cuDNN convolution with its TF32
    default for fp32."""

    def __init__(self, patch_size: int, embed_dim: int, dtype=torch.bfloat16, device=None):
        super().__init__(patch_size * patch_size * 3, embed_dim, dtype=dtype, device=device)
        self.patch_size = patch_size
        self.dtype = dtype

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        B, H, W, C = images.shape
        p = self.patch_size
        h, w = H // p, W // p
        x = images[:, :h * p, :w * p].to(self.dtype)
        x = x.reshape(B, h, p, w, p, C).permute(0, 1, 3, 2, 4, 5)
        return super().forward(x.reshape(B, h * w, p * p * C))


class PatchEmbed(nn.Module):
    """Image [B, H, W, 3] → patch tokens [B, N, C] through ``proj``, a
    ``PatchConv`` (flax scope ``proj``)."""

    def __init__(self, patch_size: int, embed_dim: int, dtype=torch.bfloat16,
                 device=None):
        super().__init__()
        self.patch_size = patch_size
        self.proj = PatchConv(patch_size, embed_dim, dtype, device)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        return self.proj(images)


class VisualEmbeddings(nn.Module):
    """Patchify + CLS token + learned positions. Only requests of
    ``image_size`` are taken: other sizes need the JAX package's antialiased
    bilinear resize of the position table, which is not ported."""

    def __init__(self, image_size: int = 224, patch_size: int = 32,
                 embed_dim: int = 768, dtype=torch.bfloat16, device=None,
                 dropout: float = 0.0):
        super().__init__()
        self.image_size = image_size
        self.dropout = Dropout(dropout)
        self.patch_embed = PatchEmbed(patch_size, embed_dim, dtype, device)
        n = (image_size // patch_size) ** 2 + 1
        self.pos_embedding = nn.Parameter(torch.zeros(n, embed_dim, dtype=dtype, device=device))
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim, dtype=dtype, device=device))

    def init_params(self, generator: torch.Generator) -> None:
        normal_(self.pos_embedding, 0.02, generator)  # cls_token stays zero

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        B, H, W, _ = images.shape
        if H != self.image_size or W != self.image_size:
            raise ValueError(f"VisualEmbeddings takes {self.image_size}x{self.image_size} "
                             f"images; got {H}x{W} (position interpolation to other "
                             f"sizes is not ported)")
        tokens = self.patch_embed(images)
        cls = self.cls_token.expand(B, 1, tokens.shape[-1])
        return self.dropout(torch.cat([cls, tokens], dim=1) + self.pos_embedding)
