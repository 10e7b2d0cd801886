"""Transformer encoder stack (pre-LN and post-LN).

Port of ``antmmf_tpu/modules/transformers/base.py``: ``TransformerLayer`` in
pre (ViT/CLIP) and post (BERT) norm style, and ``TransformerEncoder`` with its
final LayerNorm (pre style) and the ToMe branch, whose proportional-attention key
bias is log(token size). Layer scan, remat and pipelining are training and
scale-out levers of the JAX package and are not ported.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from antmmf_torch.modules.attention import MultiHeadAttention
from antmmf_torch.modules.layers import LayerNorm, Mlp
from antmmf_torch.modules.vision.token_merging import tome_merge


class TransformerLayer(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 activation: str = "gelu", norm_style: str = "pre",
                 layer_norm_eps: float = 1e-5, dtype=torch.bfloat16, device=None):
        super().__init__()
        if norm_style not in ("pre", "post"):
            raise ValueError(f"norm_style must be 'pre' or 'post', got {norm_style!r}")
        self.norm_style = norm_style
        self.attention = MultiHeadAttention(dim, num_heads, dtype, device)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), activation, dtype, device)
        self.norm1 = LayerNorm(dim, layer_norm_eps, dtype, device)
        self.norm2 = LayerNorm(dim, layer_norm_eps, dtype, device)

    def forward(self, x: torch.Tensor, bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.norm_style == "pre":
            x = x + self.attention(self.norm1(x), bias)
            return x + self.mlp(self.norm2(x))
        x = self.norm1(x + self.attention(x, bias))
        return self.norm2(x + self.mlp(x))


class TransformerEncoder(nn.Module):
    """``num_layers`` layers named ``layer_{i}``; a final LayerNorm in pre-LN
    style unless ``final_norm`` is off (post-LN stacks never have one); with
    ``token_merge_r`` > 0, ToMe merges r tokens after every layer but the
    last."""

    def __init__(self, dim: int, num_layers: int, num_heads: int,
                 mlp_ratio: float = 4.0, activation: str = "gelu",
                 norm_style: str = "pre", layer_norm_eps: float = 1e-5,
                 token_merge_r: int = 0, final_norm: bool = True,
                 dtype=torch.bfloat16, device=None):
        super().__init__()
        self.num_layers = num_layers
        self.token_merge_r = token_merge_r
        for i in range(num_layers):
            self.add_module(f"layer_{i}", TransformerLayer(
                dim, num_heads, mlp_ratio, activation, norm_style, layer_norm_eps,
                dtype, device))
        self.final_norm = (LayerNorm(dim, layer_norm_eps, dtype, device)
                           if final_norm and norm_style == "pre" else None)

    def forward(self, x: torch.Tensor, bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.token_merge_r > 0:
            if bias is not None:
                raise ValueError("token_merge_r needs bias-free self-attention (images)")
            # proportional attention (ToMe §3): keys score + log(size), so a
            # merged token draws attention like the tokens it stands for
            size = torch.ones(x.shape[:2], dtype=torch.float32, device=x.device)
            bias = torch.log(size)[:, None, None, :]
        for i in range(self.num_layers):
            x = getattr(self, f"layer_{i}")(x, bias)
            if self.token_merge_r > 0 and i < self.num_layers - 1:
                x, size = tome_merge(x, size, self.token_merge_r)
                bias = torch.log(size)[:, None, None, :]
        if self.final_norm is not None:
            x = self.final_norm(x)
        return x
