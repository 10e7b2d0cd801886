"""Vision Transformer backbone (CLIP-style pre-LN ViT).

Port of ``antmmf_tpu/modules/vision/vit.py``: NHWC images → patch embeddings
→ ``pre_norm`` → pre-LN encoder (quick-GELU, final LayerNorm) → CLS pooling.
The JAX module's output projection and its final-norm and activation
switches are not used by UniVL and are not ported.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from antmmf_torch.modules.embeddings import VisualEmbeddings
from antmmf_torch.modules.layers import LayerNorm
from antmmf_torch.modules.transformers.base import TransformerEncoder

PRESETS = {
    "vit_base_patch32": dict(patch_size=32, embed_dim=768, num_layers=12, num_heads=12),
    "vit_base_patch16": dict(patch_size=16, embed_dim=768, num_layers=12, num_heads=12),
    "vit_large_patch14": dict(patch_size=14, embed_dim=1024, num_layers=24, num_heads=16),
    "vit_tiny_test": dict(patch_size=16, embed_dim=64, num_layers=2, num_heads=2),
}


class VisionTransformer(nn.Module):
    def __init__(self, image_size: int = 224, patch_size: int = 32,
                 embed_dim: int = 768, num_layers: int = 12, num_heads: int = 12,
                 token_merge_r: int = 0, dtype=torch.bfloat16, device=None):
        super().__init__()
        self.embeddings = VisualEmbeddings(image_size, patch_size, embed_dim, dtype, device)
        self.pre_norm = LayerNorm(embed_dim, 1e-5, dtype, device)
        self.encoder = TransformerEncoder(
            embed_dim, num_layers, num_heads, 4.0, "quick_gelu", "pre", 1e-5,
            token_merge_r, dtype=dtype, device=device)

    def forward(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        """images float[B, H, W, 3] → dict(sequence [B, N, C], pooled [B, C])."""
        x = self.encoder(self.pre_norm(self.embeddings(images)))
        return {"sequence": x, "pooled": x[:, 0]}
