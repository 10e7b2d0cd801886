"""EVA-ViT visual tower: Pink's frozen vision encoder.

Port of ``antmmf_tpu/modules/vision/eva_vit.py``: EVA-CLIP-g as Pink uses it
(patch 14, width 1408, 39 layers, 16 heads of 88, ``mlp_ratio`` 4.3637, so
an MLP of int(1408 · 4.3637) = 6144): the biased patch convolution, the
class token, the absolute ``pos_embed`` of (image_size / 14)² + 1 tokens,
then pre-LN ``TransformerLayer`` blocks with exact-erf GELU, eps 1e-6 and
biased q/k/v, and no final norm: the raw token sequence [B, 1 + N, C].
Parameters ``patch_embed``, ``cls_token``, ``pos_embed``, ``layer_{i}``.

flax's ``nn.Conv`` pads ``SAME``, which equals the port's VALID patch
product only when ``image_size`` is a multiple of the patch, so other sizes
are refused. Head width 88 is in neither kernel family's ``HEAD_DIMS``:
attention takes the einsum core by structure, as JAX takes its XLA core at
these lengths. ``remat`` recomputes each layer in the backward (training
with gradients only). ``dropout`` drops after the positions and inside each
layer, as JAX's tower does (a training forward's ``draws`` scope); Pink
never passes one, so its tower runs at 0. remat refuses a layer that draws
(``layers.checkpointed``).
"""

from __future__ import annotations

import torch
from torch import nn

from antmmf_torch.modules.embeddings import PatchConv
from antmmf_torch.modules.layers import Dropout, checkpointed, normal_
from antmmf_torch.modules.transformers.base import TransformerLayer

EVA_PRESETS = {
    "eva_vit_g": dict(patch_size=14, embed_dim=1408, num_layers=39, num_heads=16,
                      mlp_ratio=4.3637),
    "eva_tiny_test": dict(patch_size=14, embed_dim=32, num_layers=2, num_heads=2,
                          mlp_ratio=4.0),
}


class EvaVisionTransformer(nn.Module):
    def __init__(self, image_size: int = 224, patch_size: int = 14, embed_dim: int = 1408,
                 num_layers: int = 39, num_heads: int = 16, mlp_ratio: float = 4.3637,
                 dropout: float = 0.0, layer_norm_eps: float = 1e-6, remat: bool = False,
                 dtype=torch.bfloat16, device=None):
        super().__init__()
        if image_size % patch_size:
            raise ValueError(f"image_size {image_size} is not a multiple of the patch "
                             f"{patch_size}: flax pads SAME there, the port only VALID")
        self.image_size, self.num_layers, self.remat = image_size, num_layers, remat
        self.patch_embed = PatchConv(patch_size, embed_dim, dtype, device)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim, dtype=dtype, device=device))
        self.dropout = Dropout(dropout)
        n_tokens = (image_size // patch_size) ** 2 + 1
        self.pos_embed = nn.Parameter(torch.zeros(1, n_tokens, embed_dim, dtype=dtype,
                                                  device=device))
        for i in range(num_layers):
            self.add_module(f"layer_{i}", TransformerLayer(
                embed_dim, num_heads, mlp_ratio, "gelu_exact", "pre", layer_norm_eps, dtype,
                device, dropout=dropout))

    def init_params(self, generator: torch.Generator) -> None:
        normal_(self.cls_token, 0.02, generator)
        normal_(self.pos_embed, 0.02, generator)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """images float[B, H, W, 3] at ``image_size`` → tokens [B, 1 + N, C]."""
        B, H, W, _ = images.shape
        if H != self.image_size or W != self.image_size:
            raise ValueError(f"the EVA tower takes {self.image_size}x{self.image_size} images; "
                             f"got {H}x{W}")
        x = self.patch_embed(images)
        x = torch.cat([self.cls_token.expand(B, 1, x.shape[-1]), x], dim=1) + self.pos_embed
        x = self.dropout(x)
        remat = self.remat and torch.is_grad_enabled()
        for i in range(self.num_layers):
            layer = getattr(self, f"layer_{i}")
            x = checkpointed(layer, x) if remat else layer(x)
        return x
