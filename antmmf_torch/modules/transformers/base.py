"""Transformer encoder stack (pre-LN and post-LN).

Port of ``antmmf_tpu/modules/transformers/base.py``: ``TransformerLayer`` in
pre (ViT/CLIP) and post (BERT) norm style, and ``TransformerEncoder`` with its
final LayerNorm (pre style) and the ToMe branch, whose proportional-attention key
bias is log(token size). ``return_importance`` also returns the reference's
word importance: over the layers, the sum of each layer's head-mean
attention column mass (its probabilities from the einsum core). ``remat``
recomputes each layer in the backward (``layers.checkpointed``, the JAX
package's ``nn.remat``) when gradients are on.

``dropout`` drops the attention output and the MLP's hidden and output
activations; ``drop_path`` drops each residual branch per sample
(``layers.DropPath``), at ``drop_path · i / max(1, n − 1)`` in layer i, or
at ``drop_path`` in every layer with ``scan_layers`` (the JAX package scans
one layer body, so its rate is uniform). ``scan_layers`` sets only that
rate here: the port keeps per-layer modules and names.
``sequence_parallel`` reaches every layer's attention
(``MultiHeadAttention``). Pipelining is a scale-out lever of the JAX
package and is not ported.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from antmmf_torch.modules.attention import MultiHeadAttention
from antmmf_torch.modules.layers import DropPath, LayerNorm, Mlp, checkpointed
from antmmf_torch.modules.vision.token_merging import tome_merge


class TransformerLayer(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 activation: str = "gelu", norm_style: str = "pre",
                 layer_norm_eps: float = 1e-5, dtype=torch.bfloat16, device=None, *,
                 dropout: float = 0.0, drop_path: float = 0.0, sequence_parallel: str = "none"):
        super().__init__()
        if norm_style not in ("pre", "post"):
            raise ValueError(f"norm_style must be 'pre' or 'post', got {norm_style!r}")
        self.norm_style = norm_style
        self.attention = MultiHeadAttention(dim, num_heads, dtype, device, dropout,
                                            sequence_parallel)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), activation, dtype, device, dropout)
        self.norm1 = LayerNorm(dim, layer_norm_eps, dtype, device)
        self.norm2 = LayerNorm(dim, layer_norm_eps, dtype, device)
        self.drop_path = DropPath(drop_path)

    def forward(self, x: torch.Tensor, bias: Optional[torch.Tensor] = None,
                return_attention: bool = False):
        """The layer's output; with ``return_attention``, (output, the
        attention probabilities)."""
        probs = None

        def attend(h):
            nonlocal probs
            if not return_attention:
                return self.attention(h, bias)
            out, probs = self.attention(h, bias, return_probs=True)
            return out

        dp = self.drop_path
        if self.norm_style == "pre":
            x = x + dp(attend(self.norm1(x)))
            x = x + dp(self.mlp(self.norm2(x)))
        else:
            x = self.norm1(x + dp(attend(x)))
            x = self.norm2(x + dp(self.mlp(x)))
        return (x, probs) if return_attention else x


class TransformerEncoder(nn.Module):
    """``num_layers`` layers named ``layer_{i}``; a final LayerNorm in pre-LN
    style unless ``final_norm`` is off (post-LN stacks never have one); with
    ``token_merge_r`` > 0, ToMe merges r tokens after every layer but the
    last; ``dropout``, ``drop_path`` and ``scan_layers`` as the module
    docstring says."""

    def __init__(self, dim: int, num_layers: int, num_heads: int,
                 mlp_ratio: float = 4.0, activation: str = "gelu",
                 norm_style: str = "pre", layer_norm_eps: float = 1e-5,
                 token_merge_r: int = 0, final_norm: bool = True, remat: bool = False,
                 dtype=torch.bfloat16, device=None, *, dropout: float = 0.0,
                 drop_path: float = 0.0, scan_layers: bool = False,
                 sequence_parallel: str = "none"):
        super().__init__()
        self.num_layers, self.remat = num_layers, remat
        self.token_merge_r = token_merge_r
        for i in range(num_layers):
            rate = drop_path if scan_layers else drop_path * i / max(1, num_layers - 1)
            self.add_module(f"layer_{i}", TransformerLayer(
                dim, num_heads, mlp_ratio, activation, norm_style, layer_norm_eps,
                dtype, device, dropout=dropout, drop_path=rate,
                sequence_parallel=sequence_parallel))
        self.final_norm = (LayerNorm(dim, layer_norm_eps, dtype, device)
                           if final_norm and norm_style == "pre" else None)

    def forward(self, x: torch.Tensor, bias: Optional[torch.Tensor] = None,
                return_importance: bool = False):
        """The stack's output; with ``return_importance``, (output, fp32
        importance [B, L])."""
        if self.token_merge_r > 0:
            if bias is not None or return_importance:
                raise ValueError("token_merge_r needs bias-free self-attention (images)")
            # proportional attention (ToMe §3): keys score + log(size), so a
            # merged token draws attention like the tokens it stands for
            size = torch.ones(x.shape[:2], dtype=torch.float32, device=x.device)
            bias = torch.log(size)[:, None, None, :]
        importance = None
        for i in range(self.num_layers):
            layer = getattr(self, f"layer_{i}")
            if return_importance:
                x, probs = layer(x, bias, return_attention=True)
                contrib = probs.mean(dim=1).sum(dim=1)
                importance = contrib if importance is None else importance + contrib
                continue
            x = (checkpointed(layer, x, bias) if self.remat and torch.is_grad_enabled()
                 else layer(x, bias))
            if self.token_merge_r > 0 and i < self.num_layers - 1:
                x, size = tome_merge(x, size, self.token_merge_r)
                bias = torch.log(size)[:, None, None, :]
        if self.final_norm is not None:
            x = self.final_norm(x)
        return (x, importance) if return_importance else x
