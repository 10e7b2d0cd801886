"""Multi-head attention with its core routed to the hand-written kernel.

Port of ``antmmf_tpu/modules/attention.py`` (``xla_attention_core``,
``attention_core`` and ``MultiHeadAttention`` on the plain self-attention
branch). Routing is by the bias's structure alone: with no bias or a
key-padding bias [B, 1, 1, Lk], attention goes to ``ops.small_attention``
(the CUDA kernel on the card, its plain version on the CPU), which raises on
a dtype, head width or length it does not take (L > 256, e.g. ViT-L/14 at
224², waits for a kernel; see ROADMAP). Query- or head-dependent biases use
the einsum core, as the JAX router sends such biases to its XLA core. Decode
caches, ``cached_kv``, sequence parallelism and ``sow_attention`` are not
ported.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from antmmf_torch.ops.small_attention import einsum_attention, small_attention


def attention_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   bias: Optional[torch.Tensor] = None,
                   scale: Optional[float] = None) -> torch.Tensor:
    if bias is not None and bias.dim() == 4 and (bias.shape[1] > 1 or bias.shape[2] > 1):
        return einsum_attention(q, k, v, bias=bias, scale=scale)
    return small_attention(q, k, v, bias=bias, scale=scale)


class MultiHeadAttention(nn.Module):
    """Self-attention with separate q/k/v projections (flax names
    ``q_proj``/``k_proj``/``v_proj``/``out_proj``). ``bias`` is an additive
    fp32 mask (see ``layers.make_attention_mask``)."""

    def __init__(self, dim: int, num_heads: int, dtype=torch.bfloat16, device=None):
        super().__init__()
        if dim % num_heads:
            raise ValueError(f"width {dim} is not divisible by {num_heads} heads")
        self.num_heads = num_heads
        kw = dict(dtype=dtype, device=device)
        self.q_proj = nn.Linear(dim, dim, **kw)
        self.k_proj = nn.Linear(dim, dim, **kw)
        self.v_proj = nn.Linear(dim, dim, **kw)
        self.out_proj = nn.Linear(dim, dim, **kw)

    def forward(self, x: torch.Tensor, bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        B, L, C = x.shape
        H = self.num_heads

        def heads(t: torch.Tensor) -> torch.Tensor:
            # a strided [B, H, L, D] view of [B, L, H, D]: the kernel reads it
            # in place, without a transposed copy
            return t.view(B, L, H, C // H).transpose(1, 2)

        out = attention_core(heads(self.q_proj(x)), heads(self.k_proj(x)),
                             heads(self.v_proj(x)), bias=bias)
        return self.out_proj(out.transpose(1, 2).reshape(B, L, C))
