"""Multi-head attention with its core routed to the hand-written kernels.

Port of ``antmmf_tpu/modules/attention.py`` (``xla_attention_core``,
``attention_core`` and ``MultiHeadAttention`` on the plain self-attention
branch). Routing is by structure alone:

* no bias or a key-padding bias [B, 1, 1, Lk], self-attention at L <= 256:
  ``ops.small_attention`` (kernel K1);
* the same biases past 256 tokens, or Lq ≠ Lk: ``ops.flash_attention`` (the
  flash forward, dQ and dK/dV kernels);
* query- or head-dependent biases: the einsum core, as the JAX router sends
  such biases to its XLA core.

Both kernel ops are autograd Functions. On the CPU they compute their plain
versions; on the card a dtype or head width a kernel does not take raises
and never falls back to the einsum core. Decode caches, ``cached_kv``,
sequence parallelism and ``sow_attention`` are not ported.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from antmmf_torch.ops.flash_attention import flash_attention
from antmmf_torch.ops.small_attention import MAX_L, einsum_attention, small_attention


def attention_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   bias: Optional[torch.Tensor] = None,
                   scale: Optional[float] = None) -> torch.Tensor:
    if bias is not None and bias.dim() == 4 and (bias.shape[1] > 1 or bias.shape[2] > 1):
        return einsum_attention(q, k, v, bias=bias, scale=scale)
    if q.shape[2] == k.shape[2] <= MAX_L:
        return small_attention(q, k, v, bias=bias, scale=scale)
    return flash_attention(q, k, v, bias=bias, scale=scale)


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
            # a strided [B, H, L, D] view of [B, L, H, D]: the kernels read it
            # in place, without a transposed copy
            return t.view(B, L, H, C // H).transpose(1, 2)

        out = attention_core(heads(self.q_proj(x)), heads(self.k_proj(x)),
                             heads(self.v_proj(x)), bias=bias)
        return self.out_proj(out.transpose(1, 2).reshape(B, L, C))
