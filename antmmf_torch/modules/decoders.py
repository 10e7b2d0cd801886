"""Causal transformer decoder and the captioning language decoder.

Port of ``antmmf_tpu/modules/decoders.py``: ``causal_bias``, the pre-LN
``TransformerDecoderLayer`` (``norm1`` → causal self-attention, ``norm2`` →
cross-attention over the memory, ``norm3`` → ``Mlp`` with flax's tanh
``gelu``), ``TransformerDecoder`` with its final norm, and
``LanguageDecoder`` (``token_embed`` + ``pos_embed`` → decoder →
``out_proj``, computed in the compute dtype and cast to fp32, as the JAX
module casts a bf16 ``nn.Dense``'s output).

Incremental decoding (the caption serving path): ``prime`` projects each
layer's cross-attention memory k/v once; ``decode_step`` runs one token a
row against per-layer self-attention caches {"k", "v"} [B, H, T, D], which
each layer writes in place at the row's position. The decoder's attention
goes to the einsum core wherever its head width is outside the kernels'
(the captioning decoder's 768 over 8 heads is 96 wide), and its decode
calls always do, as the JAX package sends them to XLA. ``dropout`` drops
the self- and cross-attention outputs and the MLP's activations of the
teacher-forced pass; the decode branches never draw.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from antmmf_torch.modules.attention import MASKED, MultiHeadAttention
from antmmf_torch.modules.layers import LayerNorm, Mlp, draws, make_attention_mask

Cache = Dict[str, torch.Tensor]
MemKV = Tuple[torch.Tensor, torch.Tensor]


def causal_bias(length: int, device=None) -> torch.Tensor:
    """[1, 1, L, L] additive causal mask (fp32, -1e30 above the diagonal)."""
    mask = torch.ones(length, length, dtype=torch.bool, device=device).tril()
    return torch.where(mask, 0.0, MASKED)[None, None]


class TransformerDecoderLayer(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0, dropout: float = 0.0,
                 dtype=torch.bfloat16, device=None):
        super().__init__()
        self.self_attention = MultiHeadAttention(dim, num_heads, dtype, device, dropout)
        self.cross_attention = MultiHeadAttention(dim, num_heads, dtype, device, dropout)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), "gelu", dtype, device, dropout)
        self.norm1, self.norm2, self.norm3 = (LayerNorm(dim, dtype=dtype, device=device)
                                              for _ in range(3))

    def prime(self, memory: torch.Tensor) -> MemKV:
        """This layer's cross-attention memory k/v heads."""
        return self.cross_attention(memory, kv=memory, return_kv=True)

    def forward(self, x: torch.Tensor, memory: Optional[torch.Tensor],
                self_bias: Optional[torch.Tensor] = None,
                cross_bias: Optional[torch.Tensor] = None,
                self_cache: Optional[Cache] = None, decode_pos: Optional[torch.Tensor] = None,
                mem_kv: Optional[MemKV] = None):
        if self_cache is not None:
            a, self_cache = self.self_attention(self.norm1(x), cache=self_cache,
                                                decode_pos=decode_pos)
            x = x + a
            x = x + self.cross_attention(self.norm2(x), cross_bias, cached_kv=mem_kv)
            with draws(None, active=False):
                return x + self.mlp(self.norm3(x)), self_cache
        x = x + self.self_attention(self.norm1(x), self_bias)
        x = x + self.cross_attention(self.norm2(x), cross_bias, kv=memory)
        return x + self.mlp(self.norm3(x))


class TransformerDecoder(nn.Module):
    """``num_layers`` layers named ``layer_{i}`` and ``final_norm``."""

    def __init__(self, dim: int, num_layers: int, num_heads: int, mlp_ratio: float = 4.0,
                 dropout: float = 0.0, causal: bool = True, dtype=torch.bfloat16, device=None):
        super().__init__()
        self.num_layers, self.causal, self.dtype = num_layers, causal, dtype
        for i in range(num_layers):
            self.add_module(f"layer_{i}", TransformerDecoderLayer(
                dim, num_heads, mlp_ratio, dropout, dtype, device))
        self.final_norm = LayerNorm(dim, dtype=dtype, device=device)

    def layers(self) -> List[TransformerDecoderLayer]:
        return [getattr(self, f"layer_{i}") for i in range(self.num_layers)]

    def prime(self, memory: torch.Tensor) -> List[MemKV]:
        """Each layer's cross-attention memory k/v (the memory is a Dense
        input only, so it enters in the compute dtype)."""
        memory = memory.to(self.dtype)
        return [layer.prime(memory) for layer in self.layers()]

    def forward(self, x: torch.Tensor, memory: Optional[torch.Tensor],
                memory_mask: Optional[torch.Tensor] = None,
                caches: Optional[List[Cache]] = None, decode_pos: Optional[torch.Tensor] = None,
                mem_kvs: Optional[List[MemKV]] = None):
        """The teacher-forced pass over x [B, L, C] and memory [B, Lk, C];
        with ``caches`` one decode step against ``mem_kvs``, returning
        (x, caches)."""
        cross_bias = make_attention_mask(memory_mask) if memory_mask is not None else None
        if caches is not None:
            for layer, cache, mem_kv in zip(self.layers(), caches, mem_kvs):
                x, _ = layer(x, None, cross_bias=cross_bias, self_cache=cache,
                             decode_pos=decode_pos, mem_kv=mem_kv)
            return self.final_norm(x), caches
        memory = memory.to(self.dtype)
        self_bias = causal_bias(x.shape[1], x.device) if self.causal else None
        for layer in self.layers():
            x = layer(x, memory, self_bias, cross_bias)
        return self.final_norm(x)


class LanguageDecoder(nn.Module):
    """Caption generator: token and position embeddings, the causal decoder
    over the visual memory, and the vocabulary projection (fp32 logits)."""

    def __init__(self, vocab_size: int, hidden_size: int = 512, num_layers: int = 3,
                 num_heads: int = 8, max_length: int = 40, dropout: float = 0.0,
                 dtype=torch.bfloat16, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.max_length, self.num_heads = max_length, num_heads
        self.token_embed = nn.Embedding(vocab_size, hidden_size, **kw)
        self.pos_embed = nn.Embedding(max_length, hidden_size, **kw)
        self.decoder = TransformerDecoder(hidden_size, num_layers, num_heads, dropout=dropout,
                                          dtype=dtype, device=device)
        self.out_proj = nn.Linear(hidden_size, vocab_size, **kw)

    def forward(self, tokens: torch.Tensor, memory: torch.Tensor,
                memory_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """tokens int[B, L] → fp32 logits [B, L, V]."""
        positions = torch.arange(tokens.shape[1], device=tokens.device)
        x = self.token_embed(tokens) + self.pos_embed(positions)[None]
        return self.out_proj(self.decoder(x, memory, memory_mask)).float()

    def prime(self, memory: torch.Tensor) -> List[MemKV]:
        """Each layer's cross-attention memory k/v, computed once."""
        return self.decoder.prime(memory)

    def decode_step(self, tokens: torch.Tensor, pos: torch.Tensor, caches: List[Cache],
                    mem_kvs: List[MemKV], memory_mask: Optional[torch.Tensor] = None):
        """One token a row: ``tokens`` int[B] at position ``pos`` int[B]
        (clipped to the table). Returns (fp32 logits [B, V], caches), the
        caches written in place."""
        x = self.token_embed(tokens[:, None]) + self.pos_embed(
            pos[:, None].clamp(0, self.max_length - 1))
        x, caches = self.decoder(x, None, memory_mask, caches=caches, decode_pos=pos,
                                 mem_kvs=mem_kvs)
        return self.out_proj(x[:, 0]).float(), caches
