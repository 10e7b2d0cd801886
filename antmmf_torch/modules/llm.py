"""Decoder-only LM blocks: RMSNorm, 1D rotary embeddings, grouped-query
attention with a KV cache, SwiGLU, and the decoder stack.

Port of ``antmmf_tpu/modules/llm.py`` on the branches Pink decode serving
runs (loop layout, 1D RoPE, q/v LoRA, bf16 cache). The KV cache is a list
with one ``{"k", "v"}`` dict per layer, each [B, n_kv_heads, T, head_dim]
with keys stored after RoPE; it is preallocated and written in place (the
JAX package returns updated copies). Two cached modes, as in JAX:

* prefill (``cache`` given, ``decode_pos`` None): the padded prompt chunk
  runs the normal causal forward and its k/v land at slots 0..L-1;
* decode (``decode_pos`` int[B]): an L-token chunk per row at contiguous
  slots ``decode_pos..decode_pos+L-1``; attention reads the whole cache
  with validity ``slot <= decode_pos + j`` for query j, grouped against
  the kv-head cache without repeating k/v.

Causal prefill and the cache-free forward run ``ops.flash_attention`` with
``causal=True`` and the key-padding bias (k/v repeated to the query heads):
on the card that is the hand-written flash kernel at every length, where
the JAX package takes an einsum core below 3072 tokens. Decode attention
(1 to a few queries against T cached keys with a per-query validity bias)
is plain tensor ops, as it is outside any kernel in the JAX package.

3D RoPE, the int8 cache, layer scan, remat, serial adapters, LoRA on other
projections than q and v, and sequence parallelism are not ported.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from antmmf_torch.modules.layers import normal_
from antmmf_torch.modules.qdense import QuantDense
from antmmf_torch.ops.flash_attention import flash_attention

MASKED = -1e30  # additive bias of a masked key, the JAX package's value


def init_decoder_cache(num_layers: int, batch: int, num_kv_heads: int, max_len: int,
                       head_dim: int, dtype=torch.bfloat16, device=None
                       ) -> List[Dict[str, torch.Tensor]]:
    """Zeroed per-layer KV cache for ``DecoderLM`` prefill and decode."""
    shape = (batch, num_kv_heads, max_len, head_dim)
    return [{"k": torch.zeros(shape, dtype=dtype, device=device),
             "v": torch.zeros(shape, dtype=dtype, device=device)}
            for _ in range(num_layers)]


class RMSNorm(nn.Module):
    """x · rsqrt(mean(x²) + eps) · scale, computed in fp32 with an fp32
    ``scale`` (flax's name), output cast to ``dtype``."""

    def __init__(self, dim: int, epsilon: float = 1e-6, dtype=torch.bfloat16, device=None):
        super().__init__()
        self.epsilon = epsilon
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        norm = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + self.epsilon)
        return (norm * self.scale).to(self.dtype)


def rope_frequencies(head_dim: int, theta: float = 10000.0, device=None) -> torch.Tensor:
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exponent)


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float = 10000.0
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) tables [B, 1, L, D] fp32 for 1D rotary positions int[B, L];
    computed once per forward by ``DecoderLM`` and shared by every layer."""
    inv = rope_frequencies(head_dim, theta, positions.device)
    freqs = positions[:, :, None].float() * inv
    emb = torch.cat([freqs, freqs], dim=-1)[:, None]
    return torch.cos(emb), torch.sin(emb)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope_cs(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotary embedding in the rotate-half convention (channel j pairs with
    j + D/2), in fp32, cast back to x's dtype."""
    xf = x.float()
    return (xf * cos + _rotate_half(xf) * sin).to(x.dtype)


class GQAttention(nn.Module):
    """Grouped-query causal self-attention with rotary positions, optional
    LoRA on the q and v projections (the Pink recipe: ``q_lora_a`` [in, r],
    ``q_lora_b`` [r, out], fp32, the delta computed in fp32) and the cached
    modes of the module docstring. With ``lora_freeze_base`` the adapted
    base projections are frozen at the weight."""

    LORA_TARGETS = ("q", "v")

    def __init__(self, dim: int, num_heads: int, num_kv_heads: Optional[int] = None,
                 rope_theta: float = 10000.0, lora_rank: int = 0, lora_alpha: float = 16.0,
                 lora_freeze_base: bool = True, dtype=torch.bfloat16, device=None):
        super().__init__()
        self.num_heads = num_heads
        self.num_kv_heads = num_kv_heads or num_heads
        self.head_dim = dim // num_heads
        self.rope_theta = rope_theta
        self.lora_scaling = lora_alpha / lora_rank if lora_rank > 0 else 0.0
        self.lora_targets = self.LORA_TARGETS if lora_rank > 0 else ()
        qf, kvf = num_heads * self.head_dim, self.num_kv_heads * self.head_dim
        for name, fin, fout in (("q", dim, qf), ("k", dim, kvf), ("v", dim, kvf), ("o", qf, dim)):
            frozen = name in self.lora_targets and lora_freeze_base
            setattr(self, f"{name}_proj", QuantDense(fin, fout, dtype, frozen, device))
            if name in self.lora_targets:
                setattr(self, f"{name}_lora_a",
                        nn.Parameter(torch.zeros(fin, lora_rank, device=device)))
                setattr(self, f"{name}_lora_b",
                        nn.Parameter(torch.zeros(lora_rank, fout, device=device)))

    def init_params(self, generator: torch.Generator) -> None:
        for name in self.lora_targets:  # the b matrices stay zero
            normal_(getattr(self, f"{name}_lora_a"), 0.02, generator)

    def _project(self, name: str, x: torch.Tensor) -> torch.Tensor:
        out = getattr(self, f"{name}_proj")(x)
        if name not in self.lora_targets:
            return out
        a, b = getattr(self, f"{name}_lora_a"), getattr(self, f"{name}_lora_b")
        delta = (x.float() @ a @ b) * self.lora_scaling
        return out + delta.to(out.dtype)

    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                bias: Optional[torch.Tensor] = None,
                cache: Optional[Dict[str, torch.Tensor]] = None,
                decode_pos: Optional[torch.Tensor] = None,
                rope_cs: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
        """x [B, L, C], positions int[B, L], ``bias`` the additive key-padding
        bias [B, 1, 1, L] (ignored in decode mode, which builds its own
        validity bias). Returns the output, and the cache when one is given."""
        B, L, _ = x.shape
        H, n_kv, D = self.num_heads, self.num_kv_heads, self.head_dim

        def heads(t: torch.Tensor, n: int) -> torch.Tensor:
            return t.view(B, L, n, D).transpose(1, 2)

        q = heads(self._project("q", x), H)
        k = heads(self._project("k", x), n_kv)
        v = heads(self._project("v", x), n_kv)
        if rope_cs is None:  # standalone use; DecoderLM hoists the tables
            rope_cs = rope_cos_sin(positions, D, self.rope_theta)
        q, k = apply_rope_cs(q, *rope_cs), apply_rope_cs(k, *rope_cs)

        if decode_pos is None:
            if cache is not None:  # prefill: the chunk lands at slots 0..L-1
                cache["k"][:, :, :L] = k
                cache["v"][:, :, :L] = v
            rep = H // n_kv
            if rep > 1:
                k, v = k.repeat_interleave(rep, dim=1), v.repeat_interleave(rep, dim=1)
            out = flash_attention(q, k, v, bias=bias, causal=True)
        else:
            if cache is None:
                raise ValueError("decode_pos needs a cache")
            T = cache["k"].shape[2]
            slots = decode_pos[:, None] + torch.arange(L, device=x.device)[None]  # [B, L]
            rows = torch.arange(B, device=x.device)[:, None]
            cache["k"][rows, :, slots] = k.transpose(1, 2).to(cache["k"].dtype)
            cache["v"][rows, :, slots] = v.transpose(1, 2).to(cache["v"].dtype)
            valid = torch.arange(T, device=x.device)[None, None] <= slots[:, :, None]
            step_bias = torch.where(valid, 0.0, MASKED)[:, None, None]  # [B, 1, 1, L, T]
            # grouped: the queries of a kv head's group share its cache rows
            qg = q.reshape(B, n_kv, H // n_kv, L, D)
            logits = torch.einsum("bgrqd,bgkd->bgrqk", qg.float(), cache["k"].float())
            logits = logits * D ** -0.5 + step_bias
            probs = torch.softmax(logits, dim=-1).to(x.dtype)
            out = torch.einsum("bgrqk,bgkd->bgrqd", probs, cache["v"].to(x.dtype))
            out = out.reshape(B, H, L, D)
        out = self._project("o", out.transpose(1, 2).reshape(B, L, H * D))
        return out if cache is None else (out, cache)


class SwiGLU(nn.Module):
    def __init__(self, dim: int, hidden_dim: int, dtype=torch.bfloat16, device=None):
        super().__init__()
        self.gate_proj = QuantDense(dim, hidden_dim, dtype, device=device)
        self.up_proj = QuantDense(dim, hidden_dim, dtype, device=device)
        self.down_proj = QuantDense(hidden_dim, dim, dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class DecoderLayer(nn.Module):
    def __init__(self, dim: int, num_heads: int, num_kv_heads: Optional[int] = None,
                 mlp_ratio: float = 2.6875, rope_theta: float = 10000.0, lora_rank: int = 0,
                 lora_alpha: float = 16.0, lora_freeze_base: bool = True,
                 dtype=torch.bfloat16, device=None):
        super().__init__()
        self.input_norm = RMSNorm(dim, dtype=dtype, device=device)
        self.attention = GQAttention(dim, num_heads, num_kv_heads, rope_theta, lora_rank,
                                     lora_alpha, lora_freeze_base, dtype, device)
        self.post_attn_norm = RMSNorm(dim, dtype=dtype, device=device)
        self.mlp = SwiGLU(dim, int(dim * mlp_ratio), dtype, device)

    def forward(self, x, positions, bias=None, cache=None, decode_pos=None, rope_cs=None):
        attn = self.attention(self.input_norm(x), positions, bias, cache, decode_pos, rope_cs)
        if cache is not None:
            attn, cache = attn
        x = x + attn
        out = x + self.mlp(self.post_attn_norm(x))
        return out if cache is None else (out, cache)


class DecoderLM(nn.Module):
    """Causal decoder over embedded inputs [B, L, hidden] (the caller embeds
    tokens, so multimodal prefixes can be spliced in); layers ``layer_{i}``
    and ``final_norm``."""

    def __init__(self, hidden: int, num_layers: int, num_heads: int,
                 num_kv_heads: Optional[int] = None, mlp_ratio: float = 2.6875,
                 rope_theta: float = 10000.0, lora_rank: int = 0, lora_alpha: float = 16.0,
                 lora_freeze_base: bool = True, dtype=torch.bfloat16, device=None):
        super().__init__()
        self.num_layers, self.num_heads = num_layers, num_heads
        self.num_kv_heads = num_kv_heads or num_heads
        self.head_dim = hidden // num_heads
        self.rope_theta = rope_theta
        self.dtype = dtype
        for i in range(num_layers):
            self.add_module(f"layer_{i}", DecoderLayer(
                hidden, num_heads, num_kv_heads, mlp_ratio, rope_theta, lora_rank, lora_alpha,
                lora_freeze_base, dtype, device))
        self.final_norm = RMSNorm(hidden, dtype=dtype, device=device)

    def forward(self, embeds: torch.Tensor, positions: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None,
                cache: Optional[List[Dict[str, torch.Tensor]]] = None,
                decode_pos: Optional[torch.Tensor] = None):
        """Without ``cache``: the causal forward (returns hidden). With
        ``cache``: ``(hidden, cache)``, prefill when ``decode_pos`` is None,
        an L-token decode chunk at ``decode_pos`` otherwise."""
        bias = None
        if decode_pos is None and attention_mask is not None:
            bias = torch.where(attention_mask[:, None, None, :] > 0, 0.0, MASKED).float()
        rope_cs = rope_cos_sin(positions, self.head_dim, self.rope_theta)
        x = embeds
        for i in range(self.num_layers):
            layer = getattr(self, f"layer_{i}")
            if cache is not None:
                x, _ = layer(x, positions, bias, cache[i], decode_pos, rope_cs)
            else:
                x = layer(x, positions, bias, rope_cs=rope_cs)
        x = self.final_norm(x)
        return x if cache is None else (x, cache)

    def make_cache(self, batch: int, max_len: int, dtype=None, device=None):
        return init_decoder_cache(self.num_layers, batch, self.num_kv_heads, max_len,
                                  self.head_dim, dtype or self.dtype, device)
