"""Multi-head attention with its core routed to the hand-written kernels.

Port of ``antmmf_tpu/modules/attention.py`` (``xla_attention_core``,
``attention_core`` and ``MultiHeadAttention`` with its cross-attention and
incremental-decoding branches). Routing is by structure alone, decided
before any kernel is tried:

* head widths that neither kernel family instantiates (D not in
  ``HEAD_DIMS``), and one-token decode calls against a cache
  (``use_kernels=False``, as the JAX package passes ``use_pallas=False``
  there): the einsum core, where the JAX router takes its XLA core;
* query- or head-dependent biases: the einsum core, as the JAX router sends
  such biases to its XLA core;
* no bias or a key-padding bias [B|1, 1, 1, Lk], self-attention at L <= 256:
  ``ops.small_attention`` (kernel K1);
* the same biases past 256 tokens, or Lq ≠ Lk: ``ops.flash_attention`` (the
  flash forward, dQ and dK/dV kernels).

``dropout`` acts on the heads' attention output before ``out_proj``, as the
JAX module drops it (not the probabilities), so the kernels see no dropout.

A call that asks for the attention probabilities (``return_probs``, the
word-importance pass) takes the einsum core by structure, as the JAX
module takes its XLA core for them: the kernels return no probabilities.

Both kernel ops are autograd Functions. On the CPU they compute their plain
versions; on the card a call the router gave a kernel that the kernel
refuses (a dtype it does not take, a launch that fails) raises and never
falls back to the einsum core.

``sequence_parallel`` (``ring`` or ``ulysses``) engages where the JAX
module's does: self-attention with a key-padding bias or none, under a
registered mesh whose ``seq`` axis is above 1 (``parallel.mesh``). The
stream stays whole outside attention, as JAX's layout leaves an encoder:
``parallel.long_context.sp_attention`` takes this rank's slice, runs the
exchange or the ring (Ulysses' local attention through ``attention_core``
above), and gathers the output. Elsewhere the knob changes nothing. The
fused QKV projection and ``sow_attention`` are not ported.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from antmmf_torch.modules.layers import Dropout
from antmmf_torch.ops.flash_attention import flash_attention
from antmmf_torch.ops.small_attention import HEAD_DIMS, MAX_L, einsum_attention, small_attention
from antmmf_torch.parallel.long_context import check_mode, sp_attention
from antmmf_torch.parallel.mesh import active_seq_group

MASKED = -1e30  # the JAX package's additive mask for causal and decode-cache slots


def attention_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   bias: Optional[torch.Tensor] = None,
                   scale: Optional[float] = None, use_kernels: bool = True) -> torch.Tensor:
    """softmax(q·kᵀ·scale + bias)·v over q [B, H, Lq, D] and k, v [B, H, Lk, D],
    routed as the module docstring says (both kernel families instantiate
    the same head widths, ``HEAD_DIMS``)."""
    if not use_kernels or q.shape[-1] not in HEAD_DIMS:
        return einsum_attention(q, k, v, bias=bias, scale=scale)
    if bias is not None and bias.dim() == 4:
        if bias.shape[1] > 1 or bias.shape[2] > 1:
            return einsum_attention(q, k, v, bias=bias, scale=scale)
        # a key bias broadcast over the batch (a causal mask over one token)
        bias = bias.expand(q.shape[0], 1, 1, k.shape[2])
    if q.shape[2] == k.shape[2] <= MAX_L:
        return small_attention(q, k, v, bias=bias, scale=scale)
    return flash_attention(q, k, v, bias=bias, scale=scale)


def attention_probs(q: torch.Tensor, k: torch.Tensor, bias: Optional[torch.Tensor] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """fp32 softmax(q·kᵀ·scale + bias) [B, H, Lq, Lk], ``einsum_attention``'s
    probabilities."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        logits = logits + bias
    return torch.softmax(logits, dim=-1)


class MultiHeadAttention(nn.Module):
    """Self- or cross-attention with separate q/k/v projections (flax names
    ``q_proj``/``k_proj``/``v_proj``/``out_proj``). ``bias`` is an additive
    fp32 mask (see ``layers.make_attention_mask``).

    ``forward(x, bias, kv=None, ...)``: with ``kv`` [B, Lk, C] the keys and
    values come from it (cross-attention). Incremental decoding, as in the
    JAX module:

    * ``return_kv``: project ``kv`` once and return its (k, v) heads
      [B, H, Lk, D], for reuse as ``cached_kv`` (the cross-attention memory,
      primed once per request);
    * ``cached_kv`` (k, v): skip the k/v projections;
    * ``cache`` {"k", "v"} [B, H, T, D] with ``decode_pos`` int[B]: one-token
      self-attention; each row's k/v is written in place at its slot, the
      row attends to slots <= its position, and the call returns
      (out, cache);
    * ``return_probs``: (out, probabilities [B, H, Lq, Lk]) from the einsum
      core.

    ``dropout`` drops the attention output of the self- and cross-attention
    calls (not of the decode branches), in a training forward's ``draws``
    scope."""

    def __init__(self, dim: int, num_heads: int, dtype=torch.bfloat16, device=None,
                 dropout: float = 0.0, sequence_parallel: str = "none"):
        super().__init__()
        if dim % num_heads:
            raise ValueError(f"width {dim} is not divisible by {num_heads} heads")
        self.num_heads = num_heads
        self.sequence_parallel = check_mode(sequence_parallel)
        kw = dict(dtype=dtype, device=device)
        self.q_proj = nn.Linear(dim, dim, **kw)
        self.k_proj = nn.Linear(dim, dim, **kw)
        self.v_proj = nn.Linear(dim, dim, **kw)
        self.out_proj = nn.Linear(dim, dim, **kw)
        self.dropout = Dropout(dropout)

    def _heads(self, t: torch.Tensor) -> torch.Tensor:
        # a strided [B, H, L, D] view of [B, L, H, D]: the kernels read it in
        # place, without a transposed copy
        B, L, C = t.shape
        return t.view(B, L, self.num_heads, C // self.num_heads).transpose(1, 2)

    def _out(self, out: torch.Tensor) -> torch.Tensor:
        B, H, L, D = out.shape
        return self.out_proj(out.transpose(1, 2).reshape(B, L, H * D))

    def forward(self, x: torch.Tensor, bias: Optional[torch.Tensor] = None,
                kv: Optional[torch.Tensor] = None, return_kv: bool = False,
                cached_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                cache: Optional[Dict[str, torch.Tensor]] = None,
                decode_pos: Optional[torch.Tensor] = None, return_probs: bool = False):
        kv = x if kv is None else kv
        if return_kv:
            return self._heads(self.k_proj(kv)), self._heads(self.v_proj(kv))
        q = self._heads(self.q_proj(x))
        if cached_kv is not None:
            return self._out(attention_core(q, *cached_kv, bias=bias))
        if cache is not None:
            if decode_pos is None or x.shape[1] != 1:
                raise ValueError("a decode-cache call takes x [B, 1, C] and decode_pos int[B]")
            B, T = x.shape[0], cache["k"].shape[2]
            rows = torch.arange(B, device=x.device)
            cache["k"][rows, :, decode_pos] = self._heads(self.k_proj(x))[:, :, 0].to(
                cache["k"].dtype)
            cache["v"][rows, :, decode_pos] = self._heads(self.v_proj(x))[:, :, 0].to(
                cache["v"].dtype)
            valid = torch.arange(T, device=x.device)[None] <= decode_pos[:, None]
            step_bias = torch.where(valid, 0.0, MASKED)[:, None, None, :]
            out = attention_core(q, cache["k"], cache["v"], bias=step_bias, use_kernels=False)
            return self._out(out), cache
        k, v = self._heads(self.k_proj(kv)), self._heads(self.v_proj(kv))
        if return_probs:
            probs = attention_probs(q, k, bias)
            out = torch.einsum("bhqk,bhkd->bhqd", probs.to(v.dtype), v)
            return self._out(self.dropout(out)), probs
        group = active_seq_group() if self.sequence_parallel != "none" else None
        key_only = bias is None or (bias.dim() == 4 and bias.shape[1] == bias.shape[2] == 1)
        if group is not None and kv is x and key_only:
            out = sp_attention(self.sequence_parallel, q, k, v, group, bias=bias)
            return self._out(self.dropout(out))
        return self._out(self.dropout(attention_core(q, k, v, bias=bias)))
