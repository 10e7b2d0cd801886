"""Decoder-only LM blocks: RMSNorm, 1D and 3D rotary embeddings,
grouped-query attention with a KV cache, SwiGLU, and the decoder stack.

Port of ``antmmf_tpu/modules/llm.py`` on the branches Pink training,
decode serving and M2-omni serving run (1D RoPE, M2-omni's 3D mRoPE, LoRA
on any of the attention projections and on the MLP's, Pink's serial
adapters, remat, the ``scan_layers`` weight layout, bf16 and int8 caches).
The KV cache is a list with one ``{"k", "v"}`` dict per layer, each [B,
n_kv_heads, T, head_dim] with keys stored after RoPE; it is preallocated
and written in place (the JAX package returns updated copies). Two cached
modes, as in JAX:

* prefill (``cache`` given, ``decode_pos`` None): the padded prompt chunk
  runs the normal causal forward and its k/v land at slots 0..L-1;
* decode (``decode_pos`` int[B]): an L-token chunk per row at contiguous
  slots ``decode_pos..decode_pos+L-1``; attention reads the whole cache
  with validity ``slot <= decode_pos + j`` for query j, grouped against
  the kv-head cache without repeating k/v.

Causal prefill and the cache-free (training) forward run
``ops.flash_attention`` with ``causal=True`` and the key-padding bias (k/v
repeated to the query heads, so the kv heads' gradients sum their groups):
on the card that is the hand-written flash kernel at every length, forward
and backward, where the JAX package takes an einsum core below 3072
tokens. A frozen projection (``lora_freeze_base``) is frozen at its weight,
so the activation gradient still flows through it. Decode attention
(1 to a few queries against T cached keys with a per-query validity bias)
is plain tensor ops, as it is outside any kernel in the JAX package.

LoRA (``lora_targets`` among q, k, v, o; ``lora_mlp`` on gate, up and
down) adds ``(x · a · b) · alpha / rank`` in fp32 with fp32 ``<name>_lora_a``
[in, r] and ``<name>_lora_b`` [r, out]; ``lora_freeze_base`` freezes the
adapted projections at the weight. ``SerialAdapter`` (``x + up(act(down(x)))``)
sits after ``input_norm`` (``adapter_attn``) and, with ``adapter_mlp``,
after ``post_attn_norm`` (``adapter_mlp_layer``). ``remat`` recomputes each
layer in the backward of the cache-free forward when gradients are on
(``layers.checkpointed``), so under training the flash forward runs twice a
layer. ``scan_layers`` is the JAX package's ``nn.scan`` over the layers: in
one process a scan is only a layout, so the port keeps its ``layer_{i}``
modules and the weight bridge (``utils/weights.py``) reads and writes the
stacked ``layers`` tree.

With ``rope_3d`` the positions are int[B, L, 3] (t, h, w) streams (text
tokens carry (p, p, p)) and the D/2 frequency channels split into the
``mrope_sections`` bands (16, 24, 24 at D=128), band i taking its angles
from axis i mod 3 (``rope_cos_sin_3d``); a text token's rotation is then
exactly the 1D rotation at p. Without ``rope_3d``, 3D streams are read at
their temporal channel (the JAX package's 1D ablation). ``DecoderLM``
computes either table once a forward and passes it to every layer (the
recompute of remat included), so the flag stops there; the JAX package
also threads it through its attention for standalone use. In decode the rotary position and the cache slot are two
arguments: M2-omni's RoPE position of a generated token is not its slot.

The int8 cache (``make_cache(quantized=True)``, the models' ``kv_int8``)
holds int8 ``k``, ``v`` and fp32 ``k_scale``, ``v_scale`` [B, n_kv, T, 1],
one max-abs/127 scale a (row, head, slot) (``quantize_kv``). Prefill writes
the quantised chunk and attends over its unquantised k/v, as JAX's does;
decode reads the int8 rows and folds the scales in JAX's order: the logits
times ``k_scale`` before the 1/√D, the probabilities (in the compute dtype)
times ``v_scale`` (``int8_scale_rows``).

``sequence_parallel`` (``ring`` or ``ulysses``) engages on the cache-free
forward under a registered mesh whose ``seq`` axis is above 1
(``parallel.mesh.active_seq_group``); elsewhere it changes nothing, and
decode with a cache stays data-parallel, as in JAX. ``DecoderLM`` then
pads the stream to a multiple of the axis size P (masked keys) and holds
its carry sharded, [B, L/P, C] a rank, from the first layer to the final
norm (JAX's ``shard_batch_dim(carry, seq=True)``); only attention mixes
positions. ``GQAttention`` runs the ring on its kv heads, or Ulysses after
expanding K/V locally, both causal (``parallel.long_context``). The caller
shards its labels with ``shard_stream`` and reduces its loss with
``token_mean``: the sums of the masked NLL and of the valid count over
every rank, then one division.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from antmmf_torch.modules.layers import checkpointed, normal_
from antmmf_torch.modules.qdense import QuantDense
from antmmf_torch.ops.flash_attention import flash_attention
from antmmf_torch.parallel import collectives as coll
from antmmf_torch.parallel.long_context import (check_mode, pad_shard, ring_attention,
                                                ulysses_attention)
from antmmf_torch.parallel.mesh import active_seq_group

MASKED = -1e30  # additive bias of a masked key, the JAX package's value


def init_decoder_cache(num_layers: int, batch: int, num_kv_heads: int, max_len: int,
                       head_dim: int, dtype=torch.bfloat16, device=None,
                       quantized: bool = False) -> List[Dict[str, torch.Tensor]]:
    """Zeroed per-layer KV cache for ``DecoderLM`` prefill and decode; with
    ``quantized`` int8 ``k``/``v`` and fp32 ``k_scale``/``v_scale``
    [B, n_kv, T, 1]."""
    shape = (batch, num_kv_heads, max_len, head_dim)
    if quantized:
        sshape = shape[:-1] + (1,)
        return [{"k": torch.zeros(shape, dtype=torch.int8, device=device),
                 "k_scale": torch.zeros(sshape, device=device),
                 "v": torch.zeros(shape, dtype=torch.int8, device=device),
                 "v_scale": torch.zeros(sshape, device=device)}
                for _ in range(num_layers)]
    return [{"k": torch.zeros(shape, dtype=dtype, device=device),
             "v": torch.zeros(shape, dtype=dtype, device=device)}
            for _ in range(num_layers)]


def quantize_kv(t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 per (row, head, slot): [..., D] → (int8 [..., D], fp32
    scale [..., 1]), the scale max|t|/127 floored at 1e-8/127."""
    tf = t.float()
    scale = tf.abs().amax(dim=-1, keepdim=True).clamp(min=1e-8) / 127.0
    return torch.round(tf / scale).clamp(-127, 127).to(torch.int8), scale


def int8_scale_rows(cache: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """The int8 cache's key and value scales as rows [B, n_kv, 1, T], which
    decode attention folds into its logits and probabilities."""
    return cache["k_scale"][..., 0][:, :, None], cache["v_scale"][..., 0][:, :, None]


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


def mrope_sections(half: int) -> tuple:
    """The temporal/height/width split of the D/2 frequency channels, the
    Qwen2-VL ratio (16/24/24 of 64): h = w = round(3·half/8), t the rest."""
    hw = max(1, round(3 * half / 8))
    return (half - 2 * hw, hw, hw)


def rope_cos_sin_3d(positions: torch.Tensor, head_dim: int, theta: float = 10000.0,
                    sections: Optional[Sequence[int]] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) tables [B, 1, L, D] fp32 for 3D positions int[B, L, 3]:
    one inverse-frequency table over the head width, its channels in
    ``sections`` bands, band i rotated by the positions of axis i mod 3."""
    half = head_dim // 2
    sections = tuple(sections) if sections else mrope_sections(half)
    if sum(sections) != half:
        raise ValueError(f"mrope sections {sections} do not sum to {half}")
    inv = rope_frequencies(head_dim, theta, positions.device)
    axis = torch.cat([torch.full((s,), i % 3, dtype=torch.long)
                      for i, s in enumerate(sections)]).to(positions.device)
    freqs = positions[..., axis].float() * inv  # [B, L, half]
    emb = torch.cat([freqs, freqs], dim=-1)[:, None]
    return torch.cos(emb), torch.sin(emb)


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float, rope_3d: bool
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The 3D tables with ``rope_3d``; else the 1D tables, of the temporal
    channel when the positions are 3D streams."""
    if rope_3d:
        return rope_cos_sin_3d(positions, head_dim, theta)
    if positions.dim() == 3:
        positions = positions[..., 0]
    return rope_cos_sin(positions, head_dim, theta)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope_cs(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotary embedding in the rotate-half convention (channel j pairs with
    j + D/2), in fp32, cast back to x's dtype."""
    xf = x.float()
    return (xf * cos + _rotate_half(xf) * sin).to(x.dtype)


def token_mean(nll_sum: torch.Tensor, hits: torch.Tensor, count: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(the LM loss, its accuracy) from this rank's sums of masked NLL, of
    argmax hits and of valid labels: over ranks each sum is all-reduced
    over every rank (``data`` × ``seq``) before the division, the NLL's
    with gradients (``collectives.all_reduce_sum``), so the loss is the
    global batch's token mean. The count is at least 1."""
    if coll.is_distributed():
        nll_sum = coll.all_reduce_sum(nll_sum)
        hits = coll.all_reduce_(torch.as_tensor(hits).detach().clone())
        count = coll.all_reduce_(torch.as_tensor(count).detach().clone())
    denom = torch.as_tensor(count).clamp(min=1)
    return nll_sum / denom, hits / denom


def lora_delta(out: torch.Tensor, x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
               scaling: float) -> torch.Tensor:
    """``out + (x · a · b) · scaling``, the delta in fp32, cast to out's dtype."""
    return out + ((x.float() @ a @ b) * scaling).to(out.dtype)


class GQAttention(nn.Module):
    """Grouped-query causal self-attention with rotary positions, optional
    LoRA on the projections of ``lora_targets`` (the Pink recipe q and v,
    M2-omni's all four; ``q_lora_a`` [in, r], ``q_lora_b`` [r, out], fp32, the
    delta computed in fp32) and the cached modes of the module docstring.
    With ``lora_freeze_base`` the adapted base projections are frozen at the
    weight."""

    def __init__(self, dim: int, num_heads: int, num_kv_heads: Optional[int] = None,
                 rope_theta: float = 10000.0, lora_rank: int = 0, lora_alpha: float = 16.0,
                 lora_freeze_base: bool = True, dtype=torch.bfloat16, device=None,
                 lora_targets: Sequence[str] = ("q", "v"), sequence_parallel: str = "none"):
        super().__init__()
        self.sequence_parallel = check_mode(sequence_parallel)
        self.num_heads = num_heads
        self.num_kv_heads = num_kv_heads or num_heads
        self.head_dim = dim // num_heads
        self.rope_theta = rope_theta
        self.lora_scaling = lora_alpha / lora_rank if lora_rank > 0 else 0.0
        self.lora_targets = tuple(lora_targets) if lora_rank > 0 else ()
        if set(self.lora_targets) - {"q", "k", "v", "o"}:
            raise ValueError(f"lora_targets {lora_targets} are not among q, k, v, o")
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
        return lora_delta(out, x, getattr(self, f"{name}_lora_a"),
                          getattr(self, f"{name}_lora_b"), self.lora_scaling)

    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                bias: Optional[torch.Tensor] = None,
                cache: Optional[Dict[str, torch.Tensor]] = None,
                decode_pos: Optional[torch.Tensor] = None,
                rope_cs: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
        """x [B, L, C], positions int[B, L] (read only without ``rope_cs``,
        the tables ``DecoderLM`` hoists), ``bias`` the additive key-padding
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

        group = active_seq_group() if cache is None and self.sequence_parallel != "none" \
            else None
        if group is not None:  # x is this rank's slice of the stream
            if self.sequence_parallel == "ulysses":
                rep = H // n_kv
                out = ulysses_attention(q, k.repeat_interleave(rep, dim=1),
                                        v.repeat_interleave(rep, dim=1), group, bias=bias,
                                        causal=True)
            else:  # the ring rotates K/V at the kv-head count
                out = ring_attention(q, k, v, group, bias=bias, causal=True)
            return self._project("o", out.transpose(1, 2).reshape(B, L, H * D))

        quant = cache is not None and "k_scale" in cache
        if decode_pos is None:
            if quant:  # prefill attends over the unquantised chunk, as JAX's does
                for name, t in (("k", k), ("v", v)):
                    cache[name][:, :, :L], cache[f"{name}_scale"][:, :, :L] = quantize_kv(t)
            elif cache is not None:  # prefill: the chunk lands at slots 0..L-1
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
            for name, t in (("k", k), ("v", v)):
                if quant:
                    tq, scale = quantize_kv(t)
                    cache[name][rows, :, slots] = tq.transpose(1, 2)
                    cache[f"{name}_scale"][rows, :, slots] = scale.transpose(1, 2)
                else:
                    cache[name][rows, :, slots] = t.transpose(1, 2).to(cache[name].dtype)
            valid = torch.arange(T, device=x.device)[None, None] <= slots[:, :, None]
            step_bias = torch.where(valid, 0.0, MASKED)[:, None, None]  # [B, 1, 1, L, T]
            # grouped: the queries of a kv head's group share its cache rows
            qg = q.reshape(B, n_kv, H // n_kv, L, D)
            logits = torch.einsum("bgrqd,bgkd->bgrqk", qg.float(), cache["k"].float())
            if quant:
                k_row, v_row = int8_scale_rows(cache)
                logits = logits * k_row[:, :, None]
            logits = logits * D ** -0.5 + step_bias
            probs = torch.softmax(logits, dim=-1).to(x.dtype)
            if quant:
                probs = probs * v_row[:, :, None].to(probs.dtype)
            out = torch.einsum("bgrqk,bgkd->bgrqd", probs, cache["v"].to(x.dtype))
            out = out.reshape(B, H, L, D)
        out = self._project("o", out.transpose(1, 2).reshape(B, L, H * D))
        return out if cache is None else (out, cache)


class SwiGLU(nn.Module):
    """down(silu(gate(x)) · up(x)); with ``lora_rank`` > 0 (``lora_mlp``)
    LoRA on all three projections (``gate_lora_a`` ...), whose bases
    ``lora_freeze_base`` freezes at the weight."""

    def __init__(self, dim: int, hidden_dim: int, dtype=torch.bfloat16, device=None,
                 lora_rank: int = 0, lora_alpha: float = 16.0, lora_freeze_base: bool = True):
        super().__init__()
        self.lora_scaling = lora_alpha / lora_rank if lora_rank > 0 else 0.0
        self.lora_targets = ("gate", "up", "down") if lora_rank > 0 else ()
        frozen = lora_rank > 0 and lora_freeze_base
        for name, fin, fout in (("gate", dim, hidden_dim), ("up", dim, hidden_dim),
                                ("down", hidden_dim, dim)):
            setattr(self, f"{name}_proj", QuantDense(fin, fout, dtype, frozen, device))
            if lora_rank > 0:
                setattr(self, f"{name}_lora_a",
                        nn.Parameter(torch.zeros(fin, lora_rank, device=device)))
                setattr(self, f"{name}_lora_b",
                        nn.Parameter(torch.zeros(lora_rank, fout, device=device)))

    def init_params(self, generator: torch.Generator) -> None:
        for name in self.lora_targets:  # the b matrices stay zero
            normal_(getattr(self, f"{name}_lora_a"), 0.02, generator)

    def _project(self, name: str, x: torch.Tensor) -> torch.Tensor:
        out = getattr(self, f"{name}_proj")(x)
        if not self.lora_targets:
            return out
        return lora_delta(out, x, getattr(self, f"{name}_lora_a"),
                          getattr(self, f"{name}_lora_b"), self.lora_scaling)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._project("down", F.silu(self._project("gate", x)) * self._project("up", x))


class SerialAdapter(nn.Module):
    """Pink's bottleneck adapter: ``x + up(act(down(x)))``, biased ``down``
    [dim → hidden_dim] and ``up``, the activation SiLU with ``non_linear``
    and the identity without."""

    def __init__(self, dim: int, hidden_dim: int = 8, non_linear: bool = False,
                 dtype=torch.bfloat16, device=None):
        super().__init__()
        self.non_linear = non_linear
        self.down = nn.Linear(dim, hidden_dim, dtype=dtype, device=device)
        self.up = nn.Linear(hidden_dim, dim, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.down(x)
        return x + self.up(F.silu(h) if self.non_linear else h)


class DecoderLayer(nn.Module):
    def __init__(self, dim: int, num_heads: int, num_kv_heads: Optional[int] = None,
                 mlp_ratio: float = 2.6875, rope_theta: float = 10000.0, lora_rank: int = 0,
                 lora_alpha: float = 16.0, lora_freeze_base: bool = True,
                 dtype=torch.bfloat16, device=None, lora_targets: Sequence[str] = ("q", "v"),
                 lora_mlp: bool = False, adapter_dim: int = 0, adapter_mlp: bool = False,
                 adapter_non_linear: bool = False, sequence_parallel: str = "none"):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.input_norm = RMSNorm(dim, **kw)
        self.adapter_attn = (SerialAdapter(dim, adapter_dim, adapter_non_linear, **kw)
                             if adapter_dim else None)
        self.attention = GQAttention(dim, num_heads, num_kv_heads, rope_theta, lora_rank,
                                     lora_alpha, lora_freeze_base, lora_targets=lora_targets,
                                     sequence_parallel=sequence_parallel, **kw)
        self.post_attn_norm = RMSNorm(dim, **kw)
        self.adapter_mlp_layer = (SerialAdapter(dim, adapter_dim, adapter_non_linear, **kw)
                                  if adapter_dim and adapter_mlp else None)
        self.mlp = SwiGLU(dim, int(dim * mlp_ratio), lora_rank=lora_rank if lora_mlp else 0,
                          lora_alpha=lora_alpha, lora_freeze_base=lora_freeze_base, **kw)

    def forward(self, x, positions, bias=None, cache=None, decode_pos=None, rope_cs=None):
        h = self.input_norm(x)
        if self.adapter_attn is not None:
            h = self.adapter_attn(h)
        attn = self.attention(h, positions, bias, cache, decode_pos, rope_cs)
        if cache is not None:
            attn, cache = attn
        x = x + attn
        h = self.post_attn_norm(x)
        if self.adapter_mlp_layer is not None:
            h = self.adapter_mlp_layer(h)
        out = x + self.mlp(h)
        return out if cache is None else (out, cache)


class DecoderLM(nn.Module):
    """Causal decoder over embedded inputs [B, L, hidden] (the caller embeds
    tokens, so multimodal prefixes can be spliced in); layers ``layer_{i}``
    and ``final_norm``. ``rope_3d``, ``remat``, ``scan_layers`` and
    ``sequence_parallel`` as the module docstring says."""

    def __init__(self, hidden: int, num_layers: int, num_heads: int,
                 num_kv_heads: Optional[int] = None, mlp_ratio: float = 2.6875,
                 rope_theta: float = 10000.0, lora_rank: int = 0, lora_alpha: float = 16.0,
                 lora_freeze_base: bool = True, dtype=torch.bfloat16, device=None,
                 lora_targets: Sequence[str] = ("q", "v"), lora_mlp: bool = False,
                 adapter_dim: int = 0, adapter_mlp: bool = False,
                 adapter_non_linear: bool = False, remat: bool = False,
                 scan_layers: bool = False, rope_3d: bool = False,
                 sequence_parallel: str = "none"):
        super().__init__()
        self.rope_3d = rope_3d
        self.sequence_parallel = check_mode(sequence_parallel)
        self.num_layers, self.num_heads = num_layers, num_heads
        self.num_kv_heads = num_kv_heads or num_heads
        self.head_dim = hidden // num_heads
        self.rope_theta = rope_theta
        self.dtype = dtype
        self.remat, self.scan_layers = remat, scan_layers
        for i in range(num_layers):
            self.add_module(f"layer_{i}", DecoderLayer(
                hidden, num_heads, num_kv_heads, mlp_ratio, rope_theta, lora_rank, lora_alpha,
                lora_freeze_base, dtype, device, lora_targets, lora_mlp, adapter_dim,
                adapter_mlp, adapter_non_linear, sequence_parallel))
        self.final_norm = RMSNorm(hidden, dtype=dtype, device=device)

    def forward(self, embeds: torch.Tensor, positions: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None,
                cache: Optional[List[Dict[str, torch.Tensor]]] = None,
                decode_pos: Optional[torch.Tensor] = None):
        """Without ``cache``: the causal forward (returns hidden; this rank's
        slice of the padded stream when ``seq_group`` gives a group, see
        ``shard_stream``). With ``cache``: ``(hidden, cache)``, prefill when
        ``decode_pos`` is None, an L-token decode chunk at cache slot
        ``decode_pos`` otherwise; the rotary positions are ``positions`` in
        every mode."""
        group = self.seq_group() if cache is None else None
        if group is not None:
            if attention_mask is None:
                attention_mask = torch.ones(embeds.shape[:2], dtype=torch.long,
                                            device=embeds.device)
            embeds, positions, attention_mask = (
                pad_shard(t, group, 1, 0) for t in (embeds, positions, attention_mask))
        bias = None
        if decode_pos is None and attention_mask is not None:
            bias = torch.where(attention_mask[:, None, None, :] > 0, 0.0, MASKED).float()
        rope_cs = rope_tables(positions, self.head_dim, self.rope_theta, self.rope_3d)
        remat = self.remat and cache is None and torch.is_grad_enabled()
        x = embeds
        for i in range(self.num_layers):
            layer = getattr(self, f"layer_{i}")
            if cache is not None:
                x, _ = layer(x, positions, bias, cache[i], decode_pos, rope_cs)
            elif remat:
                x = checkpointed(layer, x, positions, bias, None, None, rope_cs)
            else:
                x = layer(x, positions, bias, rope_cs=rope_cs)
        x = self.final_norm(x)
        return x if cache is None else (x, cache)

    def seq_group(self):
        """The ``seq`` group the cache-free forward shards its stream over,
        or ``None`` (no knob, or no registered mesh with ``seq`` > 1)."""
        return active_seq_group() if self.sequence_parallel != "none" else None

    @staticmethod
    def shard_stream(x: torch.Tensor, group, value=0) -> torch.Tensor:
        """This rank's slice of a whole-stream tensor [B, L, ...] (labels,
        say) as the forward shards its stream: padded along L with ``value``
        to a multiple of the axis size, then sliced."""
        return pad_shard(x, group, 1, value)

    def make_cache(self, batch: int, max_len: int, dtype=None, device=None,
                   quantized: bool = False):
        return init_decoder_cache(self.num_layers, batch, self.num_kv_heads, max_len,
                                  self.head_dim, dtype or self.dtype, device, quantized)
