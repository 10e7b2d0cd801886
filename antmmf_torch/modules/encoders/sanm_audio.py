"""SANM audio encoder: M2-omni's faithful Bailing2 speech tower.

Port of ``antmmf_tpu/modules/encoders/sanm_audio.py``: LFR fbank features
[B, T, 560] scaled by √output_size plus sinusoidal positions (1..T, depth
the input width), then ``num_blocks`` pre-LN SAN-M layers and
``after_norm``. A layer is norm1 → SANM attention (+ the residual only where
the input width equals the output width, so the first 560 → 512 layer has
none) → norm2 → ``w_1`` → ReLU → ``w_2`` → + residual. SANM attention is
multi-head attention over a fused ``linear_q_k_v`` projection plus an FSMN
memory: a depthwise convolution (kernel k, no bias) over the un-headed
values, left-padded by (k − 1) // 2 + ``sanm_shift``, plus those values,
both masked. Masked keys get finfo.min before the softmax and 0 after it,
so a fully masked row attends to nothing. LayerNorms use flax's eps 1e-6.

``fsmn_kernel`` is held in the depthwise ``Conv1d`` layout [d, 1, k]; the
weight bridge transposes flax's [k, 1, d]. The attention is plain tensor
ops, as it is an inline einsum in the JAX package. ``compress_audio_tokens``
concatenates each ``compress`` consecutive frames channel-wise.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from antmmf_torch.modules.layers import ScaleLayerNorm, normal_

SANM_PRESETS = {
    "bailing2_audio": dict(input_size=560, output_size=512, attention_heads=4,
                           linear_units=2048, num_blocks=50, kernel_size=11, sanm_shift=0),
    "sanm_tiny_test": dict(input_size=24, output_size=16, attention_heads=2, linear_units=32,
                           num_blocks=3, kernel_size=5, sanm_shift=0),
}


def sinusoidal_positions(timesteps: int, depth: int) -> np.ndarray:
    """funasr's SinusoidalPositionEncoder: positions 1..T, depth/2 timescales,
    concat(sin, cos) → [1, T, depth] fp32."""
    positions = np.arange(1, timesteps + 1, dtype=np.float32)
    log_inc = np.log(10000.0) / (depth / 2 - 1)
    inv = np.exp(np.arange(depth // 2, dtype=np.float32) * -log_inc)
    scaled = positions[:, None] * inv[None, :]
    return np.concatenate([np.sin(scaled), np.cos(scaled)], axis=1)[None]


class SANMAttention(nn.Module):
    def __init__(self, in_features: int, num_heads: int, out_features: int,
                 kernel_size: int = 11, sanm_shift: int = 0, dtype=torch.bfloat16, device=None):
        super().__init__()
        self.num_heads, self.out_features = num_heads, out_features
        self.kernel_size, self.sanm_shift = kernel_size, sanm_shift
        kw = dict(dtype=dtype, device=device)
        self.linear_q_k_v = nn.Linear(in_features, 3 * out_features, **kw)
        self.fsmn_kernel = nn.Parameter(torch.zeros(out_features, 1, kernel_size, device=device))
        self.linear_out = nn.Linear(out_features, out_features, **kw)

    def init_params(self, generator: torch.Generator) -> None:
        normal_(self.fsmn_kernel, 0.02, generator)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x [B, T, in], mask int[B, T] 1 = valid."""
        B, T, _ = x.shape
        d, h = self.out_features, self.num_heads
        dk = d // h
        q, k, v = self.linear_q_k_v(x).split(d, dim=-1)
        keep = None if mask is None else mask[:, :, None].to(v.dtype)
        vm = v if keep is None else v * keep
        left = (self.kernel_size - 1) // 2 + self.sanm_shift
        pad = F.pad(vm.float().transpose(1, 2), (left, self.kernel_size - 1 - left))
        mem = F.conv1d(pad, self.fsmn_kernel, groups=d).transpose(1, 2).to(v.dtype) + vm
        if keep is not None:
            mem = mem * keep

        def heads(t):
            return t.reshape(B, T, h, dk).transpose(1, 2)

        scores = torch.matmul((heads(q) * dk ** -0.5).float(), heads(k).float().transpose(-1, -2))
        if mask is not None:
            bad = (mask == 0)[:, None, None, :]
            scores = scores.masked_fill(bad, torch.finfo(torch.float32).min)
        attn = torch.softmax(scores, dim=-1)
        if mask is not None:
            attn = attn.masked_fill(bad, 0.0)
        out = torch.matmul(attn.to(v.dtype), heads(v)).transpose(1, 2).reshape(B, T, d)
        return self.linear_out(out) + mem


class SANMEncoderLayer(nn.Module):
    def __init__(self, in_features: int, num_heads: int, out_features: int,
                 linear_units: int, kernel_size: int = 11, sanm_shift: int = 0,
                 dtype=torch.bfloat16, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.residual = in_features == out_features
        self.norm1 = ScaleLayerNorm(in_features, 1e-6, **kw)
        self.self_attn = SANMAttention(in_features, num_heads, out_features, kernel_size,
                                       sanm_shift, **kw)
        self.norm2 = ScaleLayerNorm(out_features, 1e-6, **kw)
        self.w_1 = nn.Linear(out_features, linear_units, **kw)
        self.w_2 = nn.Linear(linear_units, out_features, **kw)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        att = self.self_attn(self.norm1(x), mask)
        x = x + att if self.residual else att
        return x + self.w_2(torch.relu(self.w_1(self.norm2(x))))


class SANMEncoder(nn.Module):
    """feats [B, T, input_size] (+ mask int[B, T]) → [B, T, output_size]; no
    subsampling (the LFR front end already decimated 6×)."""

    def __init__(self, input_size: int = 560, output_size: int = 512, attention_heads: int = 4,
                 linear_units: int = 2048, num_blocks: int = 50, kernel_size: int = 11,
                 sanm_shift: int = 0, dtype=torch.bfloat16, device=None):
        super().__init__()
        self.output_size, self.num_blocks, self.dtype = output_size, num_blocks, dtype
        kw = dict(dtype=dtype, device=device)
        for i in range(num_blocks):
            self.add_module(f"layer_{i}", SANMEncoderLayer(
                input_size if i == 0 else output_size, attention_heads, output_size,
                linear_units, kernel_size, sanm_shift, **kw))
        self.after_norm = ScaleLayerNorm(output_size, 1e-6, **kw)

    def forward(self, feats: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        B, T, D = feats.shape
        x = feats.to(self.dtype) * (self.output_size ** 0.5)
        x = x + torch.from_numpy(sinusoidal_positions(T, D)).to(x.device, self.dtype)
        for i in range(self.num_blocks):
            x = getattr(self, f"layer_{i}")(x, mask)
        return self.after_norm(x)


def compress_audio_tokens(x: torch.Tensor, compress: int = 3) -> torch.Tensor:
    """Groups of ``compress`` consecutive frames concatenated channel-wise;
    the frames left over dropped."""
    B, T, D = x.shape
    valid = T // compress * compress
    return x[:, :valid].reshape(B, valid // compress, D * compress)


def build_sanm_encoder(preset: str = "bailing2_audio", **overrides) -> SANMEncoder:
    if preset not in SANM_PRESETS:
        raise KeyError(f"Unknown SANM preset {preset!r}; known: {sorted(SANM_PRESETS)}")
    return SANMEncoder(**{**SANM_PRESETS[preset], **overrides})
