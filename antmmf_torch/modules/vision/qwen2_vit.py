"""Qwen2-ViT: M2-omni's image and video tower.

Port of ``antmmf_tpu/modules/vision/qwen2_vit.py``. Frames [B, T, H, W, 3]
(a single image is tiled to T = ``temporal_patch_size``) are cut into
patches of ``temporal_patch_size`` × ``patch_size``² laid out in the
spatial-merge order (t, h/m, w/m, m, m), each patch a vector in (C, tps, ps,
ps) order, and embedded by ``patch_embed``, a bias-free Linear (the
reference's stride-equal Conv3d). Attention runs per temporal group (the
groups folded into the batch), with a 2D rotary embedding of the patch's
(h, w) ids over the head's two halves (``vision_rope_freqs``, applied in fp32
and cast back). The blocks are pre-LN (eps 1e-6) with quick-GELU MLPs;
``vit_lora_rank`` puts LoRA on every block's qkv, proj, fc1 and fc2 over
frozen bases (weight and bias). The PatchMerger normalises (``ln_q``),
groups each m² consecutive tokens and maps them through ``merger_fc1``,
exact-erf GELU and ``merger_fc2`` into ``hidden_size``.

The attention is plain tensor ops: in the JAX package it is an inline
einsum outside any kernel, and its heads are 80 wide. The logits are fp32
products of the compute-dtype q and k, as JAX's ``preferred_element_type``.
``remat`` recomputes each block in the backward when gradients are on.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from antmmf_torch.modules.layers import ScaleLayerNorm, checkpointed, normal_, quick_gelu
from antmmf_torch.modules.llm import lora_delta

QWEN2_VIT_PRESETS = {
    "qwen2_vit": dict(depth=32, embed_dim=1280, hidden_size=8192, mlp_ratio=4.0, num_heads=16,
                      patch_size=14, spatial_merge_size=2, temporal_patch_size=2),
    "qwen2_vit_tiny_test": dict(depth=2, embed_dim=32, hidden_size=48, mlp_ratio=2.0,
                                num_heads=2, patch_size=4, spatial_merge_size=2,
                                temporal_patch_size=2),
}


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def vision_rope_freqs(hpos: np.ndarray, wpos: np.ndarray, head_dim: int,
                      theta: float = 10000.0) -> np.ndarray:
    """(h, w) ids [L] → angles [L, head_dim/2]: the first head_dim/4 channels
    from h, the next head_dim/4 from w."""
    dim = head_dim // 2
    inv = 1.0 / (theta ** (np.arange(0, dim, 2, dtype=np.float32) / dim))
    fh = hpos[:, None].astype(np.float32) * inv[None]
    fw = wpos[:, None].astype(np.float32) * inv[None]
    return np.concatenate([fh, fw], axis=-1)


def apply_vision_rope(x: torch.Tensor, freqs: torch.Tensor) -> torch.Tensor:
    """x [B, H, L, D], angles [L, D/2]: rotate-half in fp32, cast back."""
    emb = torch.cat([freqs, freqs], dim=-1)[None, None]
    xf = x.float()
    return (xf * torch.cos(emb) + _rotate_half(xf) * torch.sin(emb)).to(x.dtype)


class Qwen2VisionBlock(nn.Module):
    LORA = ("qkv", "proj", "fc1", "fc2")

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float, lora_rank: int = 0,
                 lora_alpha: float = 16.0, lora_freeze_base: bool = True,
                 dtype=torch.bfloat16, device=None):
        super().__init__()
        self.num_heads = num_heads
        self.lora_rank = lora_rank
        self.lora_scaling = lora_alpha / lora_rank if lora_rank > 0 else 0.0
        kw = dict(dtype=dtype, device=device)
        mlp = int(dim * mlp_ratio)
        self.norm1 = ScaleLayerNorm(dim, 1e-6, **kw)
        self.norm2 = ScaleLayerNorm(dim, 1e-6, **kw)
        for name, fin, fout in (("qkv", dim, 3 * dim), ("proj", dim, dim), ("fc1", dim, mlp),
                                ("fc2", mlp, dim)):
            layer = nn.Linear(fin, fout, **kw)
            setattr(self, name, layer)
            if lora_rank > 0:
                layer.requires_grad_(not lora_freeze_base)
                setattr(self, f"{name}_lora_a",
                        nn.Parameter(torch.zeros(fin, lora_rank, device=device)))
                setattr(self, f"{name}_lora_b",
                        nn.Parameter(torch.zeros(lora_rank, fout, device=device)))

    def init_params(self, generator: torch.Generator) -> None:
        if self.lora_rank > 0:  # the b matrices stay zero
            for name in self.LORA:
                normal_(getattr(self, f"{name}_lora_a"), 0.02, generator)

    def _project(self, name: str, x: torch.Tensor) -> torch.Tensor:
        out = getattr(self, name)(x)
        if self.lora_rank <= 0:
            return out
        return lora_delta(out, x, getattr(self, f"{name}_lora_a"),
                          getattr(self, f"{name}_lora_b"), self.lora_scaling)

    def forward(self, x: torch.Tensor, freqs: torch.Tensor) -> torch.Tensor:
        B, L, C = x.shape
        H = self.num_heads
        hd = C // H
        qkv = self._project("qkv", self.norm1(x)).view(B, L, 3, H, hd)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        q, k = apply_vision_rope(q, freqs), apply_vision_rope(k, freqs)
        logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * hd ** -0.5
        probs = torch.softmax(logits, dim=-1).to(x.dtype)
        attn = torch.matmul(probs, v).transpose(1, 2).reshape(B, L, C)
        x = x + self._project("proj", attn)
        h = quick_gelu(self._project("fc1", self.norm2(x)))
        return x + self._project("fc2", h)


class Qwen2VisionTransformer(nn.Module):
    """``forward(frames)`` → ``{"sequence": [B, L/m², hidden_size], "grid_thw":
    (t, h/m, w/m)}``, the merged tokens in (t, h/m, w/m) raster order."""

    def __init__(self, depth: int = 32, embed_dim: int = 1280, hidden_size: int = 8192,
                 mlp_ratio: float = 4.0, num_heads: int = 16, patch_size: int = 14,
                 spatial_merge_size: int = 2, temporal_patch_size: int = 2,
                 image_size: int = 224, lora_rank: int = 0, lora_alpha: float = 16.0,
                 lora_freeze_base: bool = True, remat: bool = False, dtype=torch.bfloat16,
                 device=None):
        super().__init__()
        self.depth, self.embed_dim, self.num_heads = depth, embed_dim, num_heads
        self.patch_size, self.merge = patch_size, spatial_merge_size
        self.temporal_patch_size = temporal_patch_size
        self.remat, self.dtype = remat, dtype
        kw = dict(dtype=dtype, device=device)
        m2 = spatial_merge_size ** 2
        self.patch_embed = nn.Linear(3 * temporal_patch_size * patch_size ** 2, embed_dim,
                                     bias=False, **kw)
        for i in range(depth):
            self.add_module(f"layer_{i}", Qwen2VisionBlock(
                embed_dim, num_heads, mlp_ratio, lora_rank, lora_alpha, lora_freeze_base, **kw))
        self.ln_q = ScaleLayerNorm(embed_dim, 1e-6, **kw)
        self.merger_fc1 = nn.Linear(m2 * embed_dim, m2 * embed_dim, **kw)
        self.merger_fc2 = nn.Linear(m2 * embed_dim, hidden_size, **kw)

    def patches(self, frames: torch.Tensor):
        """frames [B, T, H, W, C] → (patch vectors [B, t·h·w, C·tps·ps·ps] in
        the spatial-merge order, (t, h, w) in patches)."""
        if frames.dim() == 4:
            frames = frames[:, None]
        B, T, Hp, Wp, C = frames.shape
        ps, tps, m = self.patch_size, self.temporal_patch_size, self.merge
        if T % tps:  # a single image (or an odd frame count): the last frame repeated
            frames = torch.cat([frames, frames[:, -1:].expand(-1, tps - T % tps, -1, -1, -1)], 1)
            T = frames.shape[1]
        t, h, w = T // tps, Hp // ps, Wp // ps
        if h % m or w % m or Hp % ps or Wp % ps:
            raise ValueError(f"frames of {Hp}x{Wp} do not tile into {ps}-pixel patches in "
                             f"groups of {m}x{m}")
        x = frames.reshape(B, t, tps, h // m, m, ps, w // m, m, ps, C)
        x = x.permute(0, 1, 3, 6, 4, 7, 9, 2, 5, 8)
        return x.reshape(B, t * h * w, C * tps * ps * ps), (t, h, w)

    def rope_freqs(self, h: int, w: int, device) -> torch.Tensor:
        """The 2D rotary angles of one temporal group's tokens in the
        spatial-merge order [h·w, head_dim/2] fp32."""
        m = self.merge
        hpos = np.broadcast_to(np.arange(h // m)[:, None, None, None] * m
                               + np.arange(m)[None, None, :, None], (h // m, w // m, m, m))
        wpos = np.broadcast_to(np.arange(w // m)[None, :, None, None] * m
                               + np.arange(m)[None, None, None, :], (h // m, w // m, m, m))
        freqs = vision_rope_freqs(hpos.reshape(-1), wpos.reshape(-1),
                                  self.embed_dim // self.num_heads)
        return torch.from_numpy(freqs).to(device)

    def forward(self, frames: torch.Tensor) -> Dict[str, object]:
        """frames float[B, T, H, W, 3] (or [B, H, W, 3]), H and W multiples
        of patch_size · spatial_merge_size."""
        x, (t, h, w) = self.patches(frames)
        B, L, _ = x.shape
        x = self.patch_embed(x.to(self.dtype))
        freqs = self.rope_freqs(h, w, x.device)
        x = x.reshape(B * t, h * w, self.embed_dim)
        remat = self.remat and torch.is_grad_enabled()
        for i in range(self.depth):
            layer = getattr(self, f"layer_{i}")
            x = checkpointed(layer, x, freqs) if remat else layer(x, freqs)
        m2 = self.merge ** 2
        x = self.ln_q(x.reshape(B, L, self.embed_dim)).reshape(B, L // m2, m2 * self.embed_dim)
        x = self.merger_fc2(F.gelu(self.merger_fc1(x)))
        return {"sequence": x, "grid_thw": (t, h // self.merge, w // self.merge)}


def build_qwen2_vit(preset: str = "qwen2_vit", **overrides) -> Qwen2VisionTransformer:
    if preset not in QWEN2_VIT_PRESETS:
        raise KeyError(f"Unknown Qwen2-ViT preset {preset!r}; known: "
                       f"{sorted(QWEN2_VIT_PRESETS)}")
    return Qwen2VisionTransformer(**{**QWEN2_VIT_PRESETS[preset], **overrides})
