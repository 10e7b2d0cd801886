"""Core layers with the JAX package's dtype policy.

Port of ``antmmf_tpu/modules/layers.py``: ``LayerNorm`` computes in fp32 and
casts back to the compute dtype, ``Mlp`` is fc1 → activation → fc2, and
``make_attention_mask`` turns a 1/0 validity mask into an additive fp32 key
bias. Linear weights are held in the compute dtype, which is exactly the
JAX package's per-call cast of its fp32 kernels; norms keep fp32 parameters.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


class LayerNorm(nn.Module):
    """LayerNorm computed in fp32 with fp32 parameters, output cast to
    ``dtype``. ``weight``/``bias`` are flax's ``LayerNorm_0/scale`` and
    ``LayerNorm_0/bias``."""

    def __init__(self, dim: int, epsilon: float = 1e-5, dtype=torch.bfloat16,
                 device=None):
        super().__init__()
        self.epsilon = epsilon
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.weight.shape, self.weight, self.bias,
                            self.epsilon).to(self.dtype)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


ACTIVATIONS = {
    "gelu": lambda x: F.gelu(x, approximate="tanh"),  # flax nn.gelu's default
    "gelu_exact": F.gelu,
    "quick_gelu": quick_gelu,
}


class Mlp(nn.Module):
    """Transformer FFN: fc1 → activation → fc2."""

    def __init__(self, dim: int, hidden_dim: int, activation: str = "gelu",
                 dtype=torch.bfloat16, device=None):
        super().__init__()
        if activation not in ACTIVATIONS:
            raise ValueError(f"Unknown activation {activation!r}; known: "
                             f"{sorted(ACTIVATIONS)}")
        self.act = ACTIVATIONS[activation]
        self.fc1 = nn.Linear(dim, hidden_dim, dtype=dtype, device=device)
        self.fc2 = nn.Linear(hidden_dim, dim, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(self.act(self.fc1(x)))


def make_attention_mask(pad_mask: torch.Tensor) -> torch.Tensor:
    """[B, L] 1/0 validity mask → additive fp32 [B, 1, 1, L] bias
    (``finfo(float32).min`` on padding)."""
    neg = torch.finfo(torch.float32).min
    bias = torch.where(pad_mask[:, None, None, :] > 0, 0.0, neg)
    return bias.to(torch.float32)


def lecun_normal_(w: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    """flax's ``lecun_normal``: truncated normal (±2σ) of variance 1/fan_in.
    Drawn in fp32 on the CPU, then copied, so every device and dtype gets the
    same values from one seed."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    t = torch.empty(w.shape, dtype=torch.float32)
    nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std, generator=generator)
    with torch.no_grad():
        w.copy_(t)


def normal_(w: torch.Tensor, std: float, generator: torch.Generator) -> None:
    t = torch.empty(w.shape, dtype=torch.float32).normal_(0.0, std, generator=generator)
    with torch.no_grad():
        w.copy_(t)


def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Seeded random init with flax's default distributions: Dense and Conv
    kernels ``lecun_normal`` (zero bias), Embed normal with std dim^-½; a
    module with an ``init_params(generator)`` method draws its own."""
    for m in model.modules():
        if isinstance(m, nn.Linear):
            lecun_normal_(m.weight, m.in_features, generator)
            if m.bias is not None:
                with torch.no_grad():
                    m.bias.zero_()
        elif isinstance(m, nn.Embedding):
            normal_(m.weight, m.embedding_dim ** -0.5, generator)
        elif hasattr(m, "init_params"):
            m.init_params(generator)
