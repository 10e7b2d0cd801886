"""LoRA: low-rank adaptation layers.

Port of ``antmmf_tpu/modules/lora.py``: ``LoRADense`` is a Linear (flax
scope ``base``) plus ``x @ lora_a @ lora_b * (alpha / rank)`` with fp32
adapter matrices cast to x's dtype at use. ``freeze_base`` freezes the base
weights (``requires_grad_(False)``), never the output, so the activation
gradient still flows through the base. ``merge_lora_params`` folds adapters
into base kernels on a tree of flax-layout arrays.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
from torch import nn

from antmmf_torch.modules.layers import normal_


class LoRADense(nn.Module):
    def __init__(self, in_features: int, features: int, rank: int = 8, alpha: float = 16.0,
                 freeze_base: bool = True, use_bias: bool = True, dtype=torch.bfloat16,
                 device=None):
        super().__init__()
        self.scaling = alpha / rank
        self.dtype = dtype
        self.base = nn.Linear(in_features, features, bias=use_bias, dtype=dtype, device=device)
        if freeze_base:
            self.base.requires_grad_(False)
        self.lora_a = nn.Parameter(torch.zeros(in_features, rank, device=device))
        self.lora_b = nn.Parameter(torch.zeros(rank, features, device=device))

    def init_params(self, generator: torch.Generator) -> None:
        normal_(self.lora_a, 0.02, generator)  # lora_b stays zero

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.base(x.to(self.dtype))
        delta = (x @ self.lora_a.to(x.dtype)) @ self.lora_b.to(x.dtype)
        return y + delta * self.scaling


def merge_lora_params(params: Any) -> Any:
    """Fold LoRA deltas into base kernels: kernel' = kernel + A @ B * (16 /
    rank), on every subtree that looks like a LoRADense ({base: {kernel},
    lora_a, lora_b}) of a flax-layout tree of arrays; the adapters come back
    zeroed."""
    if not isinstance(params, dict):
        return params
    if "lora_a" in params and "lora_b" in params and "base" in params:
        a, b = np.asarray(params["lora_a"]), np.asarray(params["lora_b"])
        merged = dict(params["base"])
        merged["kernel"] = np.asarray(merged["kernel"]) + (a @ b) * (16.0 / a.shape[-1])
        return {"base": merged, "lora_a": np.zeros_like(a), "lora_b": np.zeros_like(b)}
    return {k: merge_lora_params(v) for k, v in params.items()}
