"""Classifier heads resolved by type.

Port of ``antmmf_tpu/modules/classifier.py``'s ``ClassifierLayer`` (the
hierarchical classifiers are not ported yet), with the JAX module's
parameter names:

* ``logit``: one Dense (``Dense_0``);
* ``mlp``: ``num_layers`` × (Dense ``fc{i}`` of ``hidden_dim`` (default: the
  input width) → tanh ``gelu``), then Dense ``out``;
* ``weight_norm``: LayerNorm (``LayerNorm_0``), the row scaled to unit
  norm, times the column-normalised fp32 ``weight`` [in, labels], times the
  fp32 scalar ``scale`` (initial 10);
* ``bert``: Dense ``transform`` → gelu → LayerNorm ``transform_ln`` → Dense
  ``out`` (the BERT prediction head);
* ``transformer_decoder``: one learned query (``queries`` [1, C]) attends
  to the feature through a ``TransformerDecoder`` (``decoder``, C / 64
  heads) and Dense ``out`` reads it.

Dense layers compute in ``dtype`` (their input is cast to it, as flax's
Dense casts); the raw parameters (``weight``, ``scale``, ``queries``) stay
fp32, cast at use. ``dropout`` drops after each ``mlp`` layer's gelu, the
``bert`` head's input and inside the ``transformer_decoder``'s decoder, as
the JAX module does.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from antmmf_torch.modules.decoders import TransformerDecoder
from antmmf_torch.modules.layers import ACTIVATIONS, Dropout, LayerNorm, normal_

TYPES = ("logit", "mlp", "weight_norm", "bert", "transformer_decoder")


class ClassifierLayer(nn.Module):
    def __init__(self, classifier_type: str, in_dim: int, num_labels: int,
                 hidden_dim: Optional[int] = None, num_layers: int = 1, dropout: float = 0.0,
                 dtype=torch.float32, device=None):
        super().__init__()
        if classifier_type not in TYPES:
            raise ValueError(f"Unknown classifier type {classifier_type!r}")
        self.dropout = Dropout(dropout)
        self.classifier_type, self.num_layers, self.dtype = classifier_type, num_layers, dtype
        kw = dict(dtype=dtype, device=device)
        if classifier_type == "logit":
            self.Dense_0 = nn.Linear(in_dim, num_labels, **kw)
        elif classifier_type == "mlp":
            width = in_dim
            for i in range(num_layers):
                self.add_module(f"fc{i}", nn.Linear(width, hidden_dim or in_dim, **kw))
                width = hidden_dim or in_dim
            self.out = nn.Linear(width, num_labels, **kw)
        elif classifier_type == "weight_norm":
            self.LayerNorm_0 = LayerNorm(in_dim, dtype=dtype, device=device)
            self.weight = nn.Parameter(torch.empty(in_dim, num_labels, device=device))
            self.scale = nn.Parameter(torch.tensor(10.0, device=device))
        elif classifier_type == "bert":
            self.transform = nn.Linear(in_dim, in_dim, **kw)
            self.transform_ln = LayerNorm(in_dim, dtype=dtype, device=device)
            self.out = nn.Linear(in_dim, num_labels, **kw)
        else:
            self.queries = nn.Parameter(torch.empty(1, in_dim, device=device))
            self.decoder = TransformerDecoder(in_dim, num_layers, max(1, in_dim // 64),
                                              dropout=dropout, dtype=dtype, device=device)
            self.out = nn.Linear(in_dim, num_labels, **kw)

    def init_params(self, generator: torch.Generator) -> None:
        """flax's initializers of the raw parameters: normal(0.02) for
        ``weight`` and ``queries``, 10 for ``scale``."""
        for name in ("weight", "queries"):
            if hasattr(self, name):
                normal_(getattr(self, name), 0.02, generator)
        if hasattr(self, "scale"):
            with torch.no_grad():
                self.scale.fill_(10.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        gelu = ACTIVATIONS["gelu"]
        kind = self.classifier_type
        if kind == "logit":
            return self.Dense_0(x.to(self.dtype))
        if kind == "mlp":
            x = x.to(self.dtype)
            for i in range(self.num_layers):
                x = self.dropout(gelu(getattr(self, f"fc{i}")(x)))
            return self.out(x)
        if kind == "weight_norm":
            x = self.LayerNorm_0(x)
            x = x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-6)
            w = self.weight / (torch.linalg.vector_norm(self.weight, dim=0, keepdim=True) + 1e-6)
            # the matmul in x's dtype; the fp32 scale promotes, as in JAX
            return (x @ w.to(x.dtype)).float() * self.scale
        if kind == "bert":
            x = gelu(self.transform(self.dropout(x).to(self.dtype)))
            return self.out(self.transform_ln(x))
        B = x.shape[0]
        memory = x[:, None] if x.dim() == 2 else x
        q = self.queries[None].expand(B, -1, -1).to(self.dtype)
        return self.out(self.decoder(q, memory).reshape(B, -1))
