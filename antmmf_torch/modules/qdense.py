"""QuantDense: a bias-free Linear that can serve packed int4 weights.

Port of ``antmmf_tpu/modules/qdense.py``. Until packed records are loaded it
is ``nn.Linear(bias=False)`` (flax name ``kernel``), so checkpoints and the
weight carry are unchanged. ``load_packed`` replaces the weight by two
buffers, flax's sibling arrays of the same names,

    kernel_q4     uint8  [in/2, out]       nibble-packed (ops/int4_matmul.py)
    kernel_scale  f32    [in/group, out]

and ``forward`` then goes through ``int4_apply``: the int4 GEMV kernel for
decode-sized inputs (weights cross device memory as 4 bits), unpack + matmul
for prefill-sized ones. ``load_int8`` serves an int8 record instead,

    kernel_q8     int8   [in, out]
    kernel_scale  f32    [out]

dequantised at every call (``q.to(dtype) * scale.to(dtype)``, the JAX
package's per-step dequantisation, whose product it computes outside any
kernel) and multiplied by ``torch.matmul``. ``freeze`` freezes the weight,
not the output: no weight gradient, while the activation gradient still
flows.
"""

from __future__ import annotations

import torch
from torch import nn

from antmmf_torch.ops.int4_matmul import int4_apply


class QuantDense(nn.Linear):
    def __init__(self, in_features: int, features: int, dtype=torch.bfloat16,
                 freeze: bool = False, device=None):
        super().__init__(in_features, features, bias=False, dtype=dtype, device=device)
        self.dtype = dtype
        if freeze:
            self.weight.requires_grad_(False)
        self.kernel_q4 = self.kernel_q8 = self.kernel_scale = None

    def load_packed(self, q4, scale) -> None:
        """Serve from a ``{"q4", "scale"}`` record (arrays or tensors) from
        now on; the float weight is dropped. The record may hold more rows
        than ``in_features`` (zero rows appended when it was quantised)."""
        q4, scale = torch.as_tensor(q4), torch.as_tensor(scale)
        if q4.dtype != torch.uint8 or q4.dim() != 2 or scale.dim() != 2 \
                or q4.shape[1] != self.out_features or scale.shape[1] != self.out_features \
                or q4.shape[0] * 2 < self.in_features or (q4.shape[0] * 2) % scale.shape[0]:
            raise ValueError(f"packed record q4 {tuple(q4.shape)} {q4.dtype}, scale "
                             f"{tuple(scale.shape)} does not fit a "
                             f"[{self.in_features}, {self.out_features}] kernel")
        self._serve(q4, None, scale)

    def load_int8(self, q, scale) -> None:
        """Serve from a ``{"q", "scale"}`` record: q int8 [in, out], scale
        [out]; the float weight is dropped."""
        q, scale = torch.as_tensor(q), torch.as_tensor(scale)
        if q.dtype != torch.int8 or tuple(q.shape) != (self.in_features, self.out_features) \
                or tuple(scale.shape) != (self.out_features,):
            raise ValueError(f"int8 record q {tuple(q.shape)} {q.dtype}, scale "
                             f"{tuple(scale.shape)} does not fit a "
                             f"[{self.in_features}, {self.out_features}] kernel")
        self._serve(None, q, scale)

    def _serve(self, q4, q8, scale) -> None:
        held = next(t for t in (self.weight, self.kernel_q4, self.kernel_q8) if t is not None)
        self.weight = None
        self.kernel_q4 = None if q4 is None else q4.to(held.device).contiguous()
        self.kernel_q8 = None if q8 is None else q8.to(held.device).contiguous()
        self.kernel_scale = scale.to(device=held.device, dtype=torch.float32).contiguous()

    def int8_weight(self) -> torch.Tensor:
        """The int8 record's kernel [in, out] in the module's dtype: values and
        scales cast first, then multiplied (rounded in that dtype, as JAX's
        per-step product is)."""
        return self.kernel_q8.to(self.dtype) * self.kernel_scale.to(self.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.kernel_q4 is not None:
            return int4_apply(x, self.kernel_q4, self.kernel_scale, self.dtype).to(self.dtype)
        if self.kernel_q8 is not None:
            return torch.matmul(x.to(self.dtype), self.int8_weight())
        return super().forward(x.to(self.dtype))
