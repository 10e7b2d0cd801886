"""Blocked flash attention, forward and backward, for key-biased attention
past the small kernel's lengths (and for Lq ≠ Lk, and causal masking).

Port of ``antmmf_tpu/ops/pallas/flash_attention.py``. Three CUDA kernels
(``csrc/flash_attention.cu``; its head comment says what bounds them on an
H100 and how the design answers that) take the place of the six Pallas ones:

* ``flash_fwd``: the online-softmax forward; returns the output and the row
  statistics ``stats`` [2, B, H, Lq] (m and log l, the lse kept as an
  unevaluated sum so a fully masked row stays exact);
* ``flash_dq``: delta = rowsum(dO∘O), then dQ from P recomputed blockwise;
* ``flash_dkv``: dK and dV from the same P, with the delta ``flash_dq`` wrote.

Each wrapper launches its kernel for CUDA tensors and counts the launch in
its ``launches`` attribute, or raises on what the kernel does not take; for
CPU tensors it computes its plain version (``plain_flash_fwd``,
``plain_flash_dq``, ``plain_flash_dkv``), the same algorithm in plain
PyTorch, which the tests and ``chip_smoke.py`` hold the kernels against.
``flash_attention`` wraps them in a ``torch.autograd.Function``, as the JAX
op is a ``custom_vjp``; ``plain_flash_attention`` is the semantics both are
held to, ``xla_attention_core``'s arithmetic differentiated by autograd.

Semantics (those of ``xla_attention_core``, not of the Pallas kernel): keys
past Lk never enter the softmax, and a row whose keys all carry
``finfo(float32).min`` averages them uniformly (the Pallas kernel returns 0
there). With ``causal``, query i sees keys j <= i (top-left aligned, as in
JAX). The key bias gets no gradient, as in the JAX ``_vjp_bwd``.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from antmmf_torch.ops.small_attention import einsum_attention, key_bias

HEAD_DIMS = (32, 64, 128)


# ------------------------------------------------------------ plain versions
def _logits(q, k, kb, scale: float, causal: bool) -> torch.Tensor:
    """fp32 scores + key bias, -inf above the causal diagonal."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if kb is not None:
        s = s + kb[:, None, None, :]
    if causal:
        Lq, Lk = s.shape[-2:]
        above = torch.ones(Lq, Lk, dtype=torch.bool, device=s.device).triu(1)
        s = s.masked_fill(above, float("-inf"))
    return s


def _probs(q, k, kb, stats, scale: float, causal: bool) -> torch.Tensor:
    """P recomputed from the row statistics: exp((s - m) - log l)."""
    s = _logits(q, k, kb, scale, causal)
    return torch.exp((s - stats[0][..., None]) - stats[1][..., None])


def plain_flash_fwd(q, k, v, kb, scale: float, causal: bool):
    """``flash_fwd``'s algorithm: unnormalised P (rounded to v's dtype) times
    V in fp32, divided by the row sum; stats = (m, log l), in natural-log
    units. (The kernel works in log2 units, one ``ex2`` a score, and converts
    m on the way out; a fully masked row's m is ``finfo(float32).min`` in
    both.)"""
    s = _logits(q, k, kb, scale, causal)
    m = s.amax(dim=-1)
    m = torch.where(m == float("-inf"), torch.zeros_like(m), m)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    acc = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), v.float())
    out = acc / torch.where(l > 0, l, torch.ones_like(l))[..., None]
    logl = torch.where(l > 0, torch.log(l), torch.zeros_like(l))
    return out.to(q.dtype), torch.stack([m, logl])


def plain_flash_dq(q, k, v, kb, out, stats, dout, scale: float, causal: bool):
    """``flash_dq``'s algorithm: delta = rowsum(dO∘O) in fp32, dS = P∘(dP -
    delta)·scale rounded to q's dtype, dQ = dS·K in fp32. Returns (dq, delta)."""
    delta = (dout.float() * out.float()).sum(dim=-1)
    p = _probs(q, k, kb, stats, scale, causal)
    dp = torch.einsum("bhqd,bhkd->bhqk", dout.float(), v.float())
    ds = (p * (dp - delta[..., None]) * scale).to(q.dtype)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds.float(), k.float())
    return dq.to(q.dtype), delta


def plain_flash_dkv(q, k, v, kb, stats, dout, delta, scale: float, causal: bool):
    """``flash_dkv``'s algorithm: dV = Pᵀ·dO with P rounded to dO's dtype,
    dK = dSᵀ·Q, both accumulated in fp32. Returns (dk, dv)."""
    p = _probs(q, k, kb, stats, scale, causal)
    dv = torch.einsum("bhqk,bhqd->bhkd", p.to(dout.dtype).float(), dout.float())
    dp = torch.einsum("bhqd,bhkd->bhqk", dout.float(), v.float())
    ds = (p * (dp - delta[..., None]) * scale).to(q.dtype)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds.float(), q.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def plain_flash_attention(q, k, v, bias=None, scale=None, causal: bool = False):
    """The semantics the kernels are held to: ``einsum_attention`` (the port's
    ``xla_attention_core``) with the key bias and, with ``causal``, -inf above
    the diagonal; differentiable by autograd."""
    B, H, Lq, D = q.shape
    Lk = k.shape[2]
    kb = key_bias(bias, B, Lk, "plain_flash_attention")
    mask = None if kb is None else kb[:, None, None, :]
    if causal:
        above = torch.ones(Lq, Lk, dtype=torch.bool, device=q.device).triu(1)
        tri = torch.zeros(Lq, Lk, device=q.device).masked_fill(above, float("-inf"))
        mask = tri[None, None] if mask is None else mask + tri
    return einsum_attention(q, k, v, bias=mask, scale=scale)


# ------------------------------------------------------------------ kernels
class _FlashArgs(ctypes.Structure):
    """``FlashArgs`` of csrc/flash_attention.cu, field for field."""

    _fields_ = [(name, ctypes.c_void_p) for name in
                ("q", "k", "v", "bias", "o", "stats", "dout", "delta", "dq", "dk", "dv")] + \
               [(f"{name}_s", ctypes.c_longlong * 3) for name in
                ("q", "k", "v", "o", "do", "dq", "dk", "dv")] + \
               [(name, ctypes.c_int) for name in ("B", "H", "Lq", "Lk", "D", "causal")] + \
               [("scale", ctypes.c_float)]


_lib = None


def _load():
    global _lib
    if _lib is None:
        from antmmf_torch.ops import _build

        lib = _build.load()
        for name in ("antmmf_flash_fwd", "antmmf_flash_dq", "antmmf_flash_dkv"):
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.POINTER(_FlashArgs), ctypes.c_void_p]
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _aligned(t: torch.Tensor) -> bool:
    """A unit stride over D and bf16 rows on 16-byte boundaries."""
    return t.stride(3) == 1 and t.data_ptr() % 16 == 0 \
        and not any(s * 2 % 16 for s in t.stride()[:3])


def _check_cuda(kb, **tensors) -> None:
    """What a launch needs: bfloat16 tensors on one CUDA device with a unit
    stride over D and 16-byte aligned rows, a contiguous fp32 key bias."""
    q = tensors["q"]
    for name, t in tensors.items():
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"flash_attention: {name} must lie on q's CUDA device")
        if t.dtype != torch.bfloat16:
            raise ValueError(f"flash_attention's CUDA kernels take bfloat16; {name} is {t.dtype}")
        if not _aligned(t):
            raise ValueError(f"flash_attention: {name} needs a unit stride over D and rows "
                             f"on 16-byte boundaries; got strides {t.stride()}")
    if kb is not None and (kb.dtype != torch.float32 or kb.device != q.device
                           or not kb.is_contiguous()):
        raise ValueError("flash_attention: the key bias must be a contiguous float32 "
                         "tensor on q's device")


def _launch(entry: str, scale: float, causal: bool, kb, stats, delta, **tensors) -> None:
    q, k = tensors["q"], tensors["k"]
    B, H, Lq, D = q.shape
    args = _FlashArgs(B=B, H=H, Lq=Lq, Lk=k.shape[2], D=D, causal=int(causal),
                      scale=float(scale))
    for name, t in tensors.items():
        setattr(args, name, t.data_ptr())
        setattr(args, ("do" if name == "dout" else name) + "_s",
                (ctypes.c_longlong * 3)(*t.stride()[:3]))
    args.bias = kb.data_ptr() if kb is not None else None
    args.stats = stats.data_ptr()
    args.delta = delta.data_ptr() if delta is not None else None
    lib = _load()
    rc = getattr(lib, entry)(ctypes.byref(args), torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{entry} refused or failed to launch at q {tuple(q.shape)}, "
                           f"k {tuple(k.shape)}: CUDA error {rc} "
                           f"({lib.antmmf_cuda_error_string(rc).decode()})")


def flash_fwd(q, k, v, kb, scale: float, causal: bool):
    """(out, stats): the forward kernel for CUDA tensors, ``plain_flash_fwd``
    for CPU tensors. ``out`` keeps q's stride layout."""
    if q.device.type == "cpu":
        return plain_flash_fwd(q, k, v, kb, scale, causal)
    _check_cuda(kb, q=q, k=k, v=v)
    out = torch.empty_like(q)
    stats = torch.empty((2,) + tuple(q.shape[:3]), dtype=torch.float32, device=q.device)
    _launch("antmmf_flash_fwd", scale, causal, kb, stats, None, q=q, k=k, v=v, o=out)
    flash_fwd.launches += 1
    return out, stats


def flash_dq(q, k, v, kb, out, stats, dout, scale: float, causal: bool):
    """(dq, delta): the dQ kernel for CUDA tensors, ``plain_flash_dq`` for CPU
    tensors."""
    if q.device.type == "cpu":
        return plain_flash_dq(q, k, v, kb, out, stats, dout, scale, causal)
    _check_cuda(kb, q=q, k=k, v=v, o=out, dout=dout)
    dq = torch.empty_like(q)
    delta = torch.empty(tuple(q.shape[:3]), dtype=torch.float32, device=q.device)
    _launch("antmmf_flash_dq", scale, causal, kb, stats, delta, q=q, k=k, v=v, o=out,
            dout=dout, dq=dq)
    flash_dq.launches += 1
    return dq, delta


def flash_dkv(q, k, v, kb, stats, dout, delta, scale: float, causal: bool):
    """(dk, dv): the dK/dV kernel for CUDA tensors, ``plain_flash_dkv`` for
    CPU tensors."""
    if q.device.type == "cpu":
        return plain_flash_dkv(q, k, v, kb, stats, dout, delta, scale, causal)
    _check_cuda(kb, q=q, k=k, v=v, dout=dout)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch("antmmf_flash_dkv", scale, causal, kb, stats, delta, q=q, k=k, v=v, dout=dout,
            dk=dk, dv=dv)
    flash_dkv.launches += 1
    return dk, dv


flash_fwd.launches = flash_dq.launches = flash_dkv.launches = 0


class FlashAttention(torch.autograd.Function):
    """Forward saves (out, stats); backward runs dQ, then dK/dV."""

    @staticmethod
    def forward(ctx, q, k, v, kb, scale, causal):
        out, stats = flash_fwd(q, k, v, kb, scale, causal)
        ctx.save_for_backward(q, k, v, kb, out, stats)
        ctx.scale, ctx.causal = scale, causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, kb, out, stats = ctx.saved_tensors
        if dout.is_cuda and not _aligned(dout):
            dout = dout.contiguous()
        dq, delta = flash_dq(q, k, v, kb, out, stats, dout, ctx.scale, ctx.causal)
        dk, dv = flash_dkv(q, k, v, kb, stats, dout, delta, ctx.scale, ctx.causal)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: Optional[torch.Tensor] = None, scale: Optional[float] = None,
                    causal: bool = False) -> torch.Tensor:
    """softmax(q·kᵀ·scale + key bias)·v, differentiable in q, k and v.

    q [B, H, Lq, D], k and v [B, H, Lk, D] (Lq may differ from Lk), D in
    HEAD_DIMS; ``bias`` None, [B, Lk] or [B, 1, 1, Lk] (any other shape
    raises); ``scale`` defaults to D^-½. On the CPU, float32 or bfloat16 take
    the plain versions; on CUDA the kernels take bfloat16, strided views
    included (the output keeps q's layout), and anything else raises."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape or k.shape[:2] != q.shape[:2] \
            or k.shape[3] != q.shape[3]:
        raise ValueError(f"flash_attention takes q [B, H, Lq, D] and k, v [B, H, Lk, D]; "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if q.dtype not in (torch.bfloat16, torch.float32) or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"flash_attention takes bfloat16 or float32 q/k/v of one dtype; "
                         f"got {q.dtype}, {k.dtype}, {v.dtype}")
    B, H, Lq, D = q.shape
    if D not in HEAD_DIMS or Lq < 1 or k.shape[2] < 1:
        raise ValueError(f"flash_attention takes D in {HEAD_DIMS} and non-empty sequences; "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}")
    kb = key_bias(bias, B, k.shape[2], "flash_attention")
    return FlashAttention.apply(q, k, v, kb, scale if scale is not None else D ** -0.5,
                                causal)
