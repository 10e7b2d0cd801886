"""Fused attention for short self-attention sequences (L <= 256).

Port of ``antmmf_tpu/ops/pallas/small_attention.py``. The CUDA kernels
(``csrc/small_attention.cu``, whose head comment says what bounds them on an
H100 and how the design answers that: bfloat16 on the tensor cores, float32
in full precision on the CUDA cores) compute

    out[b, h, i] = sum_j softmax_j(q[b,h,i]·k[b,h,j]·scale + bias[b, j]) v[b,h,j]

with the semantics of the JAX package's ``xla_attention_core``, the function
that package runs on this path: keys past L never enter the softmax, and a
row whose keys are all masked with ``finfo(float32).min`` averages uniformly.
(The Pallas kernel pads L to a multiple of 8 and gives the padded keys bias 0
when ``bias`` is None; the port does not copy that.)

``small_attention`` is a ``torch.autograd.Function``, as the JAX op is a
``custom_vjp``: its forward launches the kernel for CUDA tensors (and raises
on what the kernel does not take) or computes ``plain_small_attention`` for
CPU tensors; its backward is the JAX package's own, plain fp32 tensor ops
that recompute the probabilities (``small_attention.py:81-95`` there), on
both devices, since the JAX package has no kernel for it.
"""

from __future__ import annotations

from typing import Optional

import torch

MAX_L = 256
HEAD_DIMS = (32, 64, 128)


def key_bias(bias: Optional[torch.Tensor], B: int, L: int,
             op: str = "small_attention") -> Optional[torch.Tensor]:
    """[B, 1, 1, L] or [B, L] additive key bias → [B, L]; anything else raises."""
    if bias is None:
        return None
    if bias.dim() == 4 and bias.shape[1:3] == (1, 1):
        bias = bias.reshape(bias.shape[0], bias.shape[3])
    if bias.dim() != 2 or tuple(bias.shape) != (B, L):
        raise ValueError(f"{op} takes a key bias [B, 1, 1, L] or [B, L] "
                         f"with B={B}, L={L}; got {tuple(bias.shape)}")
    return bias


def einsum_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     bias: Optional[torch.Tensor] = None,
                     scale: Optional[float] = None) -> torch.Tensor:
    """``xla_attention_core`` in plain PyTorch: fp32 logits plus an additive
    fp32 bias [B, 1|H, Lq|1, Lk], fp32 softmax, probabilities cast to v's
    dtype for P·V."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        logits = logits + bias
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", probs.to(v.dtype), v)


def plain_small_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          bias: Optional[torch.Tensor] = None,
                          scale: Optional[float] = None) -> torch.Tensor:
    """Plain version of the kernel: its key-bias contract, ``einsum_attention``'s
    arithmetic. The bfloat16 kernel follows it on both of its branches (one
    pass for L <= 64; two sweeps over 64-key tiles of the head's K beyond):
    fp32 scores, max and sum, and P rounded to the input type after it is
    normalised, just before P·V."""
    B, H, L, D = q.shape
    kb = key_bias(bias, B, L)
    return einsum_attention(q, k, v, None if kb is None else kb[:, None, None, :], scale)


def _check_contract(q, k, v) -> None:
    """What the kernel takes, on every device: self-attention q/k/v
    [B, H, L, D] of one shape and dtype (bfloat16 or float32), L <= MAX_L,
    D in HEAD_DIMS."""
    if q.dtype not in (torch.bfloat16, torch.float32) or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"small_attention takes bfloat16 or float32 q/k/v of one "
                         f"dtype; got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"small_attention takes self-attention q/k/v [B, H, L, D] "
                         f"of one shape; got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    L, D = q.shape[-2:]
    if not (1 <= L <= MAX_L and D in HEAD_DIMS):
        raise ValueError(f"small_attention takes 1 <= L <= {MAX_L} and D in {HEAD_DIMS}; "
                         f"got {tuple(q.shape)}")


def _check_cuda(q, k, v, kb) -> None:
    """What the launch needs beyond the contract: one CUDA device, a unit
    stride over D, 16-byte aligned rows and a contiguous fp32 key bias."""
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("small_attention: q, k, v must lie on one CUDA device")
    if k.stride() != q.stride() or v.stride() != q.stride() or q.stride(3) != 1:
        raise ValueError("small_attention: q, k, v need one stride layout with a "
                         f"unit stride over D; got {q.stride()}, {k.stride()}, "
                         f"{v.stride()}")
    item = q.element_size()
    for t in (q, k, v):
        if t.data_ptr() % 16 or any(s * item % 16 for s in t.stride()[:3]):
            raise ValueError("small_attention: every q/k/v row must start on a "
                             "16-byte boundary")
    if kb is not None and (kb.dtype != torch.float32 or kb.device != q.device
                           or not kb.is_contiguous()):
        raise ValueError("small_attention: the key bias must be a contiguous "
                         "float32 tensor on q's device")


def _forward(q, k, v, kb, scale: float) -> torch.Tensor:
    """The kernel for CUDA tensors (counted in ``small_attention.launches``),
    ``plain_small_attention`` for CPU tensors."""
    if q.device.type == "cpu":
        return plain_small_attention(q, k, v, kb, scale)
    _check_cuda(q, k, v, kb)
    B, H, L, D = q.shape
    out = torch.empty_like(q)  # keeps q's stride layout
    from antmmf_torch.ops import _build

    lib = _build.load()
    rc = lib.antmmf_small_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        kb.data_ptr() if kb is not None else None, out.data_ptr(),
        B, H, L, D, *q.stride()[:3], *out.stride()[:3], float(scale),
        int(q.dtype == torch.bfloat16), torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"small_attention kernel refused or failed to launch at "
                           f"{tuple(q.shape)} {q.dtype}: CUDA error {rc} "
                           f"({lib.antmmf_cuda_error_string(rc).decode()})")
    small_attention.launches += 1
    return out


def small_attention_backward(q, k, v, kb, g, scale: float):
    """The JAX op's backward (``_vjp_bwd``): fp32 scores recomputed from
    q, k and the key bias, softmax, then dq, dk, dv in fp32, cast back to the
    inputs' dtypes. The bias gets no gradient."""
    qf, kf, vf, gf = q.float(), k.float(), v.float(), g.float()
    s = torch.einsum("bhld,bhmd->bhlm", qf, kf) * scale
    if kb is not None:
        s = s + kb[:, None, None, :]
    p = torch.softmax(s, dim=-1)
    dv = torch.einsum("bhlm,bhld->bhmd", p, gf)
    dp = torch.einsum("bhld,bhmd->bhlm", gf, vf)
    tmp = (dp - (dp * p).sum(dim=-1, keepdim=True)) * p
    dq = torch.einsum("bhlm,bhmd->bhld", tmp, kf) * scale
    dk = torch.einsum("bhlm,bhld->bhmd", tmp, qf) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class SmallAttention(torch.autograd.Function):
    """Forward through the kernel (or its plain version on the CPU),
    backward as the JAX op's ``custom_vjp``."""

    @staticmethod
    def forward(ctx, q, k, v, kb, scale):
        ctx.save_for_backward(q, k, v, kb)
        ctx.scale = scale
        return _forward(q, k, v, kb, scale)

    @staticmethod
    def backward(ctx, g):
        q, k, v, kb = ctx.saved_tensors
        return (*small_attention_backward(q, k, v, kb, g, ctx.scale), None, None)


def small_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: Optional[torch.Tensor] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """softmax(q·kᵀ·scale + key bias)·v over q/k/v [B, H, L, D], differentiable
    in q, k and v.

    Shapes and dtypes outside the kernel's contract raise on every device.
    CPU tensors then take ``plain_small_attention``; CUDA tensors launch the
    kernel on the current stream, or raise. The kernel also refuses, with
    CUDA's invalid-argument error, a head whose K and V do not fit in one
    block's shared memory (float32 at D=128 and L near MAX_L); the CUDA
    source owns that layout. Inputs may be strided views (the [B, L, H, D] → [B, H, L, D]
    transpose of a projection); the output has the same layout as ``q``.
    ``small_attention.launches`` counts the kernel's launches."""
    _check_contract(q, k, v)
    B, H, L, D = q.shape
    kb = key_bias(bias, B, L)
    return SmallAttention.apply(q, k, v, kb, scale if scale is not None else D ** -0.5)


small_attention.launches = 0
