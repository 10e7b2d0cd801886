"""Weight-only group-int4 matmul for decode serving.

Port of ``antmmf_tpu/ops/pallas/int4_matmul.py``. Decode reads every weight
once per token, so its latency is the bytes of weights read; records packed
to 4 bits are unpacked between the load and the multiply-add, which only a
kernel can express. The CUDA kernel (``csrc/int4_gemv.cu``, whose head
comment says what bounds it on an H100 and how its design answers that)
computes, for x [N, in], N <= 32, packed uint8 [in/2, out] and scale fp32
[in/group, out],

    y[n, o] = sum_g scale[g, o] * sum_{r in g} x[n, r] * q[r, o]      (fp32)

where byte (r, o) holds q[r, o] + 8 in its low nibble and q[r + in/2, o] as a
signed two's-complement high nibble: the global top/bottom-half layout of
``pack_int4``, byte for byte the JAX package's, so records load in both
packages. The scale multiplies a group's partial sum, not each weight.

x is read as given, bfloat16 or float32. (The TPU kernel rounds x to bf16
for its matrix unit; on the card the model runs in bf16, so nothing changes
there, and the fp32 CPU tests then agree with ``unpack_int4`` + matmul to
fp32 rounding.) The tile search of the TPU kernel (``_pick_tiles``,
``best_group``, ``pad_rows_for_kernel``) is kept for quantising only: it
decides each record's group size and row padding, so it defines the record
format. The CUDA kernel does not consult it and takes any group that divides
``in``.

``int4_gemv`` launches the kernel for CUDA tensors (counted in
``int4_gemv.launches``) or raises; for CPU tensors it computes
``plain_int4_gemv``, the same per-group arithmetic in tensor ops.
``int4_apply`` is the dense apply ``QuantDense`` calls: up to
``GEMV_MAX_ROWS`` rows go to ``int4_gemv``, more rows (prefill) to
``unpack_int4`` + ``torch.matmul``, which the JAX package also computes
outside its kernel.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

DEFAULT_GROUP = 128   # quantize_for_decode's default group size
GEMV_MAX_ROWS = 32    # rows at or below this take the GEMV kernel
_HT_CAP = 2048        # record format only: packed rows per TPU reduction step


# ------------------------------------------------------------- record format
def packable(shape: Tuple[int, ...], group: int = DEFAULT_GROUP) -> bool:
    """True if a kernel of this shape can be nibble-packed."""
    if len(shape) != 2:
        return False
    return shape[0] % max(2, group) == 0


def pack_int4(w: np.ndarray, group: int = DEFAULT_GROUP) -> Tuple[np.ndarray, np.ndarray]:
    """f32 [in, out] → (q4 uint8 [in/2, out], scale f32 [in/group, out]).

    Symmetric [-7, 7] grid, one scale per ``group`` input rows and output
    channel. Row i packs with row i + in/2: the low nibble stores row i
    biased by 8 ([1, 15]), the high nibble row i + in/2 as a signed
    two's-complement nibble."""
    fin, fout = w.shape
    if not packable(w.shape, group):
        raise ValueError(f"shape {w.shape} not packable (group={group})")
    # torch's CPU ops on all threads; the same IEEE fp32 quotients and
    # round-half-to-even as the JAX package's numpy, so the same bytes
    g = torch.from_numpy(np.ascontiguousarray(w, dtype=np.float32)).reshape(
        fin // group, group, fout)
    scale = g.abs().amax(dim=1).clamp(min=1e-12) / 7.0
    q = torch.round(g / scale[:, None]).clamp(-7, 7).to(torch.int8).reshape(fin, fout)
    half = fin // 2
    lo = (q[:half] + 8).view(torch.uint8)
    hi = q[half:].view(torch.uint8) & 0x0F
    return (lo | (hi << 4)).numpy(), scale.numpy()


def _pick_tiles(fin: int, fout: int, group: int) -> Optional[Tuple[int, int]]:
    """The TPU kernel's tile legality, kept because ``best_group`` and
    ``pad_rows_for_kernel`` (and so the record format) are defined by it."""
    half = fin // 2
    if fin % 2 or group % 8 or half % group:
        return None
    ht = None
    for m in range(min(_HT_CAP, half) // group, 7, -1):
        cand = m * group
        if m % 8 == 0 and cand % 32 == 0 and half % cand == 0:
            ht = cand
            break
    if ht is None:
        return None
    for bout in (512, 256, 128):
        if fout % bout == 0:
            return ht, bout
    return None


def best_group(fin: int, fout: int, requested: int = DEFAULT_GROUP) -> Optional[int]:
    """The group a [fin, fout] record is quantised with: the largest multiple
    of 8 up to ``requested`` (and at least 32) that divides fin/2 with legal
    TPU tiles; else ``requested`` when fin divides by it; else None (not
    packable)."""
    if fin % 2 == 0:
        half = fin // 2
        for g in range((min(requested, half) // 8) * 8, 31, -8):
            if half % g == 0 and _pick_tiles(fin, fout, g) is not None:
                return g
    if fin % max(2, requested) == 0:
        return requested
    return None


def pad_rows_for_kernel(fin: int, fout: int, requested: int = DEFAULT_GROUP) -> Optional[int]:
    """The padded row count (at most +12.5%, a multiple of 256) at which a
    record whose own width has no legal TPU tiling is stored; a 5504-row
    ``down_proj`` is stored with 5632 rows at group 88."""
    limit = fin + fin // 8
    step = 256
    start = fin + (-fin) % step
    for cand in range(start, limit + 1, step):
        g = best_group(cand, fout, requested)
        if g is not None and _pick_tiles(cand, fout, g) is not None:
            return cand
    return None


# ---------------------------------------------------------------- tensor ops
def _nibbles(packed: torch.Tensor) -> torch.Tensor:
    """uint8 [in/2, out] → int8 [in, out]: low nibbles minus 8 over the
    sign-extended high nibbles."""
    v = packed.view(torch.int8)
    lo = (v & 0x0F) - 8
    hi = v >> 4  # arithmetic shift: the signed nibble
    return torch.cat([lo, hi], dim=0)


def unpack_int4(packed: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    """Inverse of ``pack_int4``: the full-width weight [in, out] in ``dtype``
    (values and scales both cast to ``dtype`` before the product, as in the
    JAX package)."""
    fin, fout = packed.shape[0] * 2, packed.shape[1]
    group = fin // scale.shape[0]
    q = _nibbles(packed).to(dtype).reshape(fin // group, group, fout)
    return (q * scale.to(dtype)[:, None]).reshape(fin, fout)


def _pad_x(x: torch.Tensor, fin_w: int) -> torch.Tensor:
    return F.pad(x, (0, fin_w - x.shape[-1])) if fin_w > x.shape[-1] else x


def plain_int4_gemv(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Plain version of the kernel: per group, the fp32 dot of x with the raw
    nibbles, then the group's scale on the partial sum. fp32 [N, out]."""
    fin, fout = packed.shape[0] * 2, packed.shape[1]
    groups = scale.shape[0]
    xg = _pad_x(x.float(), fin).reshape(x.shape[0], groups, fin // groups)
    qg = _nibbles(packed).float().reshape(groups, fin // groups, fout)
    part = torch.einsum("ngr,gro->ngo", xg, qg)
    return (part * scale.float()[None]).sum(dim=1)


def _check_contract(x, packed, scale) -> None:
    """What ``int4_gemv`` takes, on every device."""
    if x.dim() != 2 or packed.dim() != 2 or scale.dim() != 2:
        raise ValueError(f"int4_gemv takes x [N, in], packed [in/2, out], scale [in/group, out]; "
                         f"got {tuple(x.shape)}, {tuple(packed.shape)}, {tuple(scale.shape)}")
    if x.dtype not in (torch.bfloat16, torch.float32) or packed.dtype != torch.uint8 \
            or scale.dtype != torch.float32:
        raise ValueError(f"int4_gemv takes bfloat16 or float32 x, uint8 packed and float32 "
                         f"scale; got {x.dtype}, {packed.dtype}, {scale.dtype}")
    fin = packed.shape[0] * 2
    if not 1 <= x.shape[0] <= GEMV_MAX_ROWS:
        raise ValueError(f"int4_gemv takes 1 to {GEMV_MAX_ROWS} rows of x; got {x.shape[0]}")
    if x.shape[1] > fin or scale.shape[1] != packed.shape[1] or scale.shape[0] < 1 \
            or fin % scale.shape[0]:
        raise ValueError(f"int4_gemv: x {tuple(x.shape)}, packed {tuple(packed.shape)} and "
                         f"scale {tuple(scale.shape)} do not fit together")


_lib = None


def _load():
    global _lib
    if _lib is None:
        from antmmf_torch.ops import _build

        lib = _build.load()
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.antmmf_int4_gemv.argtypes = [p, ll, p, p, p, i, i, i, i, i, i, p]
        lib.antmmf_int4_gemv.restype = i
        _lib = lib
    return _lib


def int4_gemv(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """y fp32 [N, out] = x [N, in_x] @ dequant(packed, scale), N <= 32.

    ``in_x`` may be less than the record's ``in`` (records stored with zero
    rows appended): the missing columns of x count as 0. CPU tensors take
    ``plain_int4_gemv``; CUDA tensors launch the kernel on the current
    stream, or raise."""
    _check_contract(x, packed, scale)
    if x.device.type == "cpu":
        return plain_int4_gemv(x, packed, scale)
    if not (x.is_cuda and packed.device == x.device and scale.device == x.device):
        raise ValueError("int4_gemv: x, packed and scale must lie on one CUDA device")
    if x.stride(1) != 1 or not packed.is_contiguous() or not scale.is_contiguous():
        raise ValueError("int4_gemv needs a unit stride over x's columns and contiguous "
                         f"packed and scale; got x strides {x.stride()}")
    N, fin_x = x.shape
    half, fout = packed.shape
    y = torch.empty((N, fout), dtype=torch.float32, device=x.device)
    lib = _load()
    rc = lib.antmmf_int4_gemv(
        x.data_ptr(), x.stride(0), packed.data_ptr(), scale.data_ptr(), y.data_ptr(),
        N, fin_x, half, fout, 2 * half // scale.shape[0], int(x.dtype == torch.bfloat16),
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"int4_gemv kernel refused or failed to launch at x {tuple(x.shape)} "
                           f"{x.dtype}, packed {tuple(packed.shape)}, scale "
                           f"{tuple(scale.shape)}: CUDA error {rc} "
                           f"({lib.antmmf_cuda_error_string(rc).decode()})")
    int4_gemv.launches += 1
    return y


int4_gemv.launches = 0


def int4_apply(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    """Dense apply against packed int4 weights for any leading shape of x.

    Up to ``GEMV_MAX_ROWS`` rows (decode) go to ``int4_gemv`` and come back
    in x's dtype; more rows (a prefill chunk) unpack the full-width weight in
    ``dtype`` once and take ``torch.matmul``. Records stored with zero rows
    appended take x as it is: the pad rows contribute nothing."""
    lead, fin = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, fin)
    fout = packed.shape[1]
    if x2.shape[0] <= GEMV_MAX_ROWS:
        return int4_gemv(x2, packed, scale).reshape(*lead, fout).to(x.dtype)
    w = unpack_int4(packed, scale, dtype)
    return (_pad_x(x2, w.shape[0]).to(dtype) @ w).reshape(*lead, fout)
