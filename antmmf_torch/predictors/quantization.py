"""Weight-only quantisation records for decode serving.

Port of the int4 side of ``antmmf_tpu/predictors/quantization.py``. The
record format is the JAX package's, byte for byte, so a record tree loads in
both packages: ``quantize_for_decode(bits=4)`` turns every large float
kernel of a flax-layout tree of arrays (paths ``a/b/kernel``, Dense kernels
[in, out]) into

* ``{"q4": uint8 [in/2, out], "scale": f32 [in/group, out]}``: group-wise
  symmetric int4, two values per byte (``ops/int4_matmul.pack_int4``), the
  group chosen per kernel by ``best_group``; kernels on ``QuantDense`` paths
  whose row count has no legal tiling in the JAX package's TPU kernel are
  stored with zero rows appended (``pad_rows_for_kernel``);
* ``{"q": int8, "scale": f32 [out]}``: symmetric per-output-channel int8 for
  shapes that do not pack (convolutions, odd row counts);

paths matching ``norm|embed|logit_scale`` and small or non-float leaves pass
through. ``load_decode_records`` puts such a tree into a module: records on
``QuantDense`` paths (the decoder's projections and ``lm_head``,
``_route_q4_siblings``) become the module's packed buffers on its device and
are served by the int4 GEMV kernel; every other record is dequantised once,
at load, into the module's dtype. (The JAX package dequantises those per
step behind an optimisation barrier, an XLA device with no counterpart
here.) ``bits=8`` (``decode_quant: int8``) is not ported.
"""

from __future__ import annotations

import re
from collections.abc import Mapping
from typing import Any, Callable, Tuple

import numpy as np
import torch
from torch import nn

from antmmf_torch.ops.int4_matmul import (
    _pick_tiles,
    best_group,
    pack_int4,
    pad_rows_for_kernel,
    unpack_int4,
)
from antmmf_torch.utils.weights import flatten_flax, is_record, load_flax_params

_EXCLUDE = re.compile(r"(norm|embed|logit_scale)")
# modules whose matmul is a QuantDense and can consume packed records: the
# decoder's attention and MLP projections (vision towers reuse the
# "attention/q_proj" names with plain Linears but never sit under a
# "decoder" scope) and the vocabulary projection
_QDENSE_PARENTS = {
    "attention": re.compile(r"^[qkvo]_proj$"),
    "mlp": re.compile(r"^(?:gate|up|down)_proj$"),
}
# quantise-time mirror of the routing (full-path form): only kernels at these
# paths may be stored row-padded; anything else keeps its true shape
_QDENSE_PATH_RE = re.compile(
    r"decoder/.*(?:attention/[qkvo]_proj|mlp/(?:gate|up|down)_proj)"
    r"/kernel$|(?:^|/)lm_head/kernel$")


def _is_q4(n) -> bool:
    return is_record(n) and "q4" in n


def _map_leaves(fn: Callable[[str, Any], Any], tree: Any, path: str = "") -> Any:
    """``fn(path, leaf)`` over a nested mapping; records count as leaves."""
    if isinstance(tree, Mapping) and not is_record(tree):
        return {k: _map_leaves(fn, v, f"{path}/{k}" if path else str(k))
                for k, v in tree.items()}
    return fn(path, tree)


def _is_quantizable(path: str, leaf, min_size: int) -> bool:
    if not hasattr(leaf, "dtype"):
        return False
    arr = np.asarray(leaf)
    return bool(np.issubdtype(arr.dtype, np.floating) and arr.ndim >= 2
                and arr.size >= min_size and not _EXCLUDE.search(path))


def quantize_for_decode(variables: Any, min_size: int = 65536, bits: int = 4,
                        group: int = 128) -> Any:
    """A flax-layout tree of arrays → the same tree with its large float
    kernels as decode records (module docstring)."""
    if bits != 4:
        raise NotImplementedError(f"quantize_for_decode: only bits=4 is ported, got {bits}")

    def quant4(path: str, leaf):
        if not _is_quantizable(path, leaf, min_size):
            return leaf
        arr = np.asarray(leaf)
        g = best_group(arr.shape[0], arr.shape[1], group) if arr.ndim == 2 else None
        if g is not None and _pick_tiles(arr.shape[0], arr.shape[1], g) is None \
                and _QDENSE_PATH_RE.search(path):
            fin_pad = pad_rows_for_kernel(arr.shape[0], arr.shape[1], group)
            if fin_pad is not None:
                arr = np.concatenate(
                    [arr, np.zeros((fin_pad - arr.shape[0], arr.shape[1]), arr.dtype)], axis=0)
                g = best_group(fin_pad, arr.shape[1], group)
        if g is None:  # conv kernels, odd shapes: int8 per output channel
            flat = arr.reshape(-1, arr.shape[-1]).astype(np.float32)
            scale = np.maximum(np.abs(flat).max(axis=0), 1e-12) / 127.0
            q = np.clip(np.round(arr.astype(np.float32) / scale), -127, 127).astype(np.int8)
            return {"q": q, "scale": scale.astype(np.float32)}
        packed, scale = pack_int4(arr, group=g)
        return {"q4": packed, "scale": scale}

    return _map_leaves(quant4, variables)


def is_decode_quantized(tree: Any) -> bool:
    found = []
    _map_leaves(lambda path, leaf: found.append(True) if is_record(leaf) else None, tree)
    return bool(found)


def dequantize_for_compute(tree: Any, dtype) -> Any:
    """Records → float tensors of ``dtype`` (values and scales cast to
    ``dtype`` before the product, as in the JAX package); other leaves pass
    through."""

    def dq(path: str, n):
        if _is_q4(n):
            return unpack_int4(torch.as_tensor(np.asarray(n["q4"])),
                               torch.as_tensor(np.asarray(n["scale"])), dtype)
        if is_record(n):
            return torch.as_tensor(np.asarray(n["q"])).to(dtype) \
                * torch.as_tensor(np.asarray(n["scale"])).to(dtype)
        return n

    return _map_leaves(dq, tree)


def _route_q4_siblings(tree: Any, in_decoder: bool = False, parent: str = "") -> Any:
    """``{"q4", "scale"}`` records under QuantDense kernels become sibling
    arrays ``kernel_q4`` / ``kernel_scale`` in the module's scope; records
    elsewhere are left for ``dequantize_for_compute``."""
    if not isinstance(tree, Mapping) or is_record(tree):
        return tree
    out = {}
    for key, val in tree.items():
        key = str(key)
        routed = (in_decoder and parent in _QDENSE_PARENTS
                  and _QDENSE_PARENTS[parent].match(key)) or key == "lm_head"
        if routed and isinstance(val, Mapping) and _is_q4(val.get("kernel")):
            out[key] = {"kernel_q4": val["kernel"]["q4"],
                        "kernel_scale": val["kernel"]["scale"],
                        **{str(k): v for k, v in val.items() if k != "kernel"}}
        else:
            out[key] = _route_q4_siblings(val, in_decoder or key == "decoder", key)
    return out


def load_decode_records(model: nn.Module, variables: Any, dtype) -> Tuple[int, int]:
    """Load a ``quantize_for_decode`` tree (``{"params": ...}`` or the params
    themselves) into ``model``: routed records become ``QuantDense`` packed
    buffers, every other record is dequantised once into ``dtype``, plain
    leaves load as they are. Missing, unused or misshapen entries raise.
    Returns (packed modules, dequantised records)."""
    params = variables["params"] if isinstance(variables, Mapping) and "params" in variables \
        else variables
    counts = [0]

    def count(path, leaf):
        counts[0] += is_record(leaf)
        return leaf

    routed = _map_leaves(count, _route_q4_siblings(params))
    floats = _map_leaves(lambda path, leaf: leaf.float().numpy()
                         if isinstance(leaf, torch.Tensor) else leaf,
                         dequantize_for_compute(routed, dtype))
    flat = flatten_flax(floats)
    modules = dict(model.named_modules())
    packed = [p[:-len("/kernel_q4")] for p in flat if p.endswith("/kernel_q4")]
    for scope in packed:
        modules[scope.replace("/", ".")].load_packed(
            flat.pop(scope + "/kernel_q4"), flat.pop(scope + "/kernel_scale"))
    load_flax_params(model, flat)
    return len(packed), counts[0]
