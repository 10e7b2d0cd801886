"""Weight-only quantisation for serving: int8 artifacts and decode records.

Port of ``antmmf_tpu/predictors/quantization.py``. The record formats are
the JAX package's, byte for byte, so a record tree or an artifact loads in
both packages:

* ``quantize_params`` / ``dequantize_params``: symmetric per-output-channel
  int8 records ``{"q": int8, "scale": f32 [out], "dtype": str}`` of every
  float kernel of at least ``min_size`` values whose path does not match
  ``norm|embed|logit_scale``; ``save_quantized`` pickles a variables dict
  with its params so quantised (JAX's ``load_quantized`` reads it) and
  ``load_quantized`` reads one back, dequantised;
* ``quantize_for_decode(bits=8)``: the same records without ``dtype``;
  ``bits=4``: ``{"q4": uint8 [in/2, out], "scale": f32 [in/group, out]}``,
  group-wise symmetric int4, two values per byte
  (``ops/int4_matmul.pack_int4``), the group chosen per kernel by
  ``best_group``; kernels on ``QuantDense`` paths whose row count has no
  legal tiling in the JAX package's TPU kernel are stored with zero rows
  appended (``pad_rows_for_kernel``); shapes that do not pack take the int8
  record.

``load_decode_records`` puts such a tree into a module: the records on
``QuantDense`` paths (the decoder's projections and ``lm_head``,
``_route_q4_siblings``) become its buffers, int4 records served by the
int4 GEMV kernel, int8 ones dequantised at each call as JAX's per-step
dequantisation does; every other record is dequantised once, at load,
into the module's dtype, ``q.to(dtype) * scale.to(dtype)`` (rounded in
that dtype, as JAX's product is). (The JAX package dequantises those per
step behind an optimisation barrier, an XLA device with no counterpart
here.)

``quantize_module_for_decode`` does all of that on the module's own
tensors on its device, one kernel at a time, with records byte for byte
those of ``quantize_for_decode`` on the exported tree: no copy of the
weights to the host. ``export_decode_records`` gives a module that serves
records back as such a tree.
"""

from __future__ import annotations

import re
from collections.abc import Mapping
from typing import Any, Callable, Tuple

import numpy as np
import torch
from torch import nn

from antmmf_torch.modules.qdense import QuantDense
from antmmf_torch.ops.int4_matmul import (
    _pick_tiles,
    best_group,
    pack_int4_tensor,
    pad_rows_for_kernel,
    quantize_int8_tensor,
    unpack_int4,
)
from antmmf_torch.utils.weights import (
    PatchConv,
    _nest,
    export_flax_params,
    flatten_flax,
    flax_paths,
    is_record,
    load_flax_params,
    to_flax_layout,
)

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


def _is_artifact_record(n) -> bool:
    return isinstance(n, Mapping) and set(n) == {"q", "scale", "dtype"}


def _map_leaves(fn: Callable[[str, Any], Any], tree: Any, path: str = "") -> Any:
    """``fn(path, leaf)`` over a nested mapping; records (decode records and
    ``quantize_params``' artifact records) count as leaves."""
    if isinstance(tree, Mapping) and not (is_record(tree) or _is_artifact_record(tree)):
        return {k: _map_leaves(fn, v, f"{path}/{k}" if path else str(k))
                for k, v in tree.items()}
    return fn(path, tree)


def _is_quantizable(path: str, leaf, min_size: int, exclude=_EXCLUDE) -> bool:
    if isinstance(leaf, torch.Tensor):
        return bool(leaf.is_floating_point() and leaf.dim() >= 2 and leaf.numel() >= min_size
                    and not (exclude is not None and exclude.search(path)))
    if not hasattr(leaf, "dtype"):
        return False
    arr = np.asarray(leaf)
    return bool(np.issubdtype(arr.dtype, np.floating) and arr.ndim >= 2
                and arr.size >= min_size and not (exclude is not None and exclude.search(path)))


def _as_tensor(leaf) -> torch.Tensor:
    if isinstance(leaf, torch.Tensor):
        return leaf
    return torch.from_numpy(np.ascontiguousarray(np.asarray(leaf, dtype=np.float32)))


def quantize_params(params: Any, min_size: int = 4096,
                    exclude_regex: str = r"(norm|embed|logit_scale)") -> Tuple[Any, Dict[str, int]]:
    """Symmetric per-output-channel int8 records ``{"q", "scale", "dtype"}``
    of the quantizable leaves of a flax-layout tree of arrays (module
    docstring); the other leaves pass through. Returns (tree, stats)."""
    exclude = re.compile(exclude_regex) if exclude_regex else None
    stats = {"quantized": 0, "kept": 0, "bytes_before": 0, "bytes_after": 0}

    def quant(path: str, leaf):
        arr = np.asarray(leaf)
        stats["bytes_before"] += arr.nbytes
        if not _is_quantizable(path, arr, min_size, exclude):
            stats["kept"] += 1
            stats["bytes_after"] += arr.nbytes
            return leaf
        q, scale = quantize_int8_tensor(_as_tensor(arr))
        stats["quantized"] += 1
        stats["bytes_after"] += q.numel() + scale.numel() * 4
        return {"q": q.numpy(), "scale": scale.numpy(), "dtype": str(arr.dtype)}

    return _map_leaves(quant, params), stats


def dequantize_params(qtree: Any) -> Any:
    """The inverse of ``quantize_params``: each record → ``q * scale`` in
    fp32, cast to its ``dtype``."""

    def dequant(path: str, node):
        if _is_artifact_record(node):
            return (np.asarray(node["q"]).astype(np.float32) * np.asarray(node["scale"])
                    ).astype(np.dtype(node["dtype"]))
        return node

    return _map_leaves(dequant, qtree)


def save_quantized(variables: Mapping[str, Any], path: str, **quant_kwargs) -> Dict[str, int]:
    """Quantise ``variables["params"]`` (``quantize_params``) and pickle the
    variables dict, every other leaf as a numpy array: the JAX package's
    artifact, which its ``load_quantized`` reads. Returns the stats."""
    import pickle

    qparams, stats = quantize_params(variables["params"], **quant_kwargs)
    payload = {**dict(variables), "params": qparams}
    payload = _map_leaves(lambda p, n: n if _is_artifact_record(n) else np.asarray(n), payload)
    with open(path, "wb") as f:
        pickle.dump(payload, f)
    return stats


def load_quantized(path: str) -> Dict[str, Any]:
    """A ``save_quantized`` artifact (of either package) with its params
    dequantised."""
    import pickle

    with open(path, "rb") as f:
        payload = pickle.load(f)
    payload["params"] = dequantize_params(payload["params"])
    return payload


def _decode_record(path: str, leaf, min_size: int, bits: int, group: int):
    """One leaf of ``quantize_for_decode``: a record of tensors on the
    leaf's device, or None when the leaf passes through."""
    if not _is_quantizable(path, leaf, min_size):
        return None
    t = _as_tensor(leaf)
    if bits == 4:
        g = best_group(t.shape[0], t.shape[1], group) if t.dim() == 2 else None
        if g is not None and _pick_tiles(t.shape[0], t.shape[1], g) is None \
                and _QDENSE_PATH_RE.search(path):
            fin_pad = pad_rows_for_kernel(t.shape[0], t.shape[1], group)
            if fin_pad is not None:
                t = torch.cat([t.float(), t.new_zeros(fin_pad - t.shape[0], t.shape[1],
                                                      dtype=torch.float32)], dim=0)
                g = best_group(fin_pad, t.shape[1], group)
        if g is not None:
            q4, scale = pack_int4_tensor(t, group=g)
            return {"q4": q4, "scale": scale}
    q, scale = quantize_int8_tensor(t)  # bits=8; conv kernels and odd shapes under bits=4
    return {"q": q, "scale": scale}


def quantize_for_decode(variables: Any, min_size: int = 65536, bits: int = 4,
                        group: int = 128) -> Any:
    """A flax-layout tree of arrays → the same tree with its large float
    kernels as decode records of numpy arrays (module docstring)."""
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")

    def quant(path: str, leaf):
        rec = _decode_record(path, leaf, min_size, bits, group)
        return leaf if rec is None else {k: v.cpu().numpy() for k, v in rec.items()}

    return _map_leaves(quant, variables)


def is_decode_quantized(tree: Any) -> bool:
    found = []
    _map_leaves(lambda path, leaf: found.append(True) if is_record(leaf) else None, tree)
    return bool(found)


def _dequantize(n, dtype) -> torch.Tensor:
    """One record → a float tensor of ``dtype`` on the record's device
    (values and scales cast to ``dtype`` before the product, as in the JAX
    package)."""
    if _is_q4(n):
        return unpack_int4(torch.as_tensor(n["q4"]), torch.as_tensor(n["scale"]), dtype)
    return torch.as_tensor(n["q"]).to(dtype) * torch.as_tensor(n["scale"]).to(dtype)


def dequantize_for_compute(tree: Any, dtype) -> Any:
    """Records → float tensors of ``dtype``; other leaves pass through."""
    return _map_leaves(lambda path, n: _dequantize(n, dtype) if is_record(n) else n, tree)


def _route_q4_siblings(tree: Any, in_decoder: bool = False, parent: str = "") -> Any:
    """Records under QuantDense kernels become sibling arrays in the
    module's scope: ``{"q4", "scale"}`` → ``kernel_q4`` / ``kernel_scale``,
    ``{"q", "scale"}`` → ``kernel_q8`` / ``kernel_scale``; records elsewhere
    are left for ``dequantize_for_compute``."""
    if not isinstance(tree, Mapping) or is_record(tree):
        return tree
    out = {}
    for key, val in tree.items():
        key = str(key)
        routed = (in_decoder and parent in _QDENSE_PARENTS
                  and _QDENSE_PARENTS[parent].match(key)) or key == "lm_head"
        rec = val.get("kernel") if isinstance(val, Mapping) else None
        if routed and is_record(rec):
            values = ("kernel_q4", rec["q4"]) if _is_q4(rec) else ("kernel_q8", rec["q"])
            out[key] = {values[0]: values[1], "kernel_scale": rec["scale"],
                        **{str(k): v for k, v in val.items() if k != "kernel"}}
        else:
            out[key] = _route_q4_siblings(val, in_decoder or key == "decoder", key)
    return out


def load_decode_records(model: nn.Module, variables: Any, dtype) -> Tuple[int, int]:
    """Load a ``quantize_for_decode`` tree (``{"params": ...}`` or the params
    themselves) into ``model``: routed records become ``QuantDense``
    buffers (int4 packed, or int8); every other record is dequantised once
    into ``dtype``, plain leaves load as they are. Missing, unused or
    misshapen entries raise. Returns (modules serving records, dequantised
    records)."""
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
    served = [p[:-len("/kernel_scale")] for p in flat if p.endswith("/kernel_scale")]
    for scope in served:
        mod, scale = modules[scope.replace("/", ".")], flat.pop(scope + "/kernel_scale")
        if scope + "/kernel_q4" in flat:
            mod.load_packed(flat.pop(scope + "/kernel_q4"), scale)
        else:
            mod.load_int8(flat.pop(scope + "/kernel_q8"), scale)
    load_flax_params(model, flat)
    return len(served), counts[0]


def export_decode_records(model: nn.Module) -> Dict[str, Any]:
    """The module as it serves, as a ``quantize_for_decode`` tree (numpy, on
    the host): each ``QuantDense`` serving a record gives that record at its
    kernel's path, every parameter its flax-layout value; what
    ``load_decode_records`` loads into a twin of the module."""
    flat = flatten_flax(export_flax_params(model, stacked=False))
    for name, mod in model.named_modules():
        if isinstance(mod, QuantDense) and mod.kernel_scale is not None:
            rec = {"q4": mod.kernel_q4} if mod.kernel_q4 is not None else {"q": mod.kernel_q8}
            rec["scale"] = mod.kernel_scale
            flat[name.replace(".", "/") + "/kernel"] = {k: v.cpu().numpy() for k, v in rec.items()}
    return {"params": _nest(flat)}


def _module_layout(path: str, w: torch.Tensor, param: torch.Tensor) -> torch.Tensor:
    """A flax-layout leaf in the layout of the module's ``param``
    (``utils/weights.to_torch_layout`` on tensors)."""
    leaf = path.split("/")[-1]
    if leaf == "kernel":
        if w.dim() == 4 and param.dim() == 4:
            return w.permute(3, 2, 0, 1)  # HWIO → OIHW
        return w.reshape(-1, w.shape[-1]).T  # Dense [in, out] or the patch conv's HWIO
    if leaf == "fsmn_kernel":
        return w.permute(2, 1, 0)
    return w


@torch.no_grad()
def quantize_module_for_decode(model: nn.Module, bits: int = 4, min_size: int = 65536,
                               group: int = 128) -> Tuple[int, int]:
    """``load_decode_records(model, quantize_for_decode(export of model))``
    on the module's own tensors on their device, one kernel at a time: the
    same records byte for byte, never copied to the host. Returns (modules
    serving records, dequantised records)."""
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    paths = flax_paths(model)
    modules = dict(model.named_modules())
    served = dequantised = 0
    for name, param in list(model.named_parameters()):
        path = paths[name]
        owner = modules[name.rpartition(".")[0]]
        leaf = to_flax_layout(path, param)
        if isinstance(owner, PatchConv) and path.endswith("/kernel"):  # HWIO, as exported
            leaf = leaf.reshape(owner.patch_size, owner.patch_size, -1, leaf.shape[-1])
        rec = _decode_record(path, leaf, min_size, bits, group)
        if rec is None:
            continue
        if isinstance(owner, QuantDense) and _QDENSE_PATH_RE.search(path):
            if _is_q4(rec):
                owner.load_packed(rec["q4"], rec["scale"])
            else:
                owner.load_int8(rec["q"], rec["scale"])
            served += 1
        else:
            param.copy_(_module_layout(path, _dequantize(rec, param.dtype), param))
            dequantised += 1
        del rec, leaf
    return served, dequantised
