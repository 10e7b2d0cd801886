"""Carry the JAX package's flax parameters into the port's modules.

The port's parameter names mirror the flax tree (``base.img_encoder.encoder.
layer_0.attention.q_proj``), so the carry is a name map plus transposes:

* ``Dense`` ``kernel`` [in, out] → ``Linear.weight`` [out, in];
* ``Conv`` ``kernel`` HWIO [p, p, 3, C] → the patch-matmul weight [C, p·p·3];
* ``LayerNorm_0/scale`` and ``LayerNorm_0/bias`` → ``weight`` and ``bias``;
* ``Embed`` ``embedding`` → ``weight``;
* everything else (``pos_embedding``, ``cls_token``, the ``logit_scale``
  scalar, ``RMSNorm``'s ``scale``, the ``lora_a``/``lora_b`` matrices of
  ``LoRADense`` and the ``q_lora_a``-style adapters inside attention) as is.

``QuantDense`` carries like the ``Linear`` it is; ``LoRADense`` keeps flax's
``base`` scope. Decode records (``{"q4", "scale"}`` and ``{"q", "scale"}``
dicts in place of a kernel) count as leaves of a tree:
``predictors/quantization.load_decode_records`` loads those.
``export_flax_params`` is the way back, a module's parameters as a flax-layout
tree of fp32 arrays, which ``quantize_for_decode`` takes.

A missing or unused key, or a shape mismatch, raises. ``params.npz`` files
hold the flax leaves under ``/``-joined paths; they are the port's
``model_dir`` format. ``flax_to_masters`` gives the same carry as fp32
tensors by parameter name, the master parameters a ``TrainState`` trains
(the JAX package keeps fp32 params and casts at use); ``flax_paths`` is the
inverse name map, which the optimizer's weight-decay and lr-multiplier
patterns match against.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch
from torch import nn

from antmmf_torch.modules.embeddings import PatchEmbed
from antmmf_torch.modules.layers import LayerNorm
from antmmf_torch.modules.qdense import QuantDense


def is_record(node: Any) -> bool:
    """A decode record in place of a kernel: ``{"q4", "scale"}`` (packed int4)
    or ``{"q", "scale"}`` (int8 per output channel)."""
    return isinstance(node, Mapping) and set(node) in ({"q4", "scale"}, {"q", "scale"})


def flatten_flax(params: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    """Nested flax params → {"a/b/kernel": array}; a decode record stays one
    leaf (its dict)."""
    flat: Dict[str, Any] = {}
    for key, val in params.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(val, Mapping) and not is_record(val):
            flat.update(flatten_flax(val, path))
        else:
            flat[path] = val if isinstance(val, Mapping) else np.asarray(val)
    return flat


def _torch_name(flax_path: str) -> str:
    parts = flax_path.split("/")
    if len(parts) >= 2 and parts[-2] == "LayerNorm_0":
        parts = parts[:-2] + [{"scale": "weight", "bias": "bias"}[parts[-1]]]
    elif parts[-1] in ("kernel", "embedding"):
        parts[-1] = "weight"
    return ".".join(parts)


def _to_torch_layout(flax_path: str, value: np.ndarray) -> np.ndarray:
    if flax_path.split("/")[-1] == "kernel":
        return value.reshape(-1, value.shape[-1]).T  # Dense [in,out] or Conv HWIO
    return value


def flax_paths(model: nn.Module) -> Dict[str, str]:
    """Each parameter's name → its flax path (``a/b/kernel``)."""
    leaves = {nn.Linear: {"weight": "kernel", "bias": "bias"},
              QuantDense: {"weight": "kernel"},
              nn.Embedding: {"weight": "embedding"},
              LayerNorm: {"weight": "LayerNorm_0/scale", "bias": "LayerNorm_0/bias"}}
    paths = {}
    for mod_name, mod in model.named_modules():
        rename = leaves.get(type(mod), {})
        for pname, _ in mod.named_parameters(recurse=False):
            name = f"{mod_name}.{pname}" if mod_name else pname
            paths[name] = "/".join(filter(None, [mod_name.replace(".", "/"),
                                                 rename.get(pname, pname)]))
    return paths


def flax_to_masters(model: nn.Module, params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """flax ``variables["params"]`` (nested dict, or flat ``/``-joined keys)
    → fp32 CPU tensors by ``model``'s parameter names, in its layouts."""
    flat = flatten_flax(params)
    targets = dict(model.named_parameters())
    mapped = {_torch_name(path): path for path in flat}
    unused = sorted(path for name, path in mapped.items() if name not in targets)
    missing = sorted(name for name in targets if name not in mapped)
    if unused or missing:
        raise KeyError(f"flax params do not match the model: unused {unused[:8]}, "
                       f"missing {missing[:8]}")
    masters = {}
    for name, param in targets.items():
        path = mapped[name]
        value = _to_torch_layout(path, flat[path])
        if tuple(value.shape) != tuple(param.shape):
            raise ValueError(f"{path}: shape {value.shape} does not fit {name} "
                             f"{tuple(param.shape)}")
        masters[name] = torch.from_numpy(np.array(value, dtype=np.float32))
    return masters


def export_flax_params(model: nn.Module) -> Dict[str, Any]:
    """``model``'s parameters as a nested flax-layout tree of fp32 arrays
    (Dense kernels [in, out], the patch convolution HWIO), the inverse of
    ``load_flax_params``."""
    patch = {f"{name}.proj.weight": mod.patch_size
             for name, mod in model.named_modules() if isinstance(mod, PatchEmbed)}
    tree: Dict[str, Any] = {}
    paths = flax_paths(model)
    for name, param in model.named_parameters():
        value = param.detach().float().cpu().numpy()
        if paths[name].split("/")[-1] == "kernel":
            value = value.T
            if name in patch:
                value = value.reshape(patch[name], patch[name], -1, value.shape[-1])
        node = tree
        *scopes, leaf = paths[name].split("/")
        for scope in scopes:
            node = node.setdefault(scope, {})
        node[leaf] = np.ascontiguousarray(value)
    return tree


def load_flax_params(model: nn.Module, params: Mapping[str, Any]) -> None:
    """Copy flax ``variables["params"]`` into ``model``'s parameters, casting
    to each parameter's dtype and device."""
    masters = flax_to_masters(model, params)
    with torch.no_grad():
        for name, param in model.named_parameters():
            param.copy_(masters[name])


def load_params_npz(model: nn.Module, path: str) -> None:
    """Load a ``params.npz`` of ``/``-joined flax paths into ``model``."""
    with np.load(path) as npz:
        load_flax_params(model, {k: npz[k] for k in npz.files})
