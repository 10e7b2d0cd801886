"""Carry the JAX package's flax parameters into the port's modules.

The port's parameter names mirror the flax tree (``base.img_encoder.encoder.
layer_0.attention.q_proj``), so the carry is a name map plus transposes:

* ``Dense`` ``kernel`` [in, out] → ``Linear.weight`` [out, in];
* ``Conv`` ``kernel`` HWIO [p, p, 3, C] → the patch-matmul weight [C, p·p·3];
  a ``Conv`` the port keeps as an ``nn.Conv2d`` (M2-omni's audio
  ``subsample0``/``subsample1``) HWIO → OIHW;
* SANM's ``fsmn_kernel`` [k, 1, d] → the depthwise ``Conv1d`` weight [d, 1, k];
* ``LayerNorm_0/scale`` and ``LayerNorm_0/bias`` → ``weight`` and ``bias``;
* ``Embed`` ``embedding`` → ``weight``;
* everything else (``pos_embedding``, ``cls_token``, the ``logit_scale``
  scalar, ``RMSNorm``'s ``scale``, the ``lora_a``/``lora_b`` matrices of
  ``LoRADense``, the ``q_lora_a``-style adapters inside attention, and
  ``ClassifierLayer``'s ``weight`` [in, labels], ``scale`` and ``queries``)
  as is.

``QuantDense`` carries like the ``Linear`` it is; ``LoRADense`` keeps flax's
``base`` scope. Decode records (``{"q4", "scale"}`` and ``{"q", "scale"}``
dicts in place of a kernel) count as leaves of a tree:
``predictors/quantization.load_decode_records`` loads those.
``export_flax_params`` is the way back, a module's parameters as a flax-layout
tree of fp32 arrays, which ``quantize_for_decode`` takes.

A decoder built with ``scan_layers`` (the JAX package's ``nn.scan`` over
its layers) keeps its ``layer_{i}`` modules in the port, and so do its
parameter names, its ``flax_paths`` and its checkpoints. The bridge reads
either layout: a ``layers`` scope whose leaves carry a leading [num_layers]
dim is split into ``layer_0..layer_{N-1}`` in the order of that dim
(``unstack_layers``, as ``unstack_decoder_layers`` does); and writes the
stacked one for such a decoder (``stack_layers``), so that its
``params.npz`` reloads in the JAX model.

``load_flax_variables`` carries a whole flax variables dict: ``params``, the
model's ``moco`` collection (each queue's ``queue``, ``ptr`` and ``filled``
into its ``MocoQueue`` buffers) and the trainer's ``momentum`` collection
(the EMA towers, into ``TrainState.momentum``); ``export_flax_variables`` is
its inverse.

A missing or unused key, or a shape mismatch, raises. ``params.npz`` files
hold the flax leaves under ``/``-joined paths; they are one of the port's
``model_dir`` formats (``common/checkpoint.py`` reads them beside a
trainer's checkpoints). ``flax_to_masters`` gives the same carry as fp32
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

from antmmf_torch.modules.embeddings import PatchConv
from antmmf_torch.modules.layers import LayerNorm
from antmmf_torch.modules.llm import DecoderLM
from antmmf_torch.modules.moco import queue_buffers
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


def _leading(leaf: Any, i: int) -> Any:
    return {k: v[i] for k, v in leaf.items()} if isinstance(leaf, Mapping) else leaf[i]


def unstack_layers(flat: Mapping[str, Any]) -> Dict[str, Any]:
    """Flat leaves with each ``.../layers/...`` leaf [N, ...] (a scanned
    stack) split into ``.../layer_{i}/...`` leaves, i = 0..N-1 in the order
    of the leading dim; other leaves as they are."""
    out: Dict[str, Any] = {}
    for path, leaf in flat.items():
        parts = path.split("/")
        if "layers" not in parts:
            out[path] = leaf
            continue
        at = parts.index("layers")
        n = (leaf["scale"] if isinstance(leaf, Mapping) else leaf).shape[0]
        for i in range(n):
            out["/".join(parts[:at] + [f"layer_{i}"] + parts[at + 1:])] = _leading(leaf, i)
    return out


def stacked_scopes(model: nn.Module) -> list:
    """The flax scopes of ``model``'s decoders built with ``scan_layers``."""
    return [name.replace(".", "/") for name, mod in model.named_modules()
            if isinstance(mod, DecoderLM) and mod.scan_layers]


def stack_layers(flat: Mapping[str, Any], scopes) -> Dict[str, Any]:
    """The inverse of ``unstack_layers`` under each scope of ``scopes``:
    ``scope/layer_{i}/rest`` leaves stacked into ``scope/layers/rest`` along
    a leading dim, layer 0 first."""
    out, groups = {}, {}
    for path, leaf in flat.items():
        scope = next((sc for sc in scopes if path.startswith(f"{sc}/layer_")), None)
        if scope is None:
            out[path] = leaf
            continue
        layer, rest = path[len(scope) + 1:].split("/", 1)
        groups.setdefault((scope, rest), {})[int(layer[len("layer_"):])] = leaf
    for (scope, rest), by_layer in groups.items():
        if sorted(by_layer) != list(range(len(by_layer))):
            raise ValueError(f"{scope}: layers {sorted(by_layer)} of {rest} are not 0..N-1")
        out[f"{scope}/layers/{rest}"] = np.stack([by_layer[i] for i in range(len(by_layer))])
    return out


def _torch_name(flax_path: str) -> str:
    parts = flax_path.split("/")
    if len(parts) >= 2 and parts[-2] == "LayerNorm_0":
        parts = parts[:-2] + [{"scale": "weight", "bias": "bias"}[parts[-1]]]
    elif parts[-1] in ("kernel", "embedding"):
        parts[-1] = "weight"
    return ".".join(parts)


def to_torch_layout(flax_path: str, value: np.ndarray, shape=None) -> np.ndarray:
    """A flax leaf in the layout of the port's parameter (of ``shape``, which
    tells a 4-D ``nn.Conv2d`` weight from a patch-matmul weight)."""
    leaf = flax_path.split("/")[-1]
    if leaf == "kernel":
        if value.ndim == 4 and shape is not None and len(shape) == 4:
            return value.transpose(3, 2, 0, 1)  # Conv2d: HWIO → OIHW
        return value.reshape(-1, value.shape[-1]).T  # Dense [in,out] or Conv HWIO
    if leaf == "fsmn_kernel":
        return value.transpose(2, 1, 0)  # [k, 1, d] → the depthwise Conv1d's [d, 1, k]
    return value


def to_flax_layout(flax_path: str, t: torch.Tensor) -> torch.Tensor:
    """The inverse of ``to_torch_layout`` for every leaf but the patch
    convolution's (``_flax_tree`` reshapes that one)."""
    leaf = flax_path.split("/")[-1]
    if leaf == "kernel":
        return t.permute(2, 3, 1, 0) if t.dim() == 4 else t.T
    if leaf == "fsmn_kernel":
        return t.permute(2, 1, 0)
    return t


def flax_paths(model: nn.Module) -> Dict[str, str]:
    """Each parameter's name → its flax path (``a/b/kernel``)."""
    leaves = {nn.Linear: {"weight": "kernel", "bias": "bias"},
              PatchConv: {"weight": "kernel", "bias": "bias"},
              QuantDense: {"weight": "kernel"},
              nn.Conv2d: {"weight": "kernel", "bias": "bias"},
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
    """flax ``variables["params"]`` (nested dict, or flat ``/``-joined keys;
    a decoder's layers stacked or not) → fp32 CPU tensors by ``model``'s
    parameter names, in its layouts."""
    flat = unstack_layers(flatten_flax(params))
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
        value = to_torch_layout(path, flat[path], param.shape)
        if tuple(value.shape) != tuple(param.shape):
            raise ValueError(f"{path}: shape {value.shape} does not fit {name} "
                             f"{tuple(param.shape)}")
        masters[name] = torch.from_numpy(np.array(value, dtype=np.float32))
    return masters


def _nest(flat: Mapping[str, Any]) -> Dict[str, Any]:
    """{"a/b/kernel": leaf} → the nested tree."""
    tree: Dict[str, Any] = {}
    for path, leaf in flat.items():
        node = tree
        *scopes, name = path.split("/")
        for scope in scopes:
            node = node.setdefault(scope, {})
        node[name] = leaf
    return tree


def _flax_tree(model: nn.Module, tensors: Mapping[str, torch.Tensor],
               stacked: bool = True) -> Dict[str, Any]:
    """Tensors by ``model``'s parameter names → a nested flax-layout tree of
    fp32 arrays (Dense kernels [in, out], the patch convolution HWIO), a
    ``scan_layers`` decoder's layers stacked unless ``stacked`` is off."""
    patch = {f"{name}.weight": mod.patch_size
             for name, mod in model.named_modules() if isinstance(mod, PatchConv)}
    paths = flax_paths(model)
    flat = {}
    for name, t in tensors.items():
        # transposed where the tensor lives (numpy's copy is serial)
        t = to_flax_layout(paths[name], t.detach().float()).contiguous()
        value = t.to("cpu", copy=True).numpy()  # a copy: never a view of a live tensor
        if name in patch:
            value = value.reshape(patch[name], patch[name], -1, value.shape[-1])
        flat[paths[name]] = value
    return _nest(stack_layers(flat, stacked_scopes(model)) if stacked else flat)


def export_flax_params(model: nn.Module, stacked: bool = True) -> Dict[str, Any]:
    """``model``'s parameters as a nested flax-layout tree of fp32 arrays
    (Dense kernels [in, out], the patch convolution HWIO; a ``scan_layers``
    decoder's layers stacked unless ``stacked`` is off), the inverse of
    ``load_flax_params``."""
    return _flax_tree(model, dict(model.named_parameters()), stacked)


def export_flax_variables(model: nn.Module, state=None) -> Dict[str, Any]:
    """``{"params", "moco", "momentum"}`` in flax layout: the parameters (the
    state's fp32 masters when a ``TrainState`` is given), the queues as
    numpy arrays (``ptr``/``filled`` int32, as flax keeps them) and the
    state's momentum towers; a collection the model or state lacks is left
    out. The inverse of ``load_flax_variables``."""
    out = {"params": _flax_tree(model, state.params if state is not None
                                else dict(model.named_parameters()))}
    queues = queue_buffers(model)
    if queues:
        out["moco"] = _nest({path: t.cpu().numpy().astype(
            np.int32 if path.split("/")[-1] in ("ptr", "filled") else np.float32)
            for path, t in queues.items()})
    if state is not None and state.momentum is not None:
        out["momentum"] = _flax_tree(model, state.momentum)
    return out


def load_flax_variables(model: nn.Module, variables: Mapping[str, Any], state=None) -> None:
    """flax ``variables`` into the port: ``params`` into the model (into the
    state's fp32 masters, then the model, when a ``TrainState`` is given),
    every queue of the ``moco`` collection into the model's buffers, and the
    ``momentum`` collection into ``state.momentum`` (then its key module).
    A leaf that is missing, unused or of another shape raises."""
    if "params" in variables:
        if state is None:
            load_flax_params(model, variables["params"])
        else:
            masters = flax_to_masters(model, variables["params"])
            with torch.no_grad():
                for name, t in state.params.items():
                    t.copy_(masters[name])
            state.sync_model(frozen=True)
    buffers = queue_buffers(model)
    loaded = flatten_flax(variables.get("moco", {}))
    if set(loaded) != set(buffers):
        raise KeyError(f"moco collection {sorted(loaded)} does not match the model's "
                       f"queues {sorted(buffers)}")
    with torch.no_grad():
        for path, t in buffers.items():
            if tuple(loaded[path].shape) != tuple(t.shape):
                raise ValueError(f"moco/{path}: shape {loaded[path].shape} does not fit "
                                 f"{tuple(t.shape)}")
            t.copy_(torch.from_numpy(np.array(loaded[path])))
    if "momentum" in variables:
        if state is None or state.momentum is None:
            raise KeyError("a momentum collection needs a TrainState with momentum towers")
        by_path = {path: name for name, path in flax_paths(model).items()
                   if name in state.momentum}
        flat = flatten_flax(variables["momentum"])
        if set(flat) != set(by_path):
            raise KeyError(f"momentum collection does not match the state's towers: "
                           f"unused {sorted(set(flat) - set(by_path))[:8]}, "
                           f"missing {sorted(set(by_path) - set(flat))[:8]}")
        with torch.no_grad():
            for path, name in by_path.items():
                value = to_torch_layout(path, flat[path], state.momentum[name].shape)
                if tuple(value.shape) != tuple(state.momentum[name].shape):
                    raise ValueError(f"momentum/{path}: shape {value.shape} does not fit "
                                     f"{name}")
                state.momentum[name].copy_(torch.from_numpy(np.array(value, np.float32)))
        state.sync_key_module()


def load_flax_params(model: nn.Module, params: Mapping[str, Any]) -> None:
    """Copy flax ``variables["params"]`` into ``model``'s parameters, casting
    to each parameter's dtype and device."""
    masters = flax_to_masters(model, params)
    with torch.no_grad():
        for name, param in model.named_parameters():
            param.copy_(masters[name])
