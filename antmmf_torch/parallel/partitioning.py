"""Rule-based sharding of the fp32 masters and the optimizer state.

Port of ``antmmf_tpu/parallel/partitioning.py`` for the ``data`` and
``fsdp`` axes. Regular-expression rules over each parameter's ``/``-joined
flax path (``utils.weights.flax_paths``, so one config's rules name the
same leaves in both packages), the first full match winning::

    param_sharding_rules:
      - [".*kernel", ["fsdp", null]]   # shard the kernels' first dimension
      - [".*", null]                   # replicate the rest

``spec_for`` gives a rule's spec (a tuple, one entry a flax dimension,
right-aligned on the leaf's rank, as the JAX function aligns it);
``infer_param_specs`` maps a path → shape dictionary to specs,
``relax_to_divisible`` replicates a dimension the axis does not divide,
``validate_specs`` lists such dimensions. ``shard_dims`` turns the specs
into the dimension of the port's tensor that the ``fsdp`` axis splits: a
flax kernel [in, out] is the port's [out, in], a convolution's HWIO its
OIHW. A rule may name ``seq``: the ranks of a ``seq`` line each hold the
whole state, so such an entry shards nothing here. A rule that names
``model`` or ``expert`` raises (the later parts of queue A7b).
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple, Union

Spec = Tuple[Any, ...]
Rules = Sequence[Tuple[str, Optional[Sequence[Union[str, Sequence[str], None]]]]]

# the JAX package's defaults (``partitioning.py:35-55``)
DEFAULT_RULES: Rules = (
    (r"(.*/)?layers/.*(kernel|embedding)$", (None, "fsdp", None)),
    (r"(.*/)?blocks_\d+_\d+/.*(kernel|embedding)$", (None, "fsdp", None)),
    (r".*token_embed/embedding$", (None, "fsdp")),
    (r".*lm_head/kernel$", (None, "fsdp")),
    (r".*(kernel|embedding)$", ("fsdp", None)),
    (r".*", None),
)
PORTED_AXES = ("data", "fsdp", "seq")


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (list, tuple)) else (entry,)


def check_rules(rules: Rules) -> None:
    """Raise on a rule that names an axis the port does not carry yet."""
    for pattern, spec in rules:
        for entry in (spec or ()):
            later = [a for a in _axes(entry) if a not in PORTED_AXES]
            if later:
                raise NotImplementedError(
                    f"param_sharding_rules {pattern!r} names {later}: tensor and expert "
                    f"parallelism are the later parts of queue A7b, not ported yet")


def spec_for(path_string: str, ndim: int, rules: Rules) -> Spec:
    for pattern, spec in rules:
        if re.fullmatch(pattern, path_string):
            if spec is None:
                return ()
            spec = list(spec)
            if len(spec) > ndim:
                spec = spec[-ndim:] if ndim else []
            while len(spec) < ndim:
                spec.insert(0, None)
            return tuple(tuple(s) if isinstance(s, list) else s for s in spec)
    return ()


def infer_param_specs(shapes: Mapping[str, Sequence[int]],
                      rules: Optional[Rules] = None) -> Dict[str, Spec]:
    """flax path → spec, for a path → flax-layout shape mapping."""
    rules = tuple(rules) if rules else DEFAULT_RULES
    check_rules(rules)
    return {path: spec_for(path, len(shape), rules) for path, shape in shapes.items()}


def _axis_size(entry, mesh_shape: Mapping[str, int]) -> int:
    size = 1
    for a in _axes(entry):
        size *= int(mesh_shape[a])
    return size


def relax_to_divisible(specs: Mapping[str, Spec], shapes: Mapping[str, Sequence[int]],
                       mesh_shape: Mapping[str, int]) -> Dict[str, Spec]:
    """Replicate each dimension whose size the axes' product does not divide."""
    return {path: tuple(e if e is None or shapes[path][d] % _axis_size(e, mesh_shape) == 0
                        else None for d, e in enumerate(spec))
            for path, spec in specs.items()}


def validate_specs(shapes: Mapping[str, Sequence[int]], specs: Mapping[str, Spec],
                   mesh_shape: Mapping[str, int]) -> List[str]:
    problems = []
    for path, spec in specs.items():
        for dim, entry in enumerate(spec):
            if entry is None:
                continue
            size = _axis_size(entry, mesh_shape)
            if shapes[path][dim] % size:
                problems.append(f"{path}: dim {dim} ({shapes[path][dim]}) not divisible by "
                                f"mesh axes {_axes(entry)} (size {size})")
    return problems


def flax_shape(path: str, shape: Sequence[int]) -> Tuple[int, ...]:
    """The flax layout's shape of a port tensor of ``shape`` at ``path``."""
    shape = tuple(shape)
    leaf = path.split("/")[-1]
    if leaf == "kernel":
        return shape[2:] + shape[1:2] + shape[:1] if len(shape) == 4 else shape[::-1]
    if leaf == "fsmn_kernel":
        return shape[::-1]
    return shape


def torch_dim(path: str, ndim: int, flax_dim: int) -> int:
    """The port tensor's dimension that holds flax dimension ``flax_dim``."""
    leaf = path.split("/")[-1]
    if leaf == "kernel":
        return (2, 3, 1, 0)[flax_dim] if ndim == 4 else ndim - 1 - flax_dim
    if leaf == "fsmn_kernel":
        return ndim - 1 - flax_dim
    return flax_dim


def shard_dims(paths: Mapping[str, str], shapes: Mapping[str, Sequence[int]],
               fsdp: int, rules: Optional[Rules] = None) -> Dict[str, int]:
    """Parameter name → the dimension of the port's tensor that ``fsdp``
    ranks split, for the parameters a rule shards over ``fsdp`` and whose
    dimension ``fsdp`` divides (the others are replicated)."""
    if fsdp <= 1:
        check_rules(tuple(rules) if rules else DEFAULT_RULES)
        return {}
    fshapes = {paths[n]: flax_shape(paths[n], s) for n, s in shapes.items()}
    specs = relax_to_divisible(infer_param_specs(fshapes, rules), fshapes,
                               {"data": 1, "fsdp": fsdp, "seq": 1})
    out = {}
    for name, path in paths.items():
        dims = [d for d, e in enumerate(specs[path]) if "fsdp" in _axes(e)]
        if dims:
            out[name] = torch_dim(path, len(shapes[name]), dims[0])
    return out
