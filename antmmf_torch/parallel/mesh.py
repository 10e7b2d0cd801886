"""The mesh of a run over ranks: which ranks share the batch and the shards.

Port of ``antmmf_tpu/parallel/mesh.py``. ``build_mesh`` keeps the JAX
function's arithmetic over the five axes (``data``, ``fsdp``, ``model``,
``expert``, ``seq``): the ``-1`` fill on one axis, the errors, and a
``dcn`` sub-mapping whose factor is the outermost on each combined axis;
``devices`` holds the rank ids in the layout JAX gives its devices. The
port carries the batch over ``data`` × ``fsdp`` and shards the fp32
masters and the optimizer state over ``fsdp``; ``model``, ``expert`` and
``seq`` above 1 over several ranks raise (queue A7b).

At world size 1 a declared mesh collapses: every axis is 1 and the whole
global batch runs on the one device (``collapsed`` says so), which is
what a mesh computes. Over several ranks the mesh must match the world
size, as ``build_mesh`` demands of the devices. Rank r loads the r-th
slice of the global batch (JAX's ``batch_spec`` split, rank-major, which
is the devices' order without ``dcn``), so a gather in rank order gives
back the global batch. ``fsdp_group`` makes each rank's ``fsdp`` process
group, over a ``torch.distributed`` ``DeviceMesh``.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Mapping, Optional

import numpy as np

MESH_AXES = ("data", "fsdp", "model", "expert", "seq")
BATCH_AXES = ("data", "fsdp")
LATER_AXES = ("model", "expert", "seq")


class Mesh:
    """Axis sizes (``shape``) and the rank ids laid out over them
    (``devices``, of shape ``tuple(shape.values())``)."""

    def __init__(self, devices: np.ndarray, collapsed: bool = False,
                 declared: Optional[Mapping[str, Any]] = None):
        self.devices = devices
        self.shape: Dict[str, int] = dict(zip(MESH_AXES, devices.shape))
        self.collapsed = collapsed
        self.declared = dict(declared or {})

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def fsdp_group(self, device_type: str = "cpu"):
        """This rank's ``fsdp`` process group, from a ``DeviceMesh`` over
        (data, fsdp); ``None`` in one process. Every rank calls it, in the
        same order."""
        from antmmf_torch.parallel import collectives as coll

        if not coll.is_distributed() or self.collapsed:
            return None
        from torch.distributed.device_mesh import DeviceMesh

        return DeviceMesh(device_type, self.devices[:, :, 0, 0, 0].tolist(),
                          mesh_dim_names=BATCH_AXES).get_group("fsdp")


def build_mesh(mesh_config: Optional[Mapping[str, Any]] = None,
               world_size: Optional[int] = None) -> Mesh:
    """A ``Mesh`` from an axis-size mapping over ``world_size`` ranks (the
    process group's; 1 without one). ``-1`` (on at most one axis) takes the
    remaining ranks; absent axes are 1; ``dcn`` gives each axis's
    slice-spanning factor, outermost."""
    if world_size is None:
        from antmmf_torch.parallel import collectives as coll

        world_size = coll.get_world_size()
    declared = dict(mesh_config or {})
    if world_size == 1:
        # one device computes what any mesh computes: record it, run on one
        _check_names(declared)
        return Mesh(np.zeros((1,) * len(MESH_AXES), dtype=np.int64), collapsed=True,
                    declared=declared)
    mesh = Mesh(layout(declared, world_size), declared=declared)
    later = {a: mesh.shape[a] for a in LATER_AXES if mesh.shape[a] > 1}
    if later:
        raise NotImplementedError(f"mesh axes {later} over {world_size} ranks: model, expert "
                                  f"and sequence parallelism are queue A7b, not ported yet")
    return mesh


def _check_names(cfg: Mapping[str, Any]) -> None:
    for axis in cfg:
        if axis != "dcn" and axis not in MESH_AXES:
            raise ValueError(f"Unknown mesh axis {axis!r}; valid: {MESH_AXES}")
    for axis in dict(cfg.get("dcn") or {}):
        if axis not in MESH_AXES:
            raise ValueError(f"Unknown dcn mesh axis {axis!r}; valid: {MESH_AXES}")


def layout(mesh_config: Mapping[str, Any], n: int) -> np.ndarray:
    """The rank ids 0..n-1 over the five axes, as the JAX ``build_mesh``
    lays out n CPU devices (its slice-major reshape under ``dcn``)."""
    cfg = dict(mesh_config or {})
    dcn_cfg = {a: int(s) for a, s in dict(cfg.pop("dcn", None) or {}).items()}
    for axis, size in dcn_cfg.items():
        if axis not in MESH_AXES:
            raise ValueError(f"Unknown dcn mesh axis {axis!r}; valid: {MESH_AXES}")
        if size < 1:
            raise ValueError(f"dcn sizes must be positive (no -1 fill); got {axis}={size}")
    dcn = {axis: dcn_cfg.get(axis, 1) for axis in MESH_AXES}
    n_dcn = math.prod(dcn.values())
    if n % n_dcn:
        raise ValueError(f"{n} devices not divisible by dcn degree {n_dcn}")
    n_ici = n // n_dcn
    sizes = {axis: 1 for axis in MESH_AXES}
    for axis, size in cfg.items():
        if axis not in sizes:
            raise ValueError(f"Unknown mesh axis {axis!r}; valid: {MESH_AXES}")
        sizes[axis] = int(size)
    fills = [a for a, s in sizes.items() if s == -1]
    if len(fills) > 1:
        raise ValueError(f"Only one mesh axis may be -1, got {fills}")
    if fills:
        sizes[fills[0]] = 1
        fixed = math.prod(sizes.values())
        if n_ici % fixed:
            raise ValueError(f"{n_ici} per-slice devices not divisible by fixed axes "
                             f"product {fixed}")
        sizes[fills[0]] = n_ici // fixed
    total = math.prod(sizes.values())
    if total != n_ici:
        raise ValueError(f"Mesh axis sizes {sizes} multiply to {total}, but {n_ici} "
                         f"devices are visible per slice")
    ici_shape = tuple(sizes[a] for a in MESH_AXES)
    ranks = np.arange(n, dtype=np.int64)
    if n_dcn == 1:
        return ranks.reshape(ici_shape)
    dcn_shape = tuple(dcn[a] for a in MESH_AXES)
    k = len(MESH_AXES)
    order = [x for pair in zip(range(k), range(k, 2 * k)) for x in pair]
    return ranks.reshape(dcn_shape + ici_shape).transpose(order).reshape(
        tuple(d * i for d, i in zip(dcn_shape, ici_shape)))


def data_parallel_size(mesh: Mesh) -> int:
    return int(mesh.shape["data"] * mesh.shape["fsdp"])


def local_batch_size(global_batch_size: int, mesh: Mesh) -> int:
    dp = data_parallel_size(mesh)
    if global_batch_size % dp:
        raise ValueError(f"Global batch size {global_batch_size} must be divisible by the "
                         f"data-parallel degree {dp} (mesh {mesh.shape})")
    return global_batch_size // dp
