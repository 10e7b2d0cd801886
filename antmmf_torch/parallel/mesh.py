"""The mesh of a run over ranks: which ranks share the batch and the shards.

Port of ``antmmf_tpu/parallel/mesh.py``. ``build_mesh`` keeps the JAX
function's arithmetic over the five axes (``data``, ``fsdp``, ``model``,
``expert``, ``seq``): the ``-1`` fill on one axis, the errors, and a
``dcn`` sub-mapping whose factor is the outermost on each combined axis;
``devices`` holds the rank ids in the layout JAX gives its devices. The
port carries the batch over ``data`` × ``fsdp`` and shards the fp32
masters and the optimizer state over ``fsdp``, and the token stream over
``seq`` (``parallel.long_context``): the ranks of a ``seq`` line hold the
same batch. ``model`` and ``expert`` above 1 over several ranks raise
(pipeline, tensor and expert parallelism: the later parts of queue A7b).

At world size 1 a declared mesh collapses: every axis is 1 and the whole
global batch runs on the one device (``collapsed`` says so), which is
what a mesh computes. Over several ranks the mesh must match the world
size, as ``build_mesh`` demands of the devices. Rank r loads the r-th
slice of the global batch, r its index over (``data``, ``fsdp``) (JAX's
``batch_spec`` split, rank-major, which is the devices' order without
``dcn``), so a gather in that order gives back the global batch.
``fsdp_group`` makes each rank's ``fsdp`` process group, over a
``torch.distributed`` ``DeviceMesh``; ``seq_group`` and ``batch_group``
its ``seq`` line and the ranks that share its ``seq`` coordinate.

``set_active_mesh`` registers the run's mesh (the JAX trainer's
``registry.register("mesh", ...)``), which a module with a
``sequence_parallel`` knob reads through ``active_seq_group``: outside a
registered mesh with ``seq`` > 1 the knob changes nothing.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Mapping, Optional

import numpy as np

MESH_AXES = ("data", "fsdp", "model", "expert", "seq")
BATCH_AXES = ("data", "fsdp")
LATER_AXES = ("model", "expert")
_ACTIVE: Dict[str, Any] = {"mesh": None}


class Mesh:
    """Axis sizes (``shape``) and the rank ids laid out over them
    (``devices``, of shape ``tuple(shape.values())``)."""

    def __init__(self, devices: np.ndarray, collapsed: bool = False,
                 declared: Optional[Mapping[str, Any]] = None):
        self.devices = devices
        self.shape: Dict[str, int] = dict(zip(MESH_AXES, devices.shape))
        self.collapsed = collapsed
        self.declared = dict(declared or {})
        self._made = None  # this rank's seq and batch process groups, made at first use

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def coords(self, rank: int) -> Dict[str, int]:
        """Rank ``rank``'s coordinate on each axis."""
        where = np.argwhere(self.devices == rank)[0]
        return dict(zip(MESH_AXES, (int(c) for c in where)))

    def batch_index(self, rank: int) -> int:
        """Which slice of the global batch rank ``rank`` loads: its index
        over (data, fsdp), the same on every rank of its ``seq`` line."""
        c = self.coords(rank)
        return c["data"] * self.shape["fsdp"] + c["fsdp"]

    def _groups(self) -> Dict[str, Any]:
        """This rank's ``seq`` line and batch plane as process groups; every
        rank makes every group, in one order (``new_group`` is collective)."""
        if self._made is None:
            import torch.distributed as dist
            from antmmf_torch.parallel import collectives as coll

            me = coll.get_rank()
            grid = self.devices.reshape(-1, self.shape["seq"])  # (data, fsdp) x seq
            made = {}
            for line in grid.tolist():
                group = dist.new_group(line)
                if me in line:
                    made["seq"] = group
            for plane in grid.T.tolist():
                group = dist.new_group(plane)
                if me in plane:
                    made["batch"] = group
            self._made = made
        return self._made

    def seq_group(self):
        """This rank's ``seq`` process group (``None`` without one)."""
        if self.collapsed or self.shape["seq"] == 1:
            return None
        return self._groups()["seq"]

    def batch_group(self):
        """The process group of the ranks with this rank's ``seq``
        coordinate: the global batch's ranks (``None`` without ``seq``)."""
        if self.collapsed or self.shape["seq"] == 1:
            return None
        return self._groups()["batch"]

    def fsdp_group(self, device_type: str = "cpu"):
        """This rank's ``fsdp`` process group, from a ``DeviceMesh`` over
        (data, fsdp); ``None`` in one process. Every rank calls it, in the
        same order."""
        from antmmf_torch.parallel import collectives as coll

        if not coll.is_distributed() or self.collapsed:
            return None
        from torch.distributed.device_mesh import DeviceMesh

        if self.shape["seq"] == 1:
            return DeviceMesh(device_type, self.devices[:, :, 0, 0, 0].tolist(),
                              mesh_dim_names=BATCH_AXES).get_group("fsdp")
        return DeviceMesh(device_type, self.devices[:, :, 0, 0, :].tolist(),
                          mesh_dim_names=BATCH_AXES + ("seq",)).get_group("fsdp")


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
        raise NotImplementedError(f"mesh axes {later} over {world_size} ranks: tensor, pipeline "
                                  f"and expert parallelism are the later parts of queue A7b, "
                                  f"not ported yet")
    return mesh


def set_active_mesh(mesh: Optional[Mesh]) -> None:
    """Register the run's mesh (``None`` to clear it); over a ``seq`` axis
    the batch collectives then run over this rank's batch plane."""
    from antmmf_torch.parallel import collectives as coll

    _ACTIVE["mesh"] = mesh
    group = mesh.batch_group() if mesh is not None and coll.is_distributed() else None
    coll.set_batch_group(group, mesh.batch_index(coll.get_rank()) if group is not None else 0)


def active_mesh() -> Optional[Mesh]:
    return _ACTIVE["mesh"]


def active_seq_group():
    """The registered mesh's ``seq`` group of this rank when its ``seq``
    axis is above 1 over ranks, else ``None`` (the knob then does nothing)."""
    mesh = _ACTIVE["mesh"]
    return None if mesh is None else mesh.seq_group()


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
