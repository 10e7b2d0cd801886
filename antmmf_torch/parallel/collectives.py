"""The collectives of a run over ranks, on ``torch.distributed``.

Port of ``antmmf_tpu/parallel/collectives.py``. The JAX package runs one
SPMD program over a mesh, and its in-step collectives are ``lax``
primitives; the port runs one process a rank (the reference AntMMF's
DDP mode), and the same surface maps onto ``torch.distributed``:

* host level: ``init_distributed`` (from the launcher's ``WORLD_SIZE``,
  ``RANK``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``),
  ``get_rank``, ``get_world_size``, ``is_main_process``, ``synchronize``,
  ``broadcast_scalar`` and ``all_gather_object``, which run on a gloo group
  of their own, so a host value never waits on the card;
* in step: ``gather_with_grad``, an all-gather whose backward is a
  reduce-scatter (the sum over ranks of the cotangent of each rank's rows:
  every rank computes its loss from the gathered rows, and the trainer
  averages the gradients, so the product is the global gradient, as
  ``lax.all_gather``'s transpose gives it), ``all_gather`` without
  gradients, and the fp32 gradient mean ``all_reduce_mean``.

The backend is chosen from the world, never from a config key: NCCL when
each rank of a node has a card of its own, gloo on the CPU and when ranks
share a card (NCCL refuses two ranks on one device). gloo carries a CUDA
tensor through a host copy. ``all_to_all``, ``ppermute`` and
``axis_index`` belong to the model, expert and sequence axes, not ported
yet. Outside a process group every function is the identity of one
process.
"""

from __future__ import annotations

import os
from typing import Any, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

_STATE: dict = {"backend": None, "host_group": None}


def init_distributed(device: str = "cpu") -> Optional[str]:
    """Join the launcher's process group: a no-op (``None``) without the
    launcher's environment or once joined; else the backend's name. A rank
    on the card takes ``cuda:{LOCAL_RANK % device_count}``."""
    if is_distributed():
        return _STATE["backend"]
    if "WORLD_SIZE" not in os.environ:
        return None
    world = int(os.environ["WORLD_SIZE"])
    if "MASTER_ADDR" not in os.environ or "MASTER_PORT" not in os.environ:
        if world > 1:
            raise RuntimeError(f"WORLD_SIZE gives world size {world}, but MASTER_ADDR and "
                               f"MASTER_PORT are not set: start the ranks with "
                               f"antmmf_torch.utils.launch")
        return None
    rank = int(os.environ["RANK"])
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    backend = "gloo"
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a CUDA run over ranks, but CUDA is not available")
        count = torch.cuda.device_count()
        torch.cuda.set_device(local_rank % count)
        backend = "nccl" if local_world <= count else "gloo"
    dist.init_process_group(
        backend, init_method=f"tcp://{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}",
        world_size=world, rank=rank)
    _STATE["backend"] = backend
    _STATE["host_group"] = dist.new_group(backend="gloo") if backend != "gloo" else None
    return backend


def is_distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def backend() -> Optional[str]:
    return _STATE["backend"] if is_distributed() else None


def get_rank() -> int:
    return dist.get_rank() if is_distributed() else 0


def get_world_size() -> int:
    return dist.get_world_size() if is_distributed() else 1


def is_main_process() -> bool:
    return get_rank() == 0


def synchronize() -> None:
    if is_distributed():
        dist.barrier(group=_STATE["host_group"])


def broadcast_scalar(value: float, source: int = 0) -> float:
    """A host scalar of rank ``source`` on every rank (the early-stop flag)."""
    if not is_distributed():
        return value
    t = torch.tensor([float(value)], dtype=torch.float64)
    dist.broadcast(t, src=source, group=_STATE["host_group"])
    return float(t.item())


def all_reduce_max_scalar(value: float) -> float:
    """The largest of every rank's host scalar (a flag raised on any rank)."""
    if not is_distributed():
        return value
    t = torch.tensor([float(value)], dtype=torch.float64)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=_STATE["host_group"])
    return float(t.item())


def all_gather_object(obj: Any) -> List[Any]:
    """Every rank's picklable ``obj``, in rank order."""
    if not is_distributed():
        return [obj]
    out: List[Any] = [None] * get_world_size()
    dist.all_gather_object(out, obj, group=_STATE["host_group"])
    return out


def group_rank(group) -> int:
    """This rank's index in ``group`` (the order of a gather over it)."""
    return dist.get_rank(group) if is_distributed() else 0


def group_ranks(group) -> List[int]:
    """The world ranks of ``group`` (the world's without one), in its order."""
    if not is_distributed():
        return [0]
    return dist.get_process_group_ranks(group if group is not None else dist.group.WORLD)


def rank_seed(seed: int, rank: int) -> int:
    """The seed of rank ``rank``'s generator in a run seeded ``seed``: two
    ranks never draw the same masks."""
    return int(np.random.SeedSequence([int(seed), int(rank)]).generate_state(1)[0])


# ------------------------------------------------------------------ in step


def _staged(t: torch.Tensor) -> bool:
    return t.is_cuda and _STATE["backend"] == "gloo"


def all_reduce_(t: torch.Tensor, op=None, group=None) -> torch.Tensor:
    """In-place all-reduce (a sum unless ``op``) over ``group`` (the world)."""
    if not is_distributed():
        return t
    op = dist.ReduceOp.SUM if op is None else op
    if _staged(t):
        host = t.cpu()
        dist.all_reduce(host, op=op, group=group)
        t.copy_(host)
    else:
        dist.all_reduce(t, op=op, group=group)
    return t


def gather_list(t: torch.Tensor, group=None) -> List[torch.Tensor]:
    """Every rank's ``t`` (of one shape on all ranks) in the group's rank
    order, without gradients."""
    size = dist.get_world_size(group)
    src = t.detach().contiguous()
    if _staged(src):
        parts = [torch.empty_like(src, device="cpu") for _ in range(size)]
        dist.all_gather(parts, src.cpu(), group=group)
        return [p.to(t.device) for p in parts]
    parts = [torch.empty_like(src) for _ in range(size)]
    dist.all_gather(parts, src, group=group)
    return parts


def gather_to(t: torch.Tensor, dst: int, group=None) -> Optional[List[torch.Tensor]]:
    """Every rank's ``t`` (of one shape on all ranks) on the host of world
    rank ``dst``, in the group's rank order; ``None`` on the other ranks."""
    src = t.detach().contiguous()
    mine = get_rank() == dst
    if src.is_cuda and not _staged(src):
        parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))] if mine \
            else None
        dist.gather(src, parts, dst=dst, group=group)
        return [p.cpu() for p in parts] if mine else None
    src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))] if mine else None
    dist.gather(src, parts, dst=dst, group=group)
    return parts


def all_gather(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order (tiled),
    without gradients."""
    if not is_distributed():
        return x.detach()
    return torch.cat(gather_list(x), dim=dim)


class _GatherWithGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        ctx.rows = x.shape[0]
        return torch.cat(gather_list(x), dim=0)

    @staticmethod
    def backward(ctx, grad: torch.Tensor) -> torch.Tensor:
        # reduce-scatter: the sum over ranks of this rank's rows' cotangent
        grad = all_reduce_(grad.contiguous().clone())
        start = get_rank() * ctx.rows
        return grad[start:start + ctx.rows]


def gather_with_grad(x: torch.Tensor) -> torch.Tensor:
    """Every rank's rows of ``x`` (the same count on every rank),
    concatenated in rank order along dim 0, with gradients: the backward
    gives each rank the sum over ranks of its rows' cotangent."""
    if not is_distributed():
        return x
    return _GatherWithGrad.apply(x)


def all_reduce_mean(tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The mean over ranks of each tensor, through one flat fp32 buffer."""
    if not is_distributed() or not tensors:
        return list(tensors)
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    all_reduce_(flat)
    flat.div_(get_world_size())
    out, start = [], 0
    for t in tensors:
        out.append(flat[start:start + t.numel()].view(t.shape).to(t.dtype))
        start += t.numel()
    return out
