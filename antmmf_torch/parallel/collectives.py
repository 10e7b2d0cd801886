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
tensor through a host copy. Outside a process group every function is the identity of one
process.
"""

from __future__ import annotations

import os
from typing import Any, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

_STATE: dict = {"backend": None, "host_group": None, "batch_group": None, "batch_index": 0}


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


def set_batch_group(group, index: int) -> None:
    """The ranks the batch collectives run over (those with this rank's
    ``seq`` coordinate) and this rank's index among them; ``None`` for the
    world."""
    _STATE["batch_group"], _STATE["batch_index"] = group, int(index)


def batch_index() -> int:
    """This rank's slice of the global batch (its rank without a ``seq`` axis)."""
    if not is_distributed():
        return 0
    return _STATE["batch_index"] if _STATE["batch_group"] is not None else get_rank()


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
    """Every batch rank's ``x`` concatenated along ``dim`` in rank order
    (tiled), without gradients."""
    if not is_distributed():
        return x.detach()
    return torch.cat(gather_list(x, _STATE["batch_group"]), dim=dim)


class _GatherWithGrad(torch.autograd.Function):
    """All-gather along ``dim`` over ``group``; the backward is the
    reduce-scatter (the sum over the group of this rank's slice's cotangent)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group, index: int, dim: int) -> torch.Tensor:
        ctx.group, ctx.index, ctx.dim, ctx.size = group, index, dim, x.shape[dim]
        return torch.cat(gather_list(x, group), dim=dim)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        grad = all_reduce_(grad.contiguous().clone(), group=ctx.group)
        return grad.narrow(ctx.dim, ctx.index * ctx.size, ctx.size), None, None, None


def gather_with_grad(x: torch.Tensor) -> torch.Tensor:
    """Every batch rank's rows of ``x`` (the same count on every rank),
    concatenated in rank order along dim 0, with gradients: the backward
    gives each rank the sum over ranks of its rows' cotangent."""
    if not is_distributed():
        return x
    return _GatherWithGrad.apply(x, _STATE["batch_group"], batch_index(), 0)


# ------------------------------------------------------------ the seq axis
def axis_index(group) -> int:
    """This rank's coordinate on the axis of ``group`` (``lax.axis_index``)."""
    return group_rank(group)


def axis_size(group) -> int:
    return dist.get_world_size(group) if is_distributed() else 1


def all_gather_seq(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The group's slices of ``x`` concatenated along ``dim`` in axis order,
    with gradients (backward: the reduce-scatter, the transpose)."""
    return _GatherWithGrad.apply(x, group, axis_index(group), dim)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        return all_reduce_(x.detach().clone(), group=group)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return all_reduce_(grad.contiguous().clone(), group=ctx.group), None


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum over ``group`` (the world) of ``x``, with gradients: the
    backward sums the cotangent over the group, the transpose (``psum``)."""
    if not is_distributed():
        return x
    return _AllReduceSum.apply(x, group)


def _exchange(x: torch.Tensor, group, split_dim: int, concat_dim: int) -> torch.Tensor:
    """``lax.all_to_all(tiled=True)``: chunk j of ``x`` along ``split_dim``
    goes to rank j of the group; the chunks received are concatenated along
    ``concat_dim`` in the senders' order."""
    n = dist.get_world_size(group)
    send = torch.stack([c.contiguous() for c in x.chunk(n, split_dim)])
    if _staged(send):
        host = send.cpu()
        recv = torch.empty_like(host)
        dist.all_to_all_single(recv, host, group=group)
        recv = recv.to(x.device)
    else:
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=group)
    return torch.cat(list(recv.unbind(0)), dim=concat_dim)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, group, split_dim: int, concat_dim: int) -> torch.Tensor:
        ctx.group, ctx.dims = group, (split_dim, concat_dim)
        return _exchange(x, group, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        split_dim, concat_dim = ctx.dims
        return _exchange(grad, ctx.group, concat_dim, split_dim), None, None, None


def all_to_all(x: torch.Tensor, group, split_dim: int, concat_dim: int) -> torch.Tensor:
    """The tiled all-to-all over ``group``; its backward is the reverse
    exchange. ``x.shape[split_dim]`` must divide by the group's size."""
    if axis_size(group) == 1:
        return x
    return _AllToAll.apply(x, group, split_dim, concat_dim)


def _shift(tensors: Sequence[torch.Tensor], group, shift: int) -> List[torch.Tensor]:
    """Each tensor sent to the rank ``shift`` places on along the group's
    ring and received from the one ``shift`` places back."""
    n, me = dist.get_world_size(group), axis_index(group)
    dst = dist.get_global_rank(group, (me + shift) % n)
    src = dist.get_global_rank(group, (me - shift) % n)
    staged = [t.detach().contiguous().cpu() if _staged(t) else t.detach().contiguous()
              for t in tensors]
    recv = [torch.empty_like(t) for t in staged]
    ops = [dist.P2POp(dist.isend, t, dst, group) for t in staged] + \
        [dist.P2POp(dist.irecv, t, src, group) for t in recv]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return [r.to(t.device) for r, t in zip(recv, tensors)]


class _Ppermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, group, shift: int) -> torch.Tensor:
        ctx.group, ctx.shift = group, shift
        return _shift([x], group, shift)[0]

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return _shift([grad], ctx.group, -ctx.shift)[0], None, None


def ppermute(x: torch.Tensor, group, shift: int = 1) -> torch.Tensor:
    """``lax.ppermute`` over the group's ring: rank i's ``x`` goes to rank
    i + ``shift``; the backward sends the cotangent the other way."""
    if axis_size(group) == 1:
        return x
    return _Ppermute.apply(x, group, shift)


def ppermute_many(tensors: Sequence[torch.Tensor], group, shift: int = 1) -> List[torch.Tensor]:
    """``ppermute`` of several tensors in one batch of sends, without
    gradients (the ring attention's blocks, whose backward is its own)."""
    if axis_size(group) == 1:
        return list(tensors)
    return _shift(tensors, group, shift)


def all_reduce_mean(tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The mean over every rank of each tensor, through one flat fp32
    buffer (the gradients: see the module docstring's rule)."""
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
