"""MoCo utilities: the negative queue and the momentum (EMA) update.

Port of ``antmmf_tpu/modules/moco.py``. A queue is a dict of tensors:
``queue`` [K, D], ``ptr`` (the next slot) and ``filled`` (slots that hold a
key), both int64 0-d. The JAX package threads it as functional state; the
port keeps it in a module's buffers (``MocoQueue``) and writes it in place,
after the backward that read it (``enqueue``). ``momentum_update`` is the EMA
``m = μ·m + (1 − μ)·p`` over lists of tensors in two ``_foreach`` passes.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn


def init_queue(queue_size: int, dim: int, dtype=torch.float32, random_init: bool = False,
               generator: Optional[torch.Generator] = None, device=None
               ) -> Dict[str, torch.Tensor]:
    """Zeros with ``filled`` 0; or, with ``random_init``, L2-normalised
    Gaussian rows drawn from ``generator`` (on the CPU, then moved) with
    ``filled`` = K, so negatives exist from the first step."""
    if random_init:
        q = torch.randn(queue_size, dim, generator=generator, dtype=torch.float32)
        q = (q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)).to(dtype)
        filled = queue_size
    else:
        q, filled = torch.zeros(queue_size, dim, dtype=dtype), 0
    return {"queue": q.to(device), "ptr": torch.zeros((), dtype=torch.long, device=device),
            "filled": torch.full((), filled, dtype=torch.long, device=device)}


@torch.no_grad()
def enqueue(state: Dict[str, torch.Tensor], keys: torch.Tensor) -> None:
    """Write a batch of keys into the ring at ``ptr``, wrapping modulo K, in
    place; ``filled`` is capped at K."""
    queue = state["queue"]
    K, B = queue.shape[0], keys.shape[0]
    idx = (state["ptr"] + torch.arange(B, device=queue.device)) % K
    queue.index_copy_(0, idx, keys.detach().to(queue.dtype))
    state["ptr"].copy_((state["ptr"] + B) % K)
    state["filled"].copy_(torch.clamp(state["filled"] + B, max=K))


class MocoQueue(nn.Module):
    """One queue in buffers (``queue``, ``ptr``, ``filled``: the leaves of a
    queue in the flax ``moco`` collection), its random rows drawn from a
    generator seeded with ``seed``."""

    def __init__(self, queue_size: int, dim: int, random_init: bool, seed: int, device=None):
        super().__init__()
        state = init_queue(queue_size, dim, random_init=random_init,
                           generator=torch.Generator().manual_seed(seed), device=device)
        for name, t in state.items():
            self.register_buffer(name, t)

    def state(self) -> Dict[str, torch.Tensor]:
        return {"queue": self.queue, "ptr": self.ptr, "filled": self.filled}


def queue_buffers(model: nn.Module) -> Dict[str, torch.Tensor]:
    """Every ``MocoQueue`` buffer of ``model`` by flax-style path
    (``text_queue/queue``), the ``moco`` collection's layout."""
    return {"/".join(filter(None, [name.replace(".", "/"), leaf])): t
            for name, mod in model.named_modules() if isinstance(mod, MocoQueue)
            for leaf, t in mod.state().items()}


def queue_negatives(state: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """(negatives [K, D], valid [K]): slots not yet filled are invalid."""
    queue = state["queue"]
    return queue, torch.arange(queue.shape[0], device=queue.device) < state["filled"]


@torch.no_grad()
def momentum_update(momentum: List[torch.Tensor], params: List[torch.Tensor],
                    mu: float = 0.999) -> None:
    """m ← μ·m + (1 − μ)·p in place, ``params`` cast to each m's dtype."""
    torch._foreach_mul_(momentum, mu)
    torch._foreach_add_(momentum, [p.to(m.dtype) for m, p in zip(momentum, params)],
                        alpha=1.0 - mu)
