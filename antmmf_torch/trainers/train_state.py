"""Training state and the train step.

Port of ``antmmf_tpu/trainers/train_state.py`` and of the step that
``bench.py:98-110`` jits. ``TrainState`` holds the step count, the fp32
master parameters (by parameter name), the optimizer state and an explicit
``torch.Generator``. The JAX package keeps fp32 params and casts them to
the compute dtype at every use; the port keeps the cast explicit and does
it once per update: the model module holds compute-dtype copies (bf16 for
Dense/Embed weights, fp32 for LayerNorm and the fp32 heads), refreshed from
the masters after each ``apply_gradients``, and its bf16 gradients are cast
to fp32 for the optimizer, which is what the JAX cast's gradient does.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import torch
from torch import nn


class TrainState:
    def __init__(self, model: nn.Module, params: Dict[str, torch.Tensor], opt_state: Any,
                 generator: torch.Generator, step: int = 0):
        self.model = model
        self.params = params
        self.opt_state = opt_state
        self.generator = generator
        self.step = step

    @classmethod
    def create(cls, model: nn.Module, tx, params: Optional[Mapping[str, torch.Tensor]] = None,
               seed: int = 0) -> "TrainState":
        """Masters from ``params`` (fp32 by name, e.g. ``flax_to_masters``) or
        from the module's own values, on the module's device; the module is
        then set from them."""
        device = next(model.parameters()).device
        if params is None:
            params = {n: p.detach() for n, p in model.named_parameters()}
        masters = {n: t.to(device=device, dtype=torch.float32, copy=True)
                   for n, t in params.items()}
        state = cls(model, masters, tx.init(masters),
                    torch.Generator(device=device).manual_seed(seed))
        state.sync_model()
        return state

    @torch.no_grad()
    def sync_model(self) -> None:
        """Cast the masters into the module's parameters (explicit casts)."""
        named = dict(self.model.named_parameters())
        torch._foreach_copy_([named[n] for n in self.params], list(self.params.values()))

    def apply_gradients(self, grads: Mapping[str, torch.Tensor], tx) -> "TrainState":
        tx.update(grads, self.opt_state, self.params)
        self.step += 1
        self.sync_model()
        return self


def make_train_step(shell, tx) -> Callable[[TrainState, Mapping[str, torch.Tensor]],
                                           Tuple[TrainState, torch.Tensor]]:
    """``train_step(state, batch) -> (state, loss)`` as ``bench.py`` builds
    it: the shell's loss with ``deterministic=False``, backward, global-norm
    clip and AdamW update (``tx``), the loss returned without a host sync."""
    module = shell.module

    def train_step(state: TrainState, batch: Mapping[str, torch.Tensor]):
        for p in module.parameters():
            p.grad = None
        loss, _ = shell.loss_fn(batch, deterministic=False)
        loss.backward()
        grads = {n: (p.grad.float() if p.grad is not None else torch.zeros_like(state.params[n]))
                 for n, p in module.named_parameters()}
        return state.apply_gradients(grads, tx), loss.detach()

    return train_step

