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

Frozen parameters (the optimizer's ``frozen`` names, from ``frozen_params``,
and those the model froze itself, such as ``lora_freeze_base``'s base
projections) are frozen at the weight with ``requires_grad_(False)``: no
gradient is made for them, the optimizer holds no moment or accumulator for
them (``trainable`` lists the others), and their fp32 masters never change;
they are cast into the module when the state is made or restored, and kept
for the checkpoint.

MoCo (``init_momentum``): the state also holds the fp32 EMA copy of the
momentum subtree's masters (``momentum``, by parameter name) and a key
module, a copy of that subtree in the compute dtype, refreshed from the EMA
by explicit casts as ``sync_model`` refreshes the model. The step then runs
the key forward first and the EMA update after AdamW, against the updated
masters, as the JAX trainer reads ``new_state.params``.
"""

from __future__ import annotations

import copy
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import torch
from torch import nn

from antmmf_torch.modules import moco


class TrainState:
    def __init__(self, model: nn.Module, params: Dict[str, torch.Tensor], opt_state: Any,
                 generator: torch.Generator, step: int = 0):
        self.model = model
        self.params = params
        # the names the optimizer updates, in the module's order
        self.trainable = [n for n, p in model.named_parameters() if p.requires_grad]
        self.opt_state = opt_state
        self.generator = generator
        self.step = step
        self.grad_norm: Optional[torch.Tensor] = None  # of the last update, before the clip
        self.momentum: Optional[Dict[str, torch.Tensor]] = None  # fp32 EMA masters by name
        self.key_module: Optional[nn.Module] = None
        self.momentum_prefix = ""

    @classmethod
    def create(cls, model: nn.Module, tx, params: Optional[Mapping[str, torch.Tensor]] = None,
               seed: int = 0) -> "TrainState":
        """Masters from ``params`` (fp32 by name, e.g. ``flax_to_masters``) or
        from the module's own values, on the module's device; the
        optimizer's ``frozen`` names are frozen at the weight, its state made
        for the rest; the module is then set from the masters."""
        device = next(model.parameters()).device
        for n, p in model.named_parameters():
            if n in tx.frozen:
                p.requires_grad_(False)
        if params is None:
            params = {n: p.detach() for n, p in model.named_parameters()}
        masters = {n: t.to(device=device, dtype=torch.float32, copy=True)
                   for n, t in params.items()}
        state = cls(model, masters, None, torch.Generator(device=device).manual_seed(seed))
        state.opt_state = tx.init(state.trainable_params())
        state.sync_model(frozen=True)
        return state

    def optimizer_state_bytes(self) -> int:
        """Device bytes of the optimizer's tensors (moments, accumulator)."""
        return sum(t.numel() * t.element_size() for tree in self.opt_state.values()
                   if isinstance(tree, dict) for t in tree.values())

    def trainable_params(self) -> Dict[str, torch.Tensor]:
        return {n: self.params[n] for n in self.trainable}

    @torch.no_grad()
    def sync_model(self, frozen: bool = False) -> None:
        """Cast the trainable masters (all of them with ``frozen``) into the
        module's parameters (explicit casts)."""
        named = dict(self.model.named_parameters())
        names = list(self.params) if frozen else self.trainable
        torch._foreach_copy_([named[n] for n in names], [self.params[n] for n in names])

    def init_momentum(self, module: str = "base") -> None:
        """The EMA copy of the masters under the submodule ``module`` and the
        key module: a deep copy of that submodule, set from the EMA."""
        self.momentum_prefix = f"{module}."
        self.momentum = {n: t.clone() for n, t in self.params.items()
                         if n.startswith(self.momentum_prefix)}
        self.key_module = copy.deepcopy(getattr(self.model, module)).requires_grad_(False)
        self.sync_key_module()

    @torch.no_grad()
    def sync_key_module(self) -> None:
        """Cast the EMA masters into the key module's parameters."""
        named = dict(self.key_module.named_parameters())
        cut = len(self.momentum_prefix)
        torch._foreach_copy_([named[n[cut:]] for n in self.momentum],
                             list(self.momentum.values()))

    def update_momentum(self, mu: float) -> None:
        """m ← μ·m + (1 − μ)·p against the current masters, then the key module."""
        moco.momentum_update(list(self.momentum.values()),
                             [self.params[n] for n in self.momentum], mu)
        self.sync_key_module()

    def apply_gradients(self, grads: Mapping[str, torch.Tensor], tx) -> "TrainState":
        """One trainer iteration of ``tx`` on the trainable masters' fp32
        ``grads`` (an update, or with accumulation maybe only a micro-step)."""
        self.grad_norm = tx.update(grads, self.opt_state, self.trainable_params())
        self.step += 1
        self.sync_model()
        return self


def make_train_step(shell, tx, momentum: float = 0.0
                    ) -> Callable[[TrainState, Mapping[str, torch.Tensor]],
                                  Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """``train_step(state, batch) -> (state, scalars)`` as the JAX trainer's
    jitted step: the shell's loss with ``deterministic=False`` (the state's
    generator drives the model's training draws), backward,
    global-norm clip and AdamW update (``tx``, under accumulation one
    micro-step of it). ``scalars`` holds ``losses/*``, ``metrics/*``,
    ``total_loss`` and ``grad_norm`` (of this step's unclipped gradients of
    the trainable parameters) as device tensors: the step makes no host
    sync. The module holds no gradients after the step.

    With ``momentum`` > 0 and a state holding momentum towers, the MoCo
    keys come first, from the key module without gradients
    (``module.moco_keys``), into the batch as ``_moco_key_text`` and
    ``_moco_key_video``; after AdamW the EMA moves towards the updated
    masters. A model with queues enqueues its keys after the backward
    (``module.flush_queues``)."""
    module = shell.module
    flush = getattr(module, "flush_queues", None)

    def train_step(state: TrainState, batch: Mapping[str, torch.Tensor]):
        if momentum > 0.0 and state.key_module is not None:
            batch = shell.to_device(batch)
            with torch.no_grad():
                key_text, key_video = module.moco_keys(state.key_module, batch)
            batch = {**batch, "_moco_key_text": key_text, "_moco_key_video": key_video}
        loss, (_, scalars) = shell.loss_fn(batch, deterministic=False,
                                           generator=state.generator)
        loss.backward()
        named = dict(module.named_parameters())
        grads = {}
        for n in state.trainable:
            p = named[n]
            grads[n] = p.grad.float() if p.grad is not None else torch.zeros_like(state.params[n])
            p.grad = None
        state = state.apply_gradients(grads, tx)
        if momentum > 0.0 and state.momentum is not None:
            state.update_momentum(momentum)
        if flush is not None:
            flush()
        scalars["grad_norm"] = state.grad_norm
        return state, scalars

    return train_step
