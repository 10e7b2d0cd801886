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

Over ranks (``parallel.collectives``) the step averages the fp32 gradients
over every rank (``data`` × ``fsdp`` × ``seq``) in one flat fp32
all-reduce: JAX's global gradient is never rounded to bf16 across
replicas. Each rank's loss is its share of a sum whose gradient is the
world size times the global one (a loss every rank computes alike over
the gathered batch; the LM loss's NLL summed over ranks before the
division, whose backward sums the cotangent again), and every in-step
collective's backward is its transpose, so the mean is the gradient one
process computes on the global batch: a ``seq`` rank's partial gradient
from its tokens and a replicated consumer's whole one both come out
right. Under ``fsdp`` > 1 (``Shards``) the state holds, for each
parameter a rule shards, only this rank's slice of the fp32 master, of
both AdamW moments, of ``MultiSteps``' accumulator and of a MoCo EMA, as
the JAX package's ``state_sharding`` lays them out; the clip reads the
norm of the whole gradient (the squares of the shards summed over the
``fsdp`` ranks, then the rest), and ``sync_model`` casts the updated
slices to the compute dtype and gathers them, in buckets, into the
module's weights, which every rank holds whole (the JAX package gathers
them at use instead; queue A7b). A checkpoint gathers the whole state in
buckets onto the host of the main rank, which alone writes it
(``host_copy``).

``remat`` (``remat_context``) runs the loss under ``torch.utils.checkpoint``
with a selective policy; the generator's state is set back before the
recompute, so the recompute draws the forward's masks.
"""

from __future__ import annotations

import copy
import functools
from typing import Any, Callable, Dict, Iterator, Mapping, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from antmmf_torch.modules import moco
from antmmf_torch.parallel import collectives as coll

# the matrix products of ``jax.checkpoint_policies.dots_saveable`` (all)
# and of ``dots_with_no_batch_dims_saveable`` (those without a batch dim)
_DOTS = ("mm", "addmm", "bmm", "baddbmm")
_DOTS_NO_BATCH = ("mm", "addmm")
REMAT_ALIASES = {"checkpoint_dots": "dots_saveable",
                 "checkpoint_dots_with_no_batch_dims": "dots_with_no_batch_dims_saveable"}
REMAT_POLICIES = ("dots_saveable", "dots_with_no_batch_dims_saveable", "nothing_saveable",
                  "everything_saveable")


def _policy(saved, ctx, op, *args, **kwargs):
    name = op.overloadpacket.__name__
    keep = saved is None or name in saved
    return CheckpointPolicy.MUST_SAVE if keep else CheckpointPolicy.PREFER_RECOMPUTE


def remat_context(name: Optional[str]) -> Optional[Callable]:
    """``training_parameters.remat_policy`` → ``checkpoint``'s ``context_fn``
    (a callable), or ``None`` for no remat (``none``, empty, null). Under
    the ``dots`` policies the matrix products are saved and the rest is
    recomputed; ``nothing_saveable`` recomputes everything,
    ``everything_saveable`` nothing. A hand-written kernel is launched
    outside the operators a policy sees and is recomputed. An unknown name
    raises, as the JAX trainer's ``_remat_policy`` does."""
    name = str(name or "none")
    if name in ("none", "", "null", "None"):
        return None
    name = REMAT_ALIASES.get(name, name)
    if name not in REMAT_POLICIES:
        raise ValueError(f"unknown training_parameters.remat_policy: {name!r}")
    saved = {"dots_saveable": _DOTS, "dots_with_no_batch_dims_saveable": _DOTS_NO_BATCH,
             "nothing_saveable": (), "everything_saveable": None}[name]
    return functools.partial(create_selective_checkpoint_contexts,
                             functools.partial(_policy, saved))


# the most bytes of its slices a rank sends in one gather of ``Shards``
BUCKET_BYTES = 64 << 20


class Shards:
    """How the ``fsdp`` ranks split the state: parameter name → the
    dimension split (``dims``; the names absent are replicated), the
    ranks' process group, its size and this rank's index in it."""

    def __init__(self, dims: Mapping[str, int], group, size: int, index: int):
        self.dims, self.group, self.size, self.index = dict(dims), group, int(size), int(index)

    def local(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """This rank's slice of the whole tensor ``t`` of parameter ``name``."""
        dim = self.dims.get(name)
        return t if dim is None else t.chunk(self.size, dim)[self.index]

    def whole_shape(self, name: str, t: torch.Tensor) -> torch.Size:
        """The shape of the whole tensor of which ``t`` is this rank's slice."""
        dim = self.dims.get(name)
        if dim is None:
            return t.shape
        return t.shape[:dim] + (t.shape[dim] * self.size,) + t.shape[dim + 1:]

    def _buckets(self, src: Mapping[str, torch.Tensor], dtype_of) -> Iterator[list]:
        """The sharded names of ``src`` in runs of one dtype (``dtype_of``)
        whose slices take at most ``BUCKET_BYTES`` (a longer slice alone)."""
        bucket, nbytes = [], 0
        for n in (n for n in src if n in self.dims):
            size = src[n].numel() * dtype_of(n).itemsize
            if bucket and (dtype_of(n) != dtype_of(bucket[0]) or nbytes + size > BUCKET_BYTES):
                yield bucket
                bucket, nbytes = [], 0
            bucket.append(n)
            nbytes += size
        if bucket:
            yield bucket

    def gather_into(self, dst: Mapping[str, torch.Tensor],
                    src: Mapping[str, torch.Tensor]) -> None:
        """Write into each ``dst[n]`` the whole tensor of which ``src[n]`` is
        this rank's slice. Each slice is cast to its destination's dtype
        before the gather, and the slices go in buckets
        (``BUCKET_BYTES``), so the temporaries stay a bucket's size (a
        rank's bf16 compute weights are gathered from its fp32 masters with
        no fp32 copy of the whole)."""
        whole = [n for n in src if n not in self.dims]
        if whole:
            torch._foreach_copy_([dst[n] for n in whole], [src[n] for n in whole])
        for bucket in self._buckets(src, lambda n: dst[n].dtype):
            flat = torch.cat([src[m].reshape(-1).to(dst[m].dtype) for m in bucket])
            start = 0
            parts = coll.gather_list(flat, self.group)
            for m in bucket:
                k, shape = src[m].numel(), src[m].shape
                for part, piece in zip(parts, dst[m].chunk(self.size, self.dims[m])):
                    piece.copy_(part[start:start + k].view(shape))
                start += k

    def gather(self, tensors: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The whole tensors from every rank's slices (new tensors of the
        slices' dtype; the replicated ones as they are)."""
        out = {n: t if n not in self.dims else t.new_empty(self.whole_shape(n, t))
               for n, t in tensors.items()}
        self.gather_into(out, {n: t for n, t in tensors.items() if n in self.dims})
        return out

    def gather_to_host(self, tensors: Mapping[str, torch.Tensor], dst: int
                       ) -> Optional[Dict[str, torch.Tensor]]:
        """The whole tensors on the host of rank ``dst`` (a rank of the
        world), gathered there in buckets (``BUCKET_BYTES``); ``None`` on the
        other ranks. The ranks of ``dst``'s ``fsdp`` group take part; the
        others return at once."""
        if dst not in coll.group_ranks(self.group):
            return None
        mine = coll.get_rank() == dst
        out: Dict[str, torch.Tensor] = {}
        for bucket in self._buckets(tensors, lambda n: tensors[n].dtype):
            parts = coll.gather_to(torch.cat([tensors[m].reshape(-1) for m in bucket]), dst,
                                   self.group)
            start = 0
            for m in bucket if mine else ():
                k, shape = tensors[m].numel(), tensors[m].shape
                out[m] = torch.cat([p[start:start + k].view(shape) for p in parts],
                                   dim=self.dims[m])
                start += k
        if not mine:
            return None
        return {n: out[n] if n in self.dims else t.detach().to("cpu", copy=True)
                for n, t in tensors.items()}

    def norm(self, names, tensors) -> torch.Tensor:
        """The norm of the whole tensors, of which ``tensors`` are the slices."""
        sq = torch.stack(torch._foreach_norm(list(tensors))).float() ** 2
        sharded = torch.tensor([n in self.dims for n in names], device=sq.device)
        part = torch.where(sharded, sq, torch.zeros_like(sq)).sum().reshape(1)
        coll.all_reduce_(part, group=self.group)
        return torch.sqrt(part[0] + torch.where(sharded, torch.zeros_like(sq), sq).sum())


class TrainState:
    def __init__(self, model: nn.Module, params: Dict[str, torch.Tensor], opt_state: Any,
                 generator: torch.Generator, step: int = 0, shards: Optional[Shards] = None):
        self.model = model
        self.shards = shards
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
               seed: int = 0, shards: Optional[Shards] = None) -> "TrainState":
        """Masters from ``params`` (fp32 by name, e.g. ``flax_to_masters``) or
        from the module's own values, on the module's device (with
        ``shards``, this rank's slices); the optimizer's ``frozen`` names
        are frozen at the weight, its state made for the rest; the module is
        then set from the masters."""
        device = next(model.parameters()).device
        for n, p in model.named_parameters():
            if n in tx.frozen:
                p.requires_grad_(False)
        if params is None:
            params = {n: p.detach() for n, p in model.named_parameters()}
        local = shards.local if shards is not None else (lambda n, t: t)
        masters = {n: local(n, t).to(device=device, dtype=torch.float32, copy=True)
                   for n, t in params.items()}
        state = cls(model, masters, None, torch.Generator(device=device).manual_seed(seed),
                    shards=shards)
        state.opt_state = tx.init(state.trainable_params())
        state.sync_model(frozen=True)
        return state

    def optimizer_state_bytes(self) -> int:
        """Device bytes of the optimizer's tensors (moments, accumulator)."""
        return sum(t.numel() * t.element_size() for tree in self.opt_state.values()
                   if isinstance(tree, dict) for t in tree.values())

    def master_bytes(self) -> int:
        """Device bytes of this rank's fp32 masters."""
        return sum(t.numel() * t.element_size() for t in self.params.values())

    def trainable_params(self) -> Dict[str, torch.Tensor]:
        return {n: self.params[n] for n in self.trainable}

    def local(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """This rank's part of the whole tensor ``t`` of parameter ``name``."""
        return t if self.shards is None else self.shards.local(name, t)

    def gathered(self, tensors: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Whole tensors from this state's slices (by parameter name): a
        collective of the ``fsdp`` ranks; the tensors themselves without
        shards."""
        return dict(tensors) if self.shards is None else self.shards.gather(tensors)

    def global_norm(self, names, tensors) -> torch.Tensor:
        """The clip's norm of the whole gradient whose slices are ``tensors``."""
        if self.shards is None:
            return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(list(tensors))))
        return self.shards.norm(names, tensors)

    def host_copy(self, tensors: Mapping[str, torch.Tensor]
                  ) -> Optional[Dict[str, torch.Tensor]]:
        """The whole tensors (by parameter name) on the host of the main rank,
        which writes checkpoints; ``None`` on every other rank."""
        if self.shards is not None:
            return self.shards.gather_to_host(tensors, 0)
        if not coll.is_main_process():
            return None
        return {n: t.detach().to("cpu", copy=True) for n, t in tensors.items()}

    @torch.no_grad()
    def sync_model(self, frozen: bool = False) -> None:
        """Cast the trainable masters (all of them with ``frozen``) into the
        module's parameters (explicit casts); under ``fsdp`` each rank's
        slices are cast, then gathered into the parameters."""
        named = dict(self.model.named_parameters())
        names = list(self.params) if frozen else self.trainable
        if self.shards is not None:
            self.shards.gather_into(named, {n: self.params[n] for n in names})
        else:
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
        dst = {n: named[n[cut:]] for n in self.momentum}
        if self.shards is not None:
            self.shards.gather_into(dst, self.momentum)
        else:
            torch._foreach_copy_(list(dst.values()), list(self.momentum.values()))

    def update_momentum(self, mu: float) -> None:
        """m ← μ·m + (1 − μ)·p against the current masters, then the key module."""
        moco.momentum_update(list(self.momentum.values()),
                             [self.params[n] for n in self.momentum], mu)
        self.sync_key_module()

    def apply_gradients(self, grads: Mapping[str, torch.Tensor], tx) -> "TrainState":
        """One trainer iteration of ``tx`` on the trainable masters' fp32
        ``grads`` (an update, or with accumulation maybe only a micro-step)."""
        self.grad_norm = tx.update(grads, self.opt_state, self.trainable_params(),
                                   norm_fn=self.global_norm)
        self.step += 1
        self.sync_model()
        return self


def make_train_step(shell, tx, momentum: float = 0.0, remat: Optional[str] = None
                    ) -> Callable[[TrainState, Mapping[str, torch.Tensor]],
                                  Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """``train_step(state, batch) -> (state, scalars)`` as the JAX trainer's
    jitted step: the shell's loss with ``deterministic=False`` (the state's
    generator drives the model's training draws), backward, over ranks the
    fp32 gradient mean, global-norm clip and AdamW update (``tx``, under
    accumulation one micro-step of it). ``scalars`` holds ``losses/*``,
    ``metrics/*``, ``total_loss`` and ``grad_norm`` (of this step's
    unclipped gradients of the trainable parameters) as device tensors, this
    rank's (the trainer averages them over ranks when it reads them): the
    step makes no host sync on one device. The module holds no gradients
    after the step. ``remat`` names a ``remat_policy``.

    With ``momentum`` > 0 and a state holding momentum towers, the MoCo
    keys come first, from the key module without gradients
    (``module.moco_keys``), into the batch as ``_moco_key_text`` and
    ``_moco_key_video``; after AdamW the EMA moves towards the updated
    masters. A model with queues enqueues its keys after the backward
    (``module.flush_queues``)."""
    module = shell.module
    flush = getattr(module, "flush_queues", None)
    context_fn = remat_context(remat)

    def forward_backward(state: TrainState, batch):
        if context_fn is None:
            loss, (_, scalars) = shell.loss_fn(batch, deterministic=False,
                                               generator=state.generator)
            loss.backward()
            return scalars
        start = state.generator.get_state()

        def loss_of(b):
            # the recompute draws the forward's masks from the explicit
            # generator, which preserve_rng_state does not restore
            state.generator.set_state(start)
            return shell.loss_fn(b, deterministic=False, generator=state.generator)

        loss, (_, scalars) = checkpoint(loss_of, batch, use_reentrant=False,
                                        context_fn=context_fn)
        after = state.generator.get_state()
        loss.backward()
        state.generator.set_state(after)
        return scalars

    def train_step(state: TrainState, batch: Mapping[str, torch.Tensor]):
        if momentum > 0.0 and state.key_module is not None:
            batch = shell.to_device(batch)
            with torch.no_grad():
                key_text, key_video = module.moco_keys(state.key_module, batch)
            batch = {**batch, "_moco_key_text": key_text, "_moco_key_video": key_video}
        scalars = forward_backward(state, batch)
        named = dict(module.named_parameters())
        grads = {}
        for n in state.trainable:
            p = named[n]
            grads[n] = p.grad.float() if p.grad is not None else torch.zeros_like(
                named[n], dtype=torch.float32)
            p.grad = None
        if coll.is_distributed():
            grads = dict(zip(grads, coll.all_reduce_mean(list(grads.values()))))
        if state.shards is not None:
            grads = {n: state.shards.local(n, g) for n, g in grads.items()}
        state = state.apply_gradients(grads, tx)
        if momentum > 0.0 and state.momentum is not None:
            state.update_momentum(momentum)
        if flush is not None:
            flush()
        scalars["grad_norm"] = state.grad_norm
        return state, scalars

    return train_step
