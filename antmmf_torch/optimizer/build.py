"""AdamW and its learning-rate schedule, with optax's arithmetic.

Port of ``antmmf_tpu/optimizer/build.py`` for ``type: adam_w``: the chain
``clip_by_global_norm`` → ``optax.adamw`` (``scale_by_adam`` →
``add_decayed_weights`` under the ``NO_DECAY_PATTERNS`` mask →
``scale_by_learning_rate``) → ``lr_multipliers``, and ``build_lr_schedule``.
It follows optax's order and rounding, not ``torch.optim.AdamW``'s:

* clipping: ``g`` where ‖g‖ < max_norm, else ``g / ‖g‖ · max_norm``;
* moments: ``mu = (1-b1)·g + b1·mu`` and ``nu = (1-b2)·g² + b2·nu``; with
  ``mu_dtype: bfloat16`` the stored ``mu`` is bf16, ``b1·mu`` is computed in
  bf16 (JAX's weak typing rounds b1 to bf16 too), the sum and the step use
  the fp32 ``mu`` and only the stored moment is rounded; ``nu`` stays fp32;
* the update is ``mu_hat / (sqrt(nu_hat) + eps)`` with ``1 - b**count``
  bias corrections in fp32, plus ``weight_decay · p`` where the mask allows
  (decoupled decay, before the learning rate), times ``-lr(count)`` with the
  schedule reading the step count before it is incremented, times the
  parameter's lr multiplier; then ``p + update``.

Parameters and gradients are dictionaries of fp32 tensors by the model's
parameter names; the weight-decay mask and lr multipliers match regular
expressions against each parameter's flax path, as the JAX package does.
The update runs as a few multi-tensor ``torch._foreach_*`` ops: the JAX
package has no kernel for it. Other optimizer types, gradient accumulation
and frozen parameters raise until they are ported.
"""

from __future__ import annotations

import math
import re
from typing import Any, Callable, Dict, Mapping, Optional, Sequence

import numpy as np
import torch

NO_DECAY_PATTERNS = (r".*bias$", r".*scale$", r".*norm.*", r".*layer_norm.*",
                     r".*embedding$", r".*logit_scale$")


def make_weight_decay_mask(paths: Mapping[str, str]) -> Dict[str, bool]:
    """True where weight decay applies (kernels), False on bias/norm/embeddings;
    ``paths`` maps parameter names to flax paths."""
    return {name: not any(re.fullmatch(pat, path.lower()) for pat in NO_DECAY_PATTERNS)
            for name, path in paths.items()}


def make_lr_multiplier_mask(paths: Mapping[str, str], rules: Sequence) -> Dict[str, float]:
    """Per-parameter lr multipliers from [[regex, mult], ...] searched in the
    flax path; first match wins, default 1.0."""
    compiled = [(re.compile(pat), float(mult)) for pat, mult in rules]
    return {name: next((m for pat, m in compiled if pat.search(path)), 1.0)
            for name, path in paths.items()}


def build_lr_schedule(tp: Mapping[str, Any], base_lr: float) -> Callable[[int], np.float32]:
    """count → lr, in fp32 as the JAX schedule computes it: warmup from
    ``warmup_factor``·lr to lr over ``warmup_iterations`` (when
    ``use_warmup``), then ``step`` (×``lr_ratio`` at each of ``lr_steps``),
    ``cosine`` or ``linear`` decay."""
    tp = dict(tp or {})
    f32 = np.float32
    warmup_iters = int(tp.get("warmup_iterations", 0)) if tp.get("use_warmup", False) else 0
    warmup_factor = f32(tp.get("warmup_factor", 0.2))
    steps = [int(s) for s in (tp.get("lr_steps", []) or [])]
    ratio = f32(tp.get("lr_ratio", 0.1))
    decay = str(tp.get("lr_decay", "step"))
    raw_horizon = tp.get("lr_decay_iterations", tp.get("max_iterations", 0)) or 0
    horizon = 0 if raw_horizon == float("inf") else int(raw_horizon)
    min_ratio = f32(tp.get("min_lr_ratio", 0.0))
    if decay not in ("step", "cosine", "linear"):
        raise ValueError(f"Unknown lr_decay {decay!r}")
    if decay != "step" and horizon <= 0:
        raise ValueError(f"lr_decay={decay!r} needs lr_decay_iterations or max_iterations")

    def schedule(count: int) -> np.float32:
        count = f32(count)
        lr = f32(base_lr)
        if warmup_iters > 0:
            alpha = f32(np.clip(count / f32(warmup_iters), f32(0), f32(1)))
            lr = lr * (warmup_factor * (f32(1) - alpha) + alpha)
        if decay == "step":
            for s in steps:
                lr = lr * ratio if count >= s else lr
            return f32(lr)
        t = f32(np.clip((count - f32(warmup_iters)) / f32(max(horizon - warmup_iters, 1)),
                        f32(0), f32(1)))
        if decay == "cosine":
            frac = min_ratio + (f32(1) - min_ratio) * f32(0.5) * (f32(1) + np.cos(f32(math.pi) * t))
        else:
            frac = min_ratio + (f32(1) - min_ratio) * (f32(1) - t)
        return f32(lr * frac)

    return schedule


class AdamW:
    """optax's ``chain(clip_by_global_norm, adamw, scale_by_multipliers)``
    over dictionaries of fp32 tensors; ``update`` changes the parameters and
    the state in place."""

    def __init__(self, schedule: Callable[[int], float], b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 0.0,
                 mu_dtype: Optional[torch.dtype] = None,
                 decay_mask: Optional[Mapping[str, bool]] = None,
                 max_grad_norm: Optional[float] = None,
                 lr_multipliers: Optional[Mapping[str, float]] = None):
        self.schedule, self.b1, self.b2, self.eps = schedule, b1, b2, eps
        self.weight_decay, self.mu_dtype = weight_decay, mu_dtype
        self.decay_mask, self.max_grad_norm = decay_mask, max_grad_norm
        self.lr_multipliers = lr_multipliers

    def init(self, params: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
        return {"count": 0,
                "mu": {n: torch.zeros_like(p, dtype=self.mu_dtype or p.dtype)
                       for n, p in params.items()},
                "nu": {n: torch.zeros_like(p) for n, p in params.items()}}

    @torch.no_grad()
    def update(self, grads: Mapping[str, torch.Tensor], state: Dict[str, Any],
               params: Dict[str, torch.Tensor]) -> None:
        names = list(params)
        p = [params[n] for n in names]
        g = [grads[n] for n in names]
        if self.max_grad_norm is not None:
            norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(g)))
            keep = norm < self.max_grad_norm
            one = torch.ones((), device=norm.device)
            g = torch._foreach_div(g, torch.where(keep, one, norm))
            torch._foreach_mul_(g, torch.where(keep, one, one * self.max_grad_norm))
        mu, nu = [state["mu"][n] for n in names], [state["nu"][n] for n in names]
        b1 = torch.tensor(self.b1, dtype=mu[0].dtype, device=mu[0].device)
        mu32 = torch._foreach_add(torch._foreach_mul(g, 1 - self.b1), torch._foreach_mul(mu, b1))
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_add_(nu, torch._foreach_mul(torch._foreach_mul(g, g), 1 - self.b2))
        count = state["count"] + 1
        f32 = dict(dtype=torch.float32, device=p[0].device)
        bc1 = 1 - torch.tensor(self.b1, **f32) ** torch.tensor(float(count), **f32)
        bc2 = 1 - torch.tensor(self.b2, **f32) ** torch.tensor(float(count), **f32)
        den = torch._foreach_sqrt(torch._foreach_div(nu, bc2))
        torch._foreach_add_(den, self.eps)
        upd = torch._foreach_div(torch._foreach_div(mu32, bc1), den)
        torch._foreach_copy_(mu, mu32)  # only the stored moment is rounded
        if self.weight_decay:
            idx = [i for i, n in enumerate(names)
                   if self.decay_mask is None or self.decay_mask[n]]
            torch._foreach_add_([upd[i] for i in idx],
                                torch._foreach_mul([p[i] for i in idx], self.weight_decay))
        torch._foreach_mul_(upd, torch.tensor(-self.schedule(state["count"]), **f32))
        if self.lr_multipliers is not None:
            torch._foreach_mul_(upd, [self.lr_multipliers[n] for n in names])
        torch._foreach_add_(p, upd)
        state["count"] = count


def build_optimizer(paths: Mapping[str, str], optimizer_attributes: Mapping[str, Any],
                    training_parameters: Optional[Mapping[str, Any]] = None):
    """(AdamW, schedule) from the JAX package's config surface::

        optimizer_attributes:
          type: adam_w
          params: {lr: 5.0e-5, weight_decay: 0.01, eps: 1.0e-8, mu_dtype: bfloat16}
          lr_multipliers: [["img_encoder", 0.1]]
        training_parameters: {clip_gradients: true, max_grad_l2_norm: 1.0, ...}

    ``paths`` maps parameter names to flax paths (``utils.weights.flax_paths``)."""
    cfg = dict(optimizer_attributes or {})
    tp = dict(training_parameters or {})
    name = cfg.get("type", "adam_w")
    if name not in ("adam_w", "adamw"):
        raise NotImplementedError(f"optimizer {name!r} is not ported yet; adam_w is")
    if int(tp.get("gradient_accumulation_steps", 1)) > 1 or cfg.get("frozen_params"):
        raise NotImplementedError("gradient accumulation and frozen_params are not ported yet")
    p = dict(cfg.get("params", {}))
    lr = float(p.pop("lr", p.pop("learning_rate", 1e-4)))
    schedule = build_lr_schedule(tp, lr)
    betas = p.pop("betas", None)
    b1, b2 = ((float(betas[0]), float(betas[1])) if betas is not None
              else (float(p.pop("b1", 0.9)), float(p.pop("b2", 0.999))))
    mu_dtype = p.pop("mu_dtype", None)
    mults = cfg.get("lr_multipliers", [])
    tx = AdamW(schedule, b1, b2, float(p.pop("eps", 1e-8)), float(p.pop("weight_decay", 0.0)),
               getattr(torch, mu_dtype) if mu_dtype else None, make_weight_decay_mask(paths),
               float(tp.get("max_grad_l2_norm", 1.0)) if tp.get("clip_gradients") else None,
               make_lr_multiplier_mask(paths, mults) if mults else None)
    return tx, schedule
