"""Core layers with the JAX package's dtype policy.

Port of ``antmmf_tpu/modules/layers.py``: ``LayerNorm`` computes in fp32 and
casts back to the compute dtype, ``Mlp`` is fc1 → activation → fc2, and
``make_attention_mask`` turns a 1/0 validity mask into an additive fp32 key
bias. ``Dropout`` (inverted dropout) and ``DropPath`` (stochastic depth:
one keep draw a sample) draw from an explicit ``torch.Generator`` (the
trainer's ``TrainState`` generator), only when the call is not
deterministic. A model's training forward opens ``draws(generator)``; a
``Dropout`` or ``DropPath`` called inside it without its own
``deterministic`` draws from that generator, and outside any such scope it
is the identity, as the JAX modules are with ``deterministic=True``. Linear weights are held in the compute dtype, which is exactly the
JAX package's per-call cast of its fp32 kernels; norms keep fp32 parameters.
``checkpointed`` runs a layer under activation recomputation, the port of
the JAX package's ``nn.remat``.
"""

from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Iterator, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint


class LayerNorm(nn.Module):
    """LayerNorm computed in fp32 with fp32 parameters, output cast to
    ``dtype``. ``weight``/``bias`` are flax's ``LayerNorm_0/scale`` and
    ``LayerNorm_0/bias``."""

    def __init__(self, dim: int, epsilon: float = 1e-5, dtype=torch.bfloat16,
                 device=None):
        super().__init__()
        self.epsilon = epsilon
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.weight.shape, self.weight, self.bias,
                            self.epsilon).to(self.dtype)


class ScaleLayerNorm(nn.Module):
    """``LayerNorm`` under flax ``nn.LayerNorm``'s own leaf names ``scale``
    and ``bias``, for the towers whose flax modules name their LayerNorms
    directly (``norm1/scale``; Qwen2-ViT, SANM)."""

    def __init__(self, dim: int, epsilon: float = 1e-6, dtype=torch.bfloat16, device=None):
        super().__init__()
        self.epsilon = epsilon
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.scale.shape, self.scale, self.bias,
                            self.epsilon).to(self.dtype)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


ACTIVATIONS = {
    "gelu": lambda x: F.gelu(x, approximate="tanh"),  # flax nn.gelu's default
    "gelu_exact": F.gelu,
    "quick_gelu": quick_gelu,
}


# the innermost ``draws`` scope of this thread or task: (active, generator),
# a context variable as torch keeps its grad mode
_DRAWS: contextvars.ContextVar[Tuple[bool, Optional[torch.Generator]]] = \
    contextvars.ContextVar("draws", default=(False, None))


@contextlib.contextmanager
def draws(generator: Optional[torch.Generator], active: bool = True) -> Iterator[None]:
    """The scope of a forward: with ``active`` (a training forward, the JAX
    package's ``deterministic=False``) the ``Dropout`` and ``DropPath``
    calls inside draw from ``generator``; without, they are the identity (a
    pass the JAX package runs with ``deterministic=True`` inside a training
    forward, such as the word-importance pass)."""
    token = _DRAWS.set((active, generator))
    try:
        yield
    finally:
        _DRAWS.reset(token)


def _draw_args(deterministic: Optional[bool], generator: Optional[torch.Generator]):
    """(deterministic, generator) of a call: its own, else the innermost
    ``draws`` scope's; outside any scope, deterministic."""
    if deterministic is not None:
        return deterministic, generator
    active, scoped = _DRAWS.get()
    return not active, generator if generator is not None else scoped


class _Drop(nn.Module):
    """A training draw at ``rate`` in [0, 1): at rate 0 a call returns its
    input before the module call's hooks, so the path costs one check."""

    def __init__(self, rate: float, what: str):
        super().__init__()
        if not 0.0 <= rate < 1.0:
            raise ValueError(f"{what} rate {rate} is not in [0, 1)")
        self.rate = rate

    def __call__(self, x: torch.Tensor, *args, **kwargs) -> torch.Tensor:
        return x if self.rate == 0.0 else super().__call__(x, *args, **kwargs)


class Dropout(_Drop):
    """Inverted dropout at ``rate``: each entry is kept with probability
    1 − rate and scaled by 1 / (1 − rate). ``forward(x, deterministic,
    generator)`` is the identity when deterministic (evaluation) or at rate
    0, and otherwise draws one uniform an entry from the generator (both
    from the ``draws`` scope where the call does not pass them). flax draws
    its mask from the ``dropout`` rng stream, which torch cannot reproduce:
    the masks agree with JAX's by their statistics only."""

    def __init__(self, rate: float):
        super().__init__(rate, "dropout")

    def forward(self, x: torch.Tensor, deterministic: Optional[bool] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        deterministic, generator = _draw_args(deterministic, generator)
        if deterministic or self.rate == 0.0:
            return x
        keep = torch.rand(x.shape, generator=generator, device=x.device) < 1.0 - self.rate
        return torch.where(keep, x / (1.0 - self.rate), torch.zeros_like(x))


class DropPath(_Drop):
    """Stochastic depth at ``rate`` (``antmmf_tpu/modules/layers.py``
    ``DropPath``): the whole residual branch of a sample is kept with
    probability 1 − rate and scaled by 1 / (1 − rate), one uniform a sample
    (a keep mask of shape (B, 1, …)). Deterministic and drawn as
    ``Dropout``."""

    def __init__(self, rate: float = 0.0):
        super().__init__(rate, "drop_path")

    def forward(self, x: torch.Tensor, deterministic: Optional[bool] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        deterministic, generator = _draw_args(deterministic, generator)
        if deterministic or self.rate == 0.0:
            return x
        keep_prob = 1.0 - self.rate
        shape = (x.shape[0],) + (1,) * (x.dim() - 1)
        keep = torch.rand(shape, generator=generator, device=x.device) < keep_prob
        return torch.where(keep, x / keep_prob, torch.zeros_like(x))


class Mlp(nn.Module):
    """Transformer FFN: fc1 → activation → dropout → fc2 → dropout."""

    def __init__(self, dim: int, hidden_dim: int, activation: str = "gelu",
                 dtype=torch.bfloat16, device=None, dropout: float = 0.0):
        super().__init__()
        if activation not in ACTIVATIONS:
            raise ValueError(f"Unknown activation {activation!r}; known: "
                             f"{sorted(ACTIVATIONS)}")
        self.act = ACTIVATIONS[activation]
        self.fc1 = nn.Linear(dim, hidden_dim, dtype=dtype, device=device)
        self.fc2 = nn.Linear(hidden_dim, dim, dtype=dtype, device=device)
        self.dropout = Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.dropout(self.fc2(self.dropout(self.act(self.fc1(x)))))


def make_attention_mask(pad_mask: torch.Tensor) -> torch.Tensor:
    """[B, L] 1/0 validity mask → additive fp32 [B, 1, 1, L] bias
    (``finfo(float32).min`` on padding)."""
    neg = torch.finfo(torch.float32).min
    bias = torch.where(pad_mask[:, None, None, :] > 0, 0.0, neg)
    return bias.to(torch.float32)


def lecun_normal_(w: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    """flax's ``lecun_normal``: truncated normal (±2σ) of variance 1/fan_in.
    Drawn in fp32 on the generator's device, then copied: a CPU generator
    gives every device and dtype the same values from one seed."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    t = torch.empty(w.shape, dtype=torch.float32, device=generator.device)
    nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std, generator=generator)
    with torch.no_grad():
        w.copy_(t)


def normal_(w: torch.Tensor, std: float, generator: torch.Generator) -> None:
    t = torch.empty(w.shape, dtype=torch.float32, device=generator.device)
    t.normal_(0.0, std, generator=generator)
    with torch.no_grad():
        w.copy_(t)


def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Seeded random init with flax's default distributions: Dense and Conv
    kernels ``lecun_normal`` (zero bias), Embed normal with std dim^-½; a
    module with an ``init_params(generator)`` method draws its own."""
    for m in model.modules():
        if isinstance(m, nn.Linear):
            lecun_normal_(m.weight, m.in_features, generator)
            if m.bias is not None:
                with torch.no_grad():
                    m.bias.zero_()
        elif isinstance(m, nn.Conv2d):
            lecun_normal_(m.weight, m.weight[0].numel(), generator)
            if m.bias is not None:
                with torch.no_grad():
                    m.bias.zero_()
        elif isinstance(m, nn.Embedding):
            normal_(m.weight, m.embedding_dim ** -0.5, generator)
        elif hasattr(m, "init_params"):
            m.init_params(generator)


def checkpointed(layer: nn.Module, *args, **kwargs):
    """``layer(*args, **kwargs)`` with its activations recomputed in the
    backward instead of kept (the JAX package's ``nn.remat``), by the
    non-reentrant ``torch.utils.checkpoint``: the reentrant form gives the
    parameters no gradient when no input of the layer needs one (a frozen
    tower, the first layer behind a frozen embedding). A layer that draws
    (a ``Dropout`` or ``DropPath`` above rate 0) is refused: its recompute
    would draw another mask from the explicit generator, which
    ``preserve_rng_state`` does not restore."""
    if any(isinstance(m, _Drop) and m.rate > 0 for m in layer.modules()):
        raise ValueError(f"remat of a {type(layer).__name__} that holds a dropout above 0: "
                         f"its recompute would draw another mask")
    return checkpoint(layer, *args, use_reentrant=False, **kwargs)
