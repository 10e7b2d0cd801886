"""Iteration strategies: how multi-dataset training interleaves its datasets.

Port of ``antmmf_tpu/tasks/iteration_strategies.py``: ``size_proportional``,
``uniform``, ``round_robin`` and ``ratios``, each drawing from its own numpy
``Generator``, picked by name::

    task_attributes:
      my_task:
        iteration_strategy: {type: size_proportional}
"""

from __future__ import annotations

from typing import Any, Mapping, Optional, Sequence

import numpy as np

from antmmf_torch.common.registry import registry


class IterationStrategy:
    def __init__(self, dataset_sizes: Sequence[int],
                 params: Optional[Mapping[str, Any]] = None, seed: int = 0):
        self.sizes = np.asarray(dataset_sizes, np.float64)
        self.params = dict(params or {})
        self.rng = np.random.default_rng(seed)
        self._step = 0

    def __call__(self) -> int:
        raise NotImplementedError


@registry.register_iteration_strategy("size_proportional")
class SizeProportional(IterationStrategy):
    def __call__(self) -> int:
        p = self.sizes / self.sizes.sum()
        return int(self.rng.choice(len(self.sizes), p=p))


@registry.register_iteration_strategy("uniform")
class Uniform(IterationStrategy):
    def __call__(self) -> int:
        return int(self.rng.integers(0, len(self.sizes)))


@registry.register_iteration_strategy("round_robin")
class RoundRobin(IterationStrategy):
    def __call__(self) -> int:
        idx = self._step % len(self.sizes)
        self._step += 1
        return idx


@registry.register_iteration_strategy("ratios")
class Ratios(IterationStrategy):
    """Explicit sampling ratios: params.ratios = [w0, w1, ...]."""

    def __call__(self) -> int:
        w = np.asarray(self.params.get("ratios",
                                       [1.0] * len(self.sizes)), np.float64)
        return int(self.rng.choice(len(self.sizes), p=w / w.sum()))


def build_iteration_strategy(
    config: Optional[Mapping[str, Any]], dataset_sizes: Sequence[int],
    seed: int = 0,
) -> IterationStrategy:
    if not config:
        config = {"type": "size_proportional"}
    if isinstance(config, str):
        config = {"type": config}
    cls = registry.get_class("iteration_strategy", config["type"])
    return cls(dataset_sizes, config.get("params", {}), seed)
