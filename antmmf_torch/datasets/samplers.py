"""Samplers: index orders over a dataset.

Port of ``antmmf_tpu/datasets/samplers.py``: ``sequential_sampler`` and
``random_sampler``, whose permutation is ``default_rng(seed + epoch)``'s, so
an epoch visits the samples in the JAX package's order; ``set_epoch``
reseeds. The port runs in one process: ``distributed_sampler`` (and the
class-balance sampler) raise until they are ported.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np

from antmmf_torch.common.registry import registry


class AntmmfSampler:
    """Base: iterable over dataset indices. ``set_epoch`` reseeds shuffling."""

    def __init__(self, dataset, **kwargs):
        self.dataset = dataset
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = int(epoch)

    def __len__(self) -> int:
        return len(self.dataset)

    def __iter__(self) -> Iterator[int]:
        raise NotImplementedError


@registry.register_sampler("sequential_sampler")
class SequentialSampler(AntmmfSampler):
    def __iter__(self) -> Iterator[int]:
        return iter(range(len(self.dataset)))


@registry.register_sampler("random_sampler")
class RandomSampler(AntmmfSampler):
    def __init__(self, dataset, seed: int = 0, **kwargs):
        super().__init__(dataset)
        self.seed = int(seed)

    def __iter__(self) -> Iterator[int]:
        rng = np.random.default_rng(self.seed + self.epoch)
        return iter(rng.permutation(len(self.dataset)).tolist())


def build_sampler(sampler_config, dataset, **extra) -> AntmmfSampler:
    cfg = dict(sampler_config or {})
    name = cfg.get("type", "sequential_sampler")
    if name in ("distributed_sampler", "class_balance_sampler"):
        raise NotImplementedError(f"sampler {name!r} is not ported yet; the port runs in one "
                                  f"process with sequential_sampler or random_sampler")
    params = dict(cfg.get("params", {}))
    params.update(extra)
    return registry.get_sampler_class(name)(dataset, **params)
