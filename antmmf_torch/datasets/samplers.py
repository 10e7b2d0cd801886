"""Samplers: index orders over a dataset.

Port of ``antmmf_tpu/datasets/samplers.py``: ``sequential_sampler`` and
``random_sampler``, whose permutation is ``default_rng(seed + epoch)``'s, so
an epoch visits the samples in the JAX package's order; ``set_epoch``
reseeds; and ``distributed_sampler``, rank ``rank``'s share of such an
order among ``num_replicas`` ranks: padded by wrapping around to a multiple
of the ranks, then every ``num_replicas``-th index from ``rank`` on, so
every rank yields the same count. The class-balance sampler raises until
it is ported (queue A8d).
"""

from __future__ import annotations

from typing import Iterator, Optional

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


@registry.register_sampler("distributed_sampler")
class DistributedSampler(AntmmfSampler):
    def __init__(self, dataset, shuffle: bool = True, seed: int = 0,
                 num_replicas: Optional[int] = None, rank: Optional[int] = None, **kwargs):
        super().__init__(dataset)
        if num_replicas is None or rank is None:
            from antmmf_torch.parallel import collectives as coll

            num_replicas = coll.get_world_size() if num_replicas is None else num_replicas
            rank = coll.get_rank() if rank is None else rank
        self.num_replicas, self.rank = int(num_replicas), int(rank)
        self.shuffle, self.seed = bool(shuffle), int(seed)
        self.num_samples = -(-len(dataset) // self.num_replicas)
        self.total_size = self.num_samples * self.num_replicas

    def __len__(self) -> int:
        return self.num_samples

    def __iter__(self) -> Iterator[int]:
        n = len(self.dataset)
        order = (np.random.default_rng(self.seed + self.epoch).permutation(n).tolist()
                 if self.shuffle else list(range(n)))
        while len(order) < self.total_size:
            order += order[: self.total_size - len(order)]
        return iter(order[self.rank:self.total_size:self.num_replicas])


def build_sampler(sampler_config, dataset, **extra) -> AntmmfSampler:
    cfg = dict(sampler_config or {})
    name = cfg.get("type", "sequential_sampler")
    if name == "class_balance_sampler":
        raise NotImplementedError(f"sampler {name!r} is not ported yet (queue A8d)")
    params = dict(cfg.get("params", {}))
    params.update(extra)
    return registry.get_sampler_class(name)(dataset, **params)
