"""Tasks: named containers of one or more datasets.

Port of ``antmmf_tpu/tasks/base_task.py``: ``BaseTask.load`` builds every
dataset listed under ``datasets`` with its registered builder; with several
datasets, ``change_dataset`` picks the one the next batch comes from, in
proportion to their sizes when ``task_size_proportional_sampling`` is on.
"""

from __future__ import annotations

from typing import Any, List, Mapping, Optional

import numpy as np

from antmmf_torch.common.configuration import convert_to_config
from antmmf_torch.common.registry import registry


@registry.register_task("base_task")
class BaseTask:
    def __init__(self, task_name: str = "base_task"):
        self.task_name = task_name
        self.datasets: List[Any] = []
        self._proportions: Optional[np.ndarray] = None
        self._current = 0
        self._rng = np.random.default_rng(0)

    # ------------------------------------------------------------------- load
    def load(self, config: Mapping, dataset_type: str = "train") -> "BaseTask":
        """Build every dataset listed in config.dataset_attributes via its
        registered builder."""
        config = convert_to_config(config)
        names = config.get("datasets", [])
        if isinstance(names, str):
            names = [n.strip() for n in names.split(",") if n.strip()]
        attributes = config.get("dataset_attributes", {})
        for name in names:
            builder_cls = registry.get_builder_class(name)
            builder = builder_cls()
            ds_config = attributes.get(name, {})
            dataset = builder.build(ds_config, dataset_type)
            if dataset is not None:
                self.datasets.append(dataset)
        self._init_proportions(config)
        return self

    @staticmethod
    def _size_of(dataset) -> int:
        try:
            return max(1, len(dataset))
        except TypeError:  # iterable-only (streaming) datasets
            return 1

    def _init_proportions(self, config) -> None:
        if not self.datasets:
            return
        sizes = np.asarray([self._size_of(d) for d in self.datasets],
                           dtype=np.float64)
        if bool(config.get("task_size_proportional_sampling", True)):
            self._proportions = sizes / sizes.sum()
        else:
            self._proportions = np.full(len(sizes), 1.0 / len(sizes))

    # --------------------------------------------------------------- sampling
    def seed(self, seed: int) -> None:
        self._rng = np.random.default_rng(seed)

    def change_dataset(self) -> Any:
        """Pick the dataset the next batch is drawn from."""
        if len(self.datasets) == 1:
            self._current = 0
        else:
            self._current = int(self._rng.choice(len(self.datasets), p=self._proportions))
        return self.datasets[self._current]

    @property
    def current_dataset(self) -> Any:
        return self.datasets[self._current]

    def __len__(self) -> int:
        return sum(self._size_of(d) for d in self.datasets)

    def get_datasets(self) -> List[Any]:
        return self.datasets
