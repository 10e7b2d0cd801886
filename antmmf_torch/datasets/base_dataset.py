"""Dataset base classes: map-style datasets owning databases and processors.

Port of ``antmmf_tpu/datasets/base_dataset.py``: ``BaseDataset`` builds every
``*_processor`` entry of its config, ``get_item(idx)`` returns a ``Sample`` of
fixed-shape numpy fields, ``__getitem__`` stamps the dataset's type and name
and ``collate_fn`` stacks samples into a ``SampleList``. The trainer moves
batches to the device. ``BaseIterableDataset`` marks streaming datasets,
which the port's loaders refuse until they are ported.
"""

from __future__ import annotations

from typing import Iterator, Mapping, Optional

from antmmf_torch.common.configuration import Configuration, convert_to_config
from antmmf_torch.datasets.processors.processors import build_processors
from antmmf_torch.structures.sample import Sample, SampleList


class BaseDataset:
    """Map-style dataset. Subclasses implement ``__len__`` and ``get_item(idx)``."""

    def __init__(self, name: str, dataset_type: str, config: Optional[Mapping] = None):
        self._name = name
        self._dataset_type = dataset_type
        self.config: Configuration = convert_to_config(config or {})
        self.processors = build_processors(self.config.get("processors", {}))
        for key, proc in self.processors.items():
            setattr(self, key, proc)

    @property
    def name(self) -> str:
        return self._name

    @property
    def dataset_type(self) -> str:
        return self._dataset_type

    def is_training(self) -> bool:
        return self._dataset_type == "train"

    def __len__(self) -> int:
        raise NotImplementedError

    def get_item(self, idx: int) -> Sample:
        raise NotImplementedError

    def __getitem__(self, idx: int) -> Sample:
        sample = self.get_item(idx)
        sample["dataset_type"] = self._dataset_type
        sample["dataset_name"] = self._name
        return sample

    def collate_fn(self, samples) -> SampleList:
        return SampleList.from_samples(samples)


class BaseIterableDataset(BaseDataset):
    """Stream-style dataset: implement ``__iter__``."""

    def __iter__(self) -> Iterator[Sample]:
        raise NotImplementedError

    def __len__(self) -> int:
        raise TypeError(f"{type(self).__name__} is iterable-only")
