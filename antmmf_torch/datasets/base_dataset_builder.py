"""Dataset builders: named factories that the task layer resolves from YAML.

Port of ``antmmf_tpu/datasets/base_dataset_builder.py``: ``build`` runs the
builder's ``_build`` (download or prepare; nothing for local data) and then
``_load``, which constructs the dataset of one type. The port runs in one
process, so there is no barrier between the two.
"""

from __future__ import annotations

from typing import Any, Mapping

from antmmf_torch.common.configuration import convert_to_config


class BaseDatasetBuilder:
    def __init__(self, dataset_name: str):
        self.dataset_name = dataset_name

    def build(self, config: Mapping, dataset_type: str = "train", *args: Any, **kw: Any):
        config = convert_to_config(config)
        self._build(dataset_type, config, *args, **kw)
        return self._load(dataset_type, config, *args, **kw)

    def _build(self, dataset_type: str, config, *args: Any, **kw: Any) -> None:
        """Download / preprocess. Default: nothing (local data)."""

    def _load(self, dataset_type: str, config, *args: Any, **kw: Any):
        raise NotImplementedError
