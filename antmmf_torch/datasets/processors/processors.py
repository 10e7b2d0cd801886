"""Processor framework: registry-driven host-side transforms.

Own copy of ``antmmf_tpu/datasets/processors/processors.py``'s
``BaseProcessor``, lazy ``Processor`` wrapper and ``build_processors``:
processors are configured as ``{type: <registry name>, params: {...}}``.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

from antmmf_torch.common.configuration import convert_to_config
from antmmf_torch.common.registry import registry


class BaseProcessor:
    """A host-side transform. Subclasses implement ``__call__(item) -> dict``."""

    def __init__(self, config: Optional[Mapping[str, Any]] = None):
        self.config = convert_to_config(config or {})


class Processor:
    """Resolves the registered processor class on first use, so building a
    config never loads vocabularies."""

    def __init__(self, config: Mapping[str, Any]):
        config = convert_to_config(config)
        if "type" not in config:
            raise ValueError("Processor config needs a 'type' key")
        self._type = config["type"]
        self._params = config.get("params", {})
        self._processor: Optional[BaseProcessor] = None

    def __call__(self, item: Any, *args: Any, **kwargs: Any) -> Any:
        if self._processor is None:
            self._processor = registry.get_processor_class(self._type)(self._params)
        return self._processor(item, *args, **kwargs)


def build_processors(processors_config: Optional[Mapping[str, Any]]) -> Dict[str, Processor]:
    """One lazy ``Processor`` per ``*_processor`` entry of a config."""
    return {key: Processor(cfg) for key, cfg in dict(processors_config or {}).items()}
