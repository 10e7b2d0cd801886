"""Component registry of the port: name → class maps per component kind.

Own copy of the surface of ``antmmf_tpu/common/registry.py`` that the serving
path uses (``register_<kind>`` decorators and ``get_<kind>_class`` lookups),
with its own instance, so the port's names never collide with the JAX
package's.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

_KINDS = ("model", "processor", "predictor")


class Registry:
    def __init__(self) -> None:
        self._maps: Dict[str, Dict[str, type]] = {kind: {} for kind in _KINDS}

    def register_class(self, kind: str, name: str, cls: type) -> type:
        table = self._maps[kind]
        if name in table and table[name] is not cls:
            raise KeyError(f"{kind} {name!r} already registered to {table[name]!r}")
        table[name] = cls
        return cls

    def get_class(self, kind: str, name: str, *, default: Any = ...) -> type:
        table = self._maps[kind]
        if name in table:
            return table[name]
        if default is not ...:
            return default
        known = ", ".join(sorted(table)) or "<empty>"
        raise KeyError(f"No {kind} named {name!r} in registry. Registered: {known}")

    def _decorator(self, kind: str, name: Optional[str]) -> Callable[[type], type]:
        def wrap(cls: type) -> type:
            return self.register_class(kind, name or cls.__name__, cls)

        return wrap

    def register_model(self, name: Optional[str] = None):
        return self._decorator("model", name)

    def register_processor(self, name: Optional[str] = None):
        return self._decorator("processor", name)

    def register_predictor(self, name: Optional[str] = None):
        return self._decorator("predictor", name)

    def get_model_class(self, name: str, default: Any = ...) -> type:
        return self.get_class("model", name, default=default)

    def get_processor_class(self, name: str, default: Any = ...) -> type:
        return self.get_class("processor", name, default=default)

    def get_predictor_class(self, name: str, default: Any = ...) -> type:
        return self.get_class("predictor", name, default=default)


registry = Registry()
