"""Component registry of the port: name → class maps per component kind.

Own copy of the surface of ``antmmf_tpu/common/registry.py`` that the ported
paths use (``register_<kind>`` decorators and ``get_<kind>_class`` lookups),
with its own instance, so the port's names never collide with the JAX
package's.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

_KINDS = ("model", "processor", "predictor", "trainer", "task", "builder", "metric", "sampler",
          "iteration_strategy", "head", "decoder")


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


def _make_register(kind: str):
    def register(self: Registry, name: Optional[str] = None):
        return self._decorator(kind, name)

    register.__name__ = f"register_{kind}"
    return register


def _make_get(kind: str):
    def get(self: Registry, name: str, default: Any = ...) -> type:
        return self.get_class(kind, name, default=default)

    get.__name__ = f"get_{kind}_class"
    return get


for _kind in _KINDS:  # register_model / get_model_class, ... for every kind
    setattr(Registry, f"register_{_kind}", _make_register(_kind))
    setattr(Registry, f"get_{_kind}_class", _make_get(_kind))


registry = Registry()
