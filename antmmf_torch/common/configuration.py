"""YAML configuration: includes, ``${ENV}`` expansion, dotted overrides.

Own copy of the part of ``antmmf_tpu/common/configuration.py`` that serving
needs: ``includes:`` deep merge (the including file wins; later includes win
over earlier ones), environment expansion, dotted-path command-line overrides
with literal typing, and a mapping whose nested views share storage with
the root.
"""

from __future__ import annotations

import ast
import collections.abc
import copy
import os
import re
from typing import Any, Dict, Iterator, List, Mapping, Sequence

import yaml

_ENV_PATTERN = re.compile(r"\$\{(\w+)\}")


def _decode_value(value: str) -> Any:
    """Typed decode of a command-line override string."""
    value = value.strip()
    if value.lower() == "true":
        return True
    if value.lower() == "false":
        return False
    if value.lower() in ("none", "null"):
        return None
    try:
        return ast.literal_eval(value)
    except (ValueError, SyntaxError):
        return value


def _plain(obj: Any) -> Any:
    if isinstance(obj, Configuration):
        return obj.to_dict()
    if isinstance(obj, collections.abc.Mapping):
        return {k: _plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_plain(v) for v in obj]
    return obj


def nested_dict_update(base: Dict[str, Any], update: Mapping[str, Any]) -> Dict[str, Any]:
    """Deep-merge ``update`` into ``base`` in place; dicts merge, the rest replaces."""
    for key, val in update.items():
        if isinstance(val, collections.abc.Mapping) and isinstance(base.get(key), dict):
            nested_dict_update(base[key], val)
        else:
            base[key] = _plain(val)
    return base


def load_yaml_with_includes(path: str) -> Dict[str, Any]:
    with open(path, "r", encoding="utf-8") as f:
        text = _ENV_PATTERN.sub(lambda m: os.environ.get(m.group(1), m.group(0)), f.read())
    data = yaml.safe_load(text) or {}
    if not isinstance(data, dict):
        raise TypeError(f"Top level of config {path!r} must be a mapping")
    includes = data.pop("includes", [])
    if isinstance(includes, str):
        includes = [includes]
    merged: Dict[str, Any] = {}
    base_dir = os.path.dirname(os.path.abspath(path))
    for inc in includes:
        inc_path = inc if os.path.isabs(inc) else os.path.join(base_dir, inc)
        if not os.path.exists(inc_path):
            if not os.path.exists(os.path.abspath(inc)):  # repo-root-relative
                raise FileNotFoundError(f"Included config not found: {inc!r} (from {path})")
            inc_path = os.path.abspath(inc)
        nested_dict_update(merged, load_yaml_with_includes(inc_path))
    nested_dict_update(merged, data)
    return merged


class Configuration(collections.abc.Mapping):
    """Nested mapping; nested dicts are returned as views sharing storage
    with the root."""

    __slots__ = ("_data",)

    def __init__(self, data: Mapping[str, Any] = None, _shared: bool = False):
        object.__setattr__(self, "_data", data if _shared else _plain(dict(data or {})))

    @classmethod
    def from_file(cls, path: str) -> "Configuration":
        return cls(load_yaml_with_includes(path))

    def _wrap(self, val: Any) -> Any:
        return Configuration(val, _shared=True) if isinstance(val, dict) else val

    def __getitem__(self, key: str) -> Any:
        return self._wrap(self._data[key])

    def __iter__(self) -> Iterator[str]:
        return iter(self._data)

    def __len__(self) -> int:
        return len(self._data)

    def __setitem__(self, key: str, value: Any) -> None:
        self._data[key] = _plain(value)

    def to_dict(self) -> Dict[str, Any]:
        return copy.deepcopy(self._data)

    def override_with_opts(self, opts: Sequence[str]) -> "Configuration":
        """Apply ``key.path value ...`` or ``key.path=value`` overrides."""
        pairs: List[tuple] = []
        opts = list(opts or [])
        i = 0
        while i < len(opts):
            if "=" in opts[i]:
                pairs.append(tuple(opts[i].split("=", 1)))
                i += 1
            else:
                if i + 1 >= len(opts):
                    raise ValueError(f"Dangling override key {opts[i]!r} (no value)")
                pairs.append((opts[i], opts[i + 1]))
                i += 2
        for key, raw in pairs:
            self.set_dotted(key, _decode_value(raw))
        return self

    def set_dotted(self, dotted_key: str, value: Any) -> None:
        node = self._data
        parts = dotted_key.split(".")
        for part in parts[:-1]:
            if not isinstance(node.get(part), dict):
                node[part] = {}
            node = node[part]
        node[parts[-1]] = _plain(value)

    def get_dotted(self, dotted_key: str, default: Any = None) -> Any:
        node: Any = self._data
        for part in dotted_key.split("."):
            if not isinstance(node, dict) or part not in node:
                return default
            node = node[part]
        return self._wrap(node)

    def __repr__(self) -> str:
        return f"Configuration({self._data!r})"


def convert_to_config(obj: Any) -> Configuration:
    return obj if isinstance(obj, Configuration) else Configuration(obj)
