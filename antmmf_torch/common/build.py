"""Config assembly: defaults, the config file, an override file, command-line opts.

Port of ``antmmf_tpu/common/build.py``: the priority is defaults < yaml <
override file < command line, and the result is frozen. The defaults are
the port's own copy of ``defaults/configs/base.yml``. ``overlay_opts`` lays
sections of one config over another as command-line opts.
"""

from __future__ import annotations

import json
import os
from typing import Any, List, Optional, Sequence

from antmmf_torch.common.configuration import Configuration, load_yaml_with_includes

_DEFAULTS_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "defaults",
                              "configs", "base.yml")


def build_config(config_path: Optional[str] = None, config_override: Optional[str] = None,
                 opts: Optional[Sequence[str]] = None, args: Any = None,
                 freeze: bool = True) -> Configuration:
    config = Configuration(load_yaml_with_includes(_DEFAULTS_PATH))
    if config_path:
        config.merge(load_yaml_with_includes(config_path))
        config.set_dotted("config_path", os.path.abspath(config_path))
    if config_override:
        config.merge(load_yaml_with_includes(config_override))
    if opts:
        config.override_with_opts(opts)
    if args is not None:
        for key in ("local_rank", "prj"):
            if getattr(args, key, None) is not None:
                config.set_dotted(key, getattr(args, key))
    if freeze:
        config.freeze()
    return config


def overlay_opts(config_path: str, sections: Sequence[str]) -> List[str]:
    """``key value`` opts that lay the dotted ``sections`` of the yaml at
    ``config_path`` (for example ``model_attributes.pink``) over another
    config: one opt a leaf, lists as JSON."""
    config = Configuration(load_yaml_with_includes(config_path))
    opts: List[str] = []

    def walk(prefix: str, node: Any) -> None:
        if isinstance(node, dict):
            for key, value in node.items():
                walk(f"{prefix}.{key}", value)
        elif isinstance(node, (list, tuple)):
            opts.extend([prefix, json.dumps(list(node))])
        else:
            opts.extend([prefix, str(node).lower() if isinstance(node, bool) else str(node)])

    for section in sections:
        node = config.get_dotted(section)
        if node is None:
            raise KeyError(f"{config_path} has no {section}")
        walk(section, node.to_dict() if hasattr(node, "to_dict") else node)
    return opts
