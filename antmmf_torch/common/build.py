"""Config assembly: defaults, the config file, an override file, command-line opts.

Port of ``antmmf_tpu/common/build.py``: the priority is defaults < yaml <
override file < command line, and the result is frozen. The defaults are
the port's own copy of ``defaults/configs/base.yml``.
"""

from __future__ import annotations

import os
from typing import Any, Optional, Sequence

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
