"""Command-line flags of ``python -m antmmf_torch.run``.

Own copy of ``antmmf_tpu/utils/flags.py``: ``--config``,
``--config_override``, ``--local_rank``, ``--prj`` and the trailing dotted
overrides (``key value ...`` or ``key=value``).
"""

from __future__ import annotations

import argparse


def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="antmmf_torch", allow_abbrev=False)
    parser.add_argument("--config", type=str, default=None, help="path to yaml config")
    parser.add_argument("--config_override", type=str, default=None,
                        help="path to override yaml")
    parser.add_argument("--local_rank", type=int, default=None)
    parser.add_argument("--prj", type=str, default=None, help="project package to import")
    parser.add_argument("opts", nargs=argparse.REMAINDER, default=None,
                        help="dotted-path overrides: key value ... or key=value")
    return parser
