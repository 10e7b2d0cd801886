"""Entry point: ``python -m antmmf_torch.run --config <yaml> [k v ...]``.

Port of ``antmmf_tpu/run.py``: flags → ``build_config`` (defaults < yaml <
``--config_override`` < the trailing ``key value`` overrides) →
``build_trainer`` → ``load`` → ``train``. ``--prj`` imports a project
package first for its registrations. The trainer runs on the card unless
``training_parameters.device cpu`` is given. ``main`` returns the trainer.
"""

from __future__ import annotations

import importlib
from typing import Any, Optional, Sequence

from antmmf_torch.common.build import build_config
from antmmf_torch.trainers.build import build_trainer
from antmmf_torch.utils.flags import get_parser


def plain_run(args: Any):
    if getattr(args, "prj", None):
        importlib.import_module(args.prj)  # registry side effects
    opts = [o for o in (args.opts or []) if o != "--"]
    config = build_config(args.config, args.config_override, opts, args)
    trainer = build_trainer(config)
    trainer.load()
    trainer.train()
    return trainer


def main(argv: Optional[Sequence[str]] = None):
    return plain_run(get_parser().parse_args(argv))


if __name__ == "__main__":
    main()
