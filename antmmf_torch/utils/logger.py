"""Logging: a log file under ``save_dir/logs`` and stdout.

Port of ``antmmf_tpu/utils/logger.py``: ``Logger.write`` at a ``level`` to
one file per run (named by the config's hash and a timestamp) and to
stdout, and TensorBoard scalars when ``tensorboardX`` is installed. Over
ranks only rank 0 writes; the other ranks keep errors, on stderr.
"""

from __future__ import annotations

import hashlib
import logging
import os
import sys
import time
from typing import Any, Dict, Optional

from antmmf_torch.parallel import collectives as coll


class Logger:
    def __init__(self, config: Optional[Any] = None, name: str = "antmmf_torch"):
        self.logger = logging.getLogger(f"{name}.{id(self):x}")
        self.logger.setLevel(logging.DEBUG)
        self.logger.propagate = False
        self.log_file: Optional[str] = None
        self._tb = None
        fmt = logging.Formatter("%(asctime)s %(levelname)s: %(message)s",
                                datefmt="%Y-%m-%dT%H:%M:%S")
        save_dir = None
        if not coll.is_main_process():
            errors = logging.StreamHandler(sys.stderr)
            errors.setLevel(logging.ERROR)
            errors.setFormatter(fmt)
            self.logger.addHandler(errors)
            return
        if config is not None:
            tp = config.get("training_parameters", {}) or {}
            save_dir = tp.get("save_dir", "./save")
            if not bool(tp.get("should_log", True)):
                save_dir = None
        if save_dir:
            log_dir = os.path.join(save_dir, "logs")
            os.makedirs(log_dir, exist_ok=True)
            digest = hashlib.sha1(str(config.to_dict()).encode()).hexdigest()[:8]
            stamp = time.strftime("%Y-%m-%dT%H-%M-%S")
            self.log_file = os.path.join(log_dir, f"{digest}_{stamp}_rank0.log")
            fh = logging.FileHandler(self.log_file, encoding="utf-8")
            fh.setFormatter(fmt)
            self.logger.addHandler(fh)
        stdout = logging.StreamHandler(sys.stdout)
        stdout.setFormatter(fmt)
        self.logger.addHandler(stdout)
        if save_dir:
            try:
                from tensorboardX import SummaryWriter  # optional
            except ImportError:
                SummaryWriter = None
            if SummaryWriter is not None:
                self._tb = SummaryWriter(os.path.join(save_dir, "tensorboard"))

    def write(self, message: Any, level: str = "info") -> None:
        getattr(self.logger, level, self.logger.info)(message)

    def add_scalars(self, scalars: Dict[str, float], step: int) -> None:
        if self._tb is None:
            return
        for key, val in scalars.items():
            self._tb.add_scalar(key, float(val), step)
