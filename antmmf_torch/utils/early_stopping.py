"""Early stopping: monitor a validation metric, track the best, signal stop.

Port of ``antmmf_tpu/utils/early_stopping.py``: patience in iterations,
``val/`` prefixing of the monitored metric, minimize or maximize; ``is_best``
says whether the last call improved. Over ranks the trainer broadcasts
rank 0's decisions, so no rank leaves the loop alone.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Mapping


class EarlyStopping:
    def __init__(
        self,
        monitored_metric: str = "total_loss",
        patience: int = 30000,
        minimize: bool = True,
        should_stop: bool = True,
    ):
        self.monitored_metric = monitored_metric
        if not monitored_metric.startswith("val") and monitored_metric != "total_loss":
            self.monitored_metric = f"val/{monitored_metric}"
        self.patience = int(patience)
        self.minimize = bool(minimize)
        self.enabled = bool(should_stop)
        self.best_value = math.inf if minimize else -math.inf
        self.best_iteration = 0
        self.activated = False

    def improved(self, value: float) -> bool:
        return value < self.best_value if self.minimize else value > self.best_value

    def __call__(self, iteration: int, metrics: Mapping[str, Any]) -> bool:
        """Returns True when training should stop."""
        self._last_is_best = False
        value = metrics.get(self.monitored_metric)
        if value is None:
            # fall back to the raw name (metrics may already carry prefixes)
            value = metrics.get(self.monitored_metric.replace("val/", ""))
        if value is None:
            return False
        value = float(value)
        if self.improved(value):
            self.best_value = value
            self.best_iteration = int(iteration)
            self._last_is_best = True
        elif self.enabled and iteration - self.best_iteration > self.patience:
            self.activated = True
            return True
        return False

    @property
    def is_best(self) -> bool:
        return getattr(self, "_last_is_best", False)

    def summary(self) -> Dict[str, Any]:
        return {
            "metric": self.monitored_metric,
            "best_value": self.best_value,
            "best_iteration": self.best_iteration,
            "early_stopped": self.activated,
        }
