"""Windowed metric smoothing for training telemetry.

Port of ``antmmf_tpu/common/meter.py``: ``SmoothedValue`` keeps a window of
20 values with their median and the global average; ``Meter`` keeps one per
series and formats the log line (median and global average of ``train/*``
series, the global average of the rest). Values are host floats; the
trainer reads them from the device once per logged step.
"""

from __future__ import annotations

import collections
from typing import Any, Mapping

import numpy as np


class SmoothedValue:
    def __init__(self, window_size: int = 20):
        self.deque: collections.deque = collections.deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0

    def update(self, value: float, n: int = 1) -> None:
        value = float(value)
        self.deque.append(value)
        self.total += value * n
        self.count += n

    @property
    def median(self) -> float:
        return float(np.median(self.deque)) if self.deque else 0.0

    @property
    def global_avg(self) -> float:
        return self.total / max(self.count, 1)


class Meter:
    def __init__(self, delimiter: str = ", "):
        self.meters: "collections.OrderedDict[str, SmoothedValue]" = collections.OrderedDict()
        self.delimiter = delimiter

    def update(self, update_dict: Mapping[str, Any], n: int = 1) -> None:
        for key, value in update_dict.items():
            self.meters.setdefault(key, SmoothedValue()).update(float(value), n)

    def __str__(self) -> str:
        return self.delimiter.join(
            f"{name}: {m.median:.4f} ({m.global_avg:.4f})" if "train" in name
            else f"{name}: {m.global_avg:.4f}" for name, m in self.meters.items())
