"""Wall-clock timer for the trainer's ETA.

Port of the part of ``antmmf_tpu/utils/timer.py`` the trainer reads.
"""

from __future__ import annotations

import time


class Timer:
    def __init__(self) -> None:
        self.start = time.time()

    def unix_time_since_start(self) -> float:
        return time.time() - self.start
