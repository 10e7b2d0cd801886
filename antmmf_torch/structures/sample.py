"""Sample / SampleList: one record and a batch of records.

Own copy of ``antmmf_tpu/structures/sample.py``'s containers: a ``Sample`` is a
dict of numpy arrays; ``SampleList.from_samples`` stacks
array fields into a batch and keeps other fields in ``metadata``
(``dataset_type`` and ``dataset_name`` once per batch).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Sequence

import numpy as np

# per-batch metadata: one value per batch, not a list per sample
_SCALAR_META_FIELDS = ("dataset_type", "dataset_name")


class Sample(dict):
    """One record: field name → numpy array / scalar / string."""


class SampleList(dict):
    """A batch: field name → stacked numpy array; other fields in ``.metadata``."""

    def __init__(self, init: Optional[Mapping[str, Any]] = None):
        super().__init__(init or {})
        self.metadata: Dict[str, Any] = {}

    @classmethod
    def from_samples(cls, samples: Sequence[Mapping[str, Any]]) -> "SampleList":
        batch = cls()
        if not samples:
            return batch
        keys = list(samples[0].keys())
        for s in samples[1:]:
            if set(s.keys()) != set(keys):
                raise ValueError(
                    f"Inconsistent sample fields: {sorted(keys)} vs {sorted(s.keys())}")
        for key in keys:
            values = [s[key] for s in samples]
            if key in _SCALAR_META_FIELDS:
                batch.metadata[key] = values[0]
            elif isinstance(values[0], (np.ndarray, np.generic, int, float, bool)):
                try:
                    batch[key] = np.stack([np.asarray(v) for v in values])
                except ValueError as e:
                    shapes = [np.asarray(v).shape for v in values]
                    raise ValueError(f"Field {key!r} has ragged shapes {shapes}") from e
            else:
                batch.metadata[key] = values
        return batch

    def get_batch_size(self) -> int:
        for v in self.values():
            if isinstance(v, np.ndarray) and v.ndim > 0:
                return int(v.shape[0])
        raise ValueError("Empty SampleList has no batch size")

    def arrays(self) -> Dict[str, np.ndarray]:
        """The array fields."""
        return dict(self)
