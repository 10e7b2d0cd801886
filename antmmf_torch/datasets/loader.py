"""Host data loader: sampler-driven batching with threaded prefetch, and the
host → device pipeline.

Port of ``antmmf_tpu/datasets/loader.py``. ``DataLoader`` fetches samples on
a pool of worker threads (decode and resize run in C libraries that release
the GIL) and keeps ``prefetch_batches`` collated batches ready ahead of the
consumer; ``drop_last`` (train) drops the final short batch, ``pad_last``
(eval) wraps it to a full batch, as the JAX loader does, and corpus
evaluators drop the repeated rows by their ids. ``prefetch_to_device`` keeps
``depth`` batches in flight: ``to_device`` stages each array in pinned host
memory and copies it with ``non_blocking``, so the host enqueues the next
batch's copy without waiting for the running step (on the device the copy
runs in stream order, after that step). A loader's batch carries the
dataset indices it was made from (``sample_index``), which corpus
evaluators over ranks read to put the rows of every rank back in the
dataset's order.
"""

from __future__ import annotations

import collections
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, Iterator, Mapping, Optional

import numpy as np
import torch

from antmmf_torch.structures.sample import SampleList


class DataLoader:
    def __init__(self, dataset, batch_size: int, sampler=None,
                 collate_fn: Optional[Callable] = None, num_workers: int = 0,
                 drop_last: bool = False, prefetch_batches: int = 2, pad_last: bool = False):
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.sampler = sampler
        self.collate_fn = collate_fn or getattr(dataset, "collate_fn", SampleList.from_samples)
        self.num_workers = int(num_workers)
        self.drop_last = bool(drop_last)
        self.pad_last = bool(pad_last)
        self.prefetch_batches = max(1, int(prefetch_batches))

    def __len__(self) -> int:
        n = len(self.sampler) if self.sampler is not None else len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def _index_batches(self) -> Iterator[list]:
        indices = iter(self.sampler) if self.sampler is not None else iter(
            range(len(self.dataset)))
        batch: list = []
        for idx in indices:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            if self.pad_last and len(batch) < self.batch_size:
                wrap = batch * (-(-self.batch_size // len(batch)))
                batch = wrap[: self.batch_size]
            yield batch

    def _make_batch(self, idx_batch: list, pool: Optional[ThreadPoolExecutor]):
        if pool is not None:
            samples = list(pool.map(self.dataset.__getitem__, idx_batch))
        else:
            samples = [self.dataset[i] for i in idx_batch]
        batch = self.collate_fn(samples)
        if isinstance(batch, SampleList):
            batch.sample_index = list(idx_batch)
        return batch

    def __iter__(self) -> Iterator[SampleList]:
        if self.num_workers <= 0:
            for idx_batch in self._index_batches():
                yield self._make_batch(idx_batch, None)
            return

        pool = ThreadPoolExecutor(max_workers=self.num_workers)
        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch_batches)
        stop = threading.Event()
        sentinel = object()
        errors: list = []

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    pass
            return False

        def producer() -> None:
            try:
                for idx_batch in self._index_batches():
                    if not put(self._make_batch(idx_batch, pool)):
                        return
            except BaseException as e:  # handed to the consumer
                errors.append(e)
            finally:
                put(sentinel)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                item = out_q.get()
                if item is sentinel:
                    break
                yield item
            if errors:
                raise errors[0]
        finally:
            # a consumer that stops early (one batch taken) ends the producer
            stop.set()
            thread.join()
            pool.shutdown(wait=True)


def to_device(arrays: Mapping[str, Any], device: torch.device) -> Dict[str, torch.Tensor]:
    """A batch's arrays as tensors on ``device``; to CUDA through pinned host
    memory and ``non_blocking`` copies (the caching host allocator keeps a
    pinned buffer until its copy has run)."""
    out = {}
    for k, v in arrays.items():
        t = torch.from_numpy(np.asarray(v))
        out[k] = (t.pin_memory().to(device, non_blocking=True) if device.type == "cuda"
                  else t.to(device))
    return out


def prefetch_to_device(iterator, transfer, depth: int = 2):
    """Keep ``depth`` transferred batches in flight: ``transfer(batch)``
    enqueues batch N+1's copies before step N is dispatched."""
    queue_: "collections.deque" = collections.deque()
    for item in iterator:
        queue_.append(transfer(item))
        if len(queue_) >= depth:
            yield queue_.popleft()
    while queue_:
        yield queue_.popleft()
