"""TaskLoader: builds the tasks of each run type and wires their datasets
into DataLoaders.

Port of ``antmmf_tpu/common/task_loader.py``: one task per entry of
``task_attributes`` and run type, one loader per dataset (``drop_last`` for
train, ``pad_last`` for eval), the train sampler from
``training_parameters.sampler`` and a sequential one for eval, and
``seed_sampler`` to reseed an epoch. Over several ranks (the process
group's world) each rank loads ``batch_size / world`` samples (``batch_size
/ (world / seq)`` under a registered mesh with a ``seq`` axis, whose ranks
of a line read the rows of their data coordinate), through the
``distributed_sampler`` (``training_parameters.distributed_sampler``, a
shuffled one for train, an ordered one for eval), and the last eval batch
is wrapped to full size; in one process the loader yields the whole global
batch. Streaming (iterable-only) datasets raise until they are ported.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional

from antmmf_torch.common.configuration import convert_to_config
from antmmf_torch.common.registry import registry
from antmmf_torch.datasets.base_dataset import BaseIterableDataset
from antmmf_torch.datasets.loader import DataLoader
from antmmf_torch.datasets.samplers import build_sampler
from antmmf_torch.parallel import collectives as coll
from antmmf_torch.parallel.mesh import active_mesh, data_parallel_size


class TaskLoader:
    def __init__(self, config: Mapping):
        self.config = convert_to_config(config)
        self.tp = self.config.get("training_parameters", {})
        self.tasks: Dict[str, List[Any]] = {}
        self.loaders: Dict[str, List[DataLoader]] = {}

    def load_task(self, run_types: Optional[List[str]] = None) -> None:
        task_attributes = self.config.get("task_attributes", {})
        for dataset_type in run_types or ["train", "val", "test"]:
            self.tasks[dataset_type] = []
            for task_name, task_cfg in dict(task_attributes).items():
                task_cls = registry.get_task_class(task_cfg.get("type", "base_task"),
                                                   default=None)
                task = (task_cls or registry.get_task_class("base_task"))(task_name)
                task.load(task_cfg, dataset_type)
                self.tasks[dataset_type].append(task)

    def make_dataloaders(self) -> None:
        global_bs = int(self.tp.get("batch_size", 8))
        test_bs = int(self.tp.get("test_batch_size") or global_bs)
        # the ranks of a ``seq`` line load the same rows: the batch is split
        # over the (data, fsdp) ranks alone
        mesh = active_mesh()
        nproc = coll.get_world_size() if mesh is None or mesh.collapsed \
            else data_parallel_size(mesh)
        for bs, name in ((global_bs, "batch_size"), (test_bs, "test_batch_size")):
            if bs % nproc:
                raise ValueError(f"{name}={bs} must be divisible by the data-parallel "
                                 f"process count {nproc}")
        num_workers = int(self.tp.get("num_workers", 0))
        for dataset_type, tasks in self.tasks.items():
            self.loaders[dataset_type] = []
            per_process_bs = (global_bs if dataset_type == "train" else test_bs) // nproc
            for task in tasks:
                for dataset in task.get_datasets():
                    if isinstance(dataset, BaseIterableDataset):
                        raise NotImplementedError(
                            f"streaming dataset {dataset.name!r}: iterable-only datasets "
                            f"are not ported yet")
                    self.loaders[dataset_type].append(DataLoader(
                        dataset, batch_size=per_process_bs,
                        sampler=self._build_sampler(dataset, dataset_type),
                        collate_fn=dataset.collate_fn, num_workers=num_workers,
                        drop_last=(dataset_type == "train"),
                        pad_last=(dataset_type != "train")))

    def _build_sampler(self, dataset, dataset_type: str):
        if coll.get_world_size() > 1:
            cfg = dict(self.tp.get("distributed_sampler", {"type": "distributed_sampler"}))
            cfg.setdefault("type", "distributed_sampler")
            extra = {}
            mesh = active_mesh()
            if mesh is not None and mesh.shape["seq"] > 1:
                # a rank reads the rows of its data coordinate, not of its rank
                extra = dict(num_replicas=data_parallel_size(mesh),
                             rank=mesh.batch_index(coll.get_rank()))
            return build_sampler(cfg, dataset, shuffle=(dataset_type == "train"), **extra)
        if dataset_type == "train":
            return build_sampler(self.tp.get("sampler", {"type": "random_sampler"}), dataset)
        return build_sampler({"type": "sequential_sampler"}, dataset)

    def seed_sampler(self, dataset_type: str, epoch: int) -> None:
        for loader in self.loaders.get(dataset_type, []):
            sampler = getattr(loader, "sampler", None)
            if sampler is not None and hasattr(sampler, "set_epoch"):
                sampler.set_epoch(epoch)

    def get_loaders(self, dataset_type: str) -> List[DataLoader]:
        return self.loaders.get(dataset_type, [])
