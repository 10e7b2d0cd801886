"""BaseTrainer: config → task and data → model → train loop → validation →
checkpoints, on one device or over ranks.

Port of ``antmmf_tpu/trainers/base_trainer.py``. ``load`` builds the
tasks and their loaders, the model (seeded random weights), AdamW with the
model's ``optimizer_lr_multipliers`` rules after the config's, the
``TrainState``, the checkpoint (applying ``resume`` / ``resume_file`` /
``restart``), the meter, early stopping and the evaluator. ``train`` runs
epochs of ``make_train_step`` over batches that ``prefetch_to_device``
keeps in flight; every ``log_interval`` steps it reads the step's scalars
(the only host sync of the loop), evaluates the cached first val batch and
logs; every ``snapshot_interval`` steps it runs the full validation with
the evaluator, saves ``best`` when early stopping sees a new best, and a
snapshot. ``finalize`` validates once more and saves the last snapshot and
the final weights; ``inference`` evaluates val/test by run type. A SIGTERM
saves a snapshot at the next step boundary and ends the run
(``checkpoint_on_preemption``).

``training_parameters.device``: ``auto`` (the default) and ``cuda`` run on
the card and raise without CUDA; ``cpu`` runs on the CPU. The port's own
``training_parameters.init_on_device`` (off unless given) draws the seeded
init on that device: other values than the CPU's draws from the same seed,
in seconds for billions of parameters. A model with ``with_momentum``
trains MoCo momentum towers: the state holds their EMA
(``TrainState.init_momentum``, made before the checkpoint is applied, as
the JAX trainer makes it) and the step runs the key forward. The FLOPs
telemetry of the JAX trainer (XLA's cost analysis) is not ported.

Ranks: started by ``antmmf_torch.utils.launch``, the trainer joins the
process group (``parallel.collectives``) and builds the ``mesh``
(``parallel.mesh``) over it, which it registers (``set_active_mesh``, the
JAX trainer's ``registry.register("mesh", ...)``): the ``data`` × ``fsdp``
ranks each load ``batch_size / (data · fsdp)`` samples, the ranks of a
``seq`` line the same ones (a ``sequence_parallel`` model splits their
tokens), the step averages the fp32 gradients over every rank, and under
``fsdp`` the masters and the optimizer state are sharded
by ``param_sharding_rules`` (``TrainState``'s ``Shards``), so each step
computes what one device computes on the global batch; rank r's
generator is seeded from (seed, r). A mesh applies when the world size
matches it; at world size 1 it collapses, is written to the log, and the
whole global batch runs on the one device. Only a model whose losses
gather the global batch (``global_batch_over_ranks``: UniVL retrieval,
Pink and M2-omni, whose LM loss is the global token mean) runs over ranks.
The scalars are averaged over ranks where they are read, rank 0 alone
logs and writes checkpoints, and its early-stopping decisions and a
SIGTERM on any rank reach every rank. ``remat_policy`` recomputes the
loss's forward in the backward under a selective policy
(``train_state.remat_context``); ``steps_per_dispatch`` K groups the steps
into windows of K (``_end_window``): the log and the snapshot fire at a
window's end, with its last scalars, as in the JAX trainer, where a window
is one dispatch; a change of the batch's shape and the end of an epoch or
of the iteration budget end a window early, as they flush the JAX loop's
stack. The steps themselves are the same as without windows. Knobs of paths that are not ported raise with the key's
name: ``evalai_inference``, ``profile_at_iteration`` and ``interpret``.

With ``gradient_accumulation_steps`` k, a train step is one trainer
iteration (one micro-batch): the optimizer updates the masters every k-th,
and iterations, the logged lr (the schedule in trainer iterations),
snapshots and ``max_iterations`` count trainer iterations, as in the JAX
trainer. ``frozen_params`` and the model's own frozen weights hold no
optimizer state (``TrainState``); the log says how many parameters train.

``timings`` keeps, per train step on the host clock, the wait on the loader
and the time from asking for the batch to the step's return (the step
makes no host sync, so a step that outruns the device waits in a later
one), ``first_step_start`` (``time.perf_counter``), and ``loop_s``: the
train loop's wall time with everything in it (logging, full validations,
snapshots), up to the end of the device's work.
"""

from __future__ import annotations

import itertools
import math
import os
import signal
import threading
import time
from typing import Any, Dict, Mapping

import torch

from antmmf_torch.common.checkpoint import Checkpoint
from antmmf_torch.common.configuration import convert_to_config
from antmmf_torch.common.meter import Meter
from antmmf_torch.common.registry import registry
from antmmf_torch.common.task_loader import TaskLoader
from antmmf_torch.datasets.loader import prefetch_to_device, to_device
from antmmf_torch.models.base_model import ModelShell, build_model, resolve_device
from antmmf_torch.modules.metrics.evaluators import build_evaluator
from antmmf_torch.optimizer.build import build_optimizer
from antmmf_torch.parallel import collectives as coll
from antmmf_torch.parallel import partitioning
from antmmf_torch.parallel.mesh import build_mesh, set_active_mesh
from antmmf_torch.trainers.train_state import (Shards, TrainState, make_train_step,
                                               remat_context)
from antmmf_torch.utils.early_stopping import EarlyStopping
from antmmf_torch.utils.logger import Logger
from antmmf_torch.utils.timer import Timer
from antmmf_torch.utils.weights import flax_paths


def _signature(batch: Mapping[str, torch.Tensor]) -> tuple:
    """A batch's fields, shapes and dtypes: a change ends a dispatch window."""
    return tuple((k, tuple(v.shape), v.dtype) for k, v in batch.items())


@registry.register_trainer("base_trainer")
class BaseTrainer:
    def __init__(self, config: Mapping):
        self.config = convert_to_config(config)
        self.tp = self.config.get("training_parameters", {})
        self.run_type = self.tp.get("run_type", "train+inference")
        self.timings: Dict[str, Any] = {"loader_wait_s": [], "step_s": []}

    # ===================================================================== load
    def load(self) -> None:
        self._refuse_unported()
        self._init_device_and_seed()
        self.writer = Logger(self.config)
        self.mesh = build_mesh(self.tp.get("mesh", {"data": -1}), coll.get_world_size())
        # modules with a sequence_parallel knob, the loaders and the batch
        # collectives read the run's mesh
        set_active_mesh(self.mesh)
        if self.mesh.collapsed:
            layout = "one device: the whole global batch runs on it"
        else:
            layout = (f"{self.mesh.size} ranks over {coll.backend()}: data "
                      f"{self.mesh.shape['data']} x fsdp {self.mesh.shape['fsdp']} x seq "
                      f"{self.mesh.shape['seq']}")
        self.writer.write(f"device: {self.device}; mesh: {self.mesh.declared} ({layout})")
        self.load_task()
        self.load_model()
        self.load_optimizer()
        self.load_extras()
        self.compile_steps()

    def _refuse_unported(self) -> None:
        tp = self.tp
        refused = {
            "training_parameters.evalai_inference": bool(tp.get("evalai_inference", False)),
            "training_parameters.profile_at_iteration": bool(tp.get("profile_at_iteration")),
        }
        for key, bad in refused.items():
            if bad:
                raise NotImplementedError(f"{key}: not ported yet")

    def _init_device_and_seed(self) -> None:
        device = str(self.tp.get("device", "auto"))
        if device not in ("auto", "cuda", "cpu"):
            raise ValueError(f"training_parameters.device {device!r}: auto, cuda or cpu")
        self.device = resolve_device("cpu" if device == "cpu" else "cuda")
        coll.init_distributed(self.device.type)
        if self.device.type == "cuda":
            self.device = torch.device("cuda", torch.cuda.current_device())
        seed = self.tp.get("seed")
        # every rank draws the same seed (one init) from rank 0
        self.seed = int(seed) if seed is not None else int(coll.broadcast_scalar(
            int.from_bytes(os.urandom(2), "little")))

    def load_task(self) -> None:
        self.task_loader = TaskLoader(self.config)
        run_types = set()
        if "train" in self.run_type:
            run_types.update(("train", "val"))
        if "val" in self.run_type:
            run_types.add("val")
        if any(k in self.run_type for k in ("inference", "predict", "test")):
            run_types.add("test")
        self.task_loader.load_task(sorted(run_types))
        self.task_loader.make_dataloaders()

    def load_model(self) -> None:
        self.model_name = self.tp.get("model", None)
        self.shell: ModelShell = build_model(self.config, self.model_name, str(self.device))
        if self.model_name is None:
            self.model_name = list(self.config.get("model_attributes", {}).keys())[0]
        if coll.get_world_size() > 1 and not getattr(self.shell.module,
                                                     "global_batch_over_ranks", False):
            raise NotImplementedError(
                f"{type(self.shell.module).__name__} over {coll.get_world_size()} ranks: its "
                f"losses do not gather the global batch yet; univl_retrieval's, pink's and "
                f"m2_omni's do")
        # the JAX trainer initialises from the first batch of the first
        # loader; taking it here draws the same samples (and random frames)
        self._cached_first_batch = self._example_batch()
        t0 = time.time()
        self.shell.init(self.seed, on_device=bool(self.tp.get("init_on_device", False)))
        n_params = sum(p.numel() for p in self.shell.module.parameters())
        self.writer.write(f"model init in {time.time() - t0:.1f}s; params: {n_params:,}")

    def _example_batch(self):
        loaders = (self.task_loader.get_loaders("train") or self.task_loader.get_loaders("val")
                   or self.task_loader.get_loaders("test"))
        if not loaders:
            raise RuntimeError("No datasets configured")
        return next(iter(loaders[0]))

    def load_optimizer(self) -> None:
        opt_cfg = convert_to_config(self.config.get("optimizer_attributes", {})).to_dict()
        # the model's parameter groups (the JAX trainer's hook); config rules
        # come first, and the first matching rule wins
        grouping = getattr(self.shell.module, "optimizer_lr_multipliers", None)
        model_mults = [list(m) for m in (grouping(self.tp) or [])] if callable(grouping) else []
        if model_mults:
            opt_cfg["lr_multipliers"] = list(opt_cfg.get("lr_multipliers") or []) + model_mults
        self.tx, self.lr_schedule = build_optimizer(flax_paths(self.shell.module), opt_cfg,
                                                    self.tp.to_dict())

    def load_extras(self) -> None:
        module = self.shell.module
        rank = coll.get_rank()
        self.state = TrainState.create(
            module, self.tx, shards=self._shards(),
            seed=self.seed if coll.get_world_size() == 1 else coll.rank_seed(self.seed, rank))
        # full-MoCo momentum towers: the EMA of ``base`` from the initial masters
        self._moco_m = 0.0
        if getattr(module, "with_momentum", False):
            self.state.init_momentum("base")
            self._moco_m = float(module.momentum)
        n_train = sum(p.numel() for p in module.parameters() if p.requires_grad)
        n_all = sum(p.numel() for p in module.parameters())
        self.writer.write(f"trainable params: {n_train:,} of {n_all:,}; optimizer state: "
                          f"{self.state.optimizer_state_bytes():,} bytes, masters: "
                          f"{self.state.master_bytes():,} bytes (rank {rank})")
        self.checkpoint = Checkpoint(self.config, self.writer)
        self.state, self.resume_info = self.checkpoint.resume(self.state, self.tp)
        self.writer.write(f"checkpoint: {self.resume_info}")
        self.meter = Meter()
        self.early_stopping = EarlyStopping(
            monitored_metric=self.tp.get("monitored_metric", "total_loss"),
            patience=int(self.tp.get("patience", 30000)),
            minimize=bool(self.tp.get("metric_minimize", True)),
            should_stop=bool(self.tp.get("should_early_stop", False)))
        max_iterations = self.tp.get("max_iterations", math.inf)
        self.max_iterations = (math.inf if max_iterations in (".inf", math.inf, None)
                               else int(max_iterations))
        self.max_epochs = self.tp.get("max_epochs")
        if self.max_epochs is not None:
            epoch_len = sum(len(loader) for loader in self.task_loader.get_loaders("train")) or 1
            self.max_iterations = min(self.max_iterations, int(self.max_epochs) * epoch_len)
        self.log_interval = int(self.tp.get("log_interval", 100))
        self.snapshot_interval = int(self.tp.get("snapshot_interval", 1000))
        self.evaluator = build_evaluator(self.tp.get("evaluator", None))

    def _shards(self):
        """The ``fsdp`` split of the masters and the optimizer state, from
        ``param_sharding_rules`` (the JAX package's defaults without them);
        ``None`` without an ``fsdp`` axis above 1."""
        rules = self.tp.get("param_sharding_rules", None)
        rules = [tuple(r) for r in rules] if rules else None
        fsdp = self.mesh.shape["fsdp"]
        module = self.shell.module
        dims = partitioning.shard_dims(flax_paths(module),
                                       {n: p.shape for n, p in module.named_parameters()},
                                       fsdp, rules)
        if fsdp <= 1:
            return None
        group = self.mesh.fsdp_group("cuda" if coll.backend() == "nccl" else "cpu")
        return Shards(dims, group, fsdp, coll.group_rank(group))

    def compile_steps(self) -> None:
        """The train step (``make_train_step``) and the eval step: the loss
        and the outputs without gradients."""
        shell = self.shell
        remat = self.tp.get("remat_policy", "none")
        remat_kw = {"remat": remat} if remat_context(remat) is not None else {}
        self._train_step = make_train_step(shell, self.tx, self._moco_m, **remat_kw)
        self.steps_per_dispatch = max(1, int(self.tp.get("steps_per_dispatch", 1)))

        def eval_step(state: TrainState, batch: Mapping[str, torch.Tensor]):
            with torch.inference_mode():
                _, (output, scalars) = shell.loss_fn(batch, deterministic=True)
            return scalars, {k: v for k, v in output.items() if torch.is_tensor(v)}

        self._eval_step = eval_step

    def _to_device(self, batch) -> Dict[str, torch.Tensor]:
        return to_device(batch.arrays(), self.device)

    def interpret(self, *args, **kwargs):
        raise NotImplementedError("interpret: the saliency loop is not ported yet")

    # ==================================================================== train
    def train(self) -> None:
        if "train" not in self.run_type:
            self.inference()
            return
        old_sigterm = self._install_preemption_handler()
        try:
            self.writer.write(f"Starting training: max_iterations={self.max_iterations}")
            timer = Timer()
            iteration = self._start_iter = int(self.state.step)
            epoch = 0
            should_stop = False
            val_batch = self._first_val_batch()
            loop_start = time.perf_counter()
            while iteration < self.max_iterations and not should_stop:
                self.task_loader.seed_sampler("train", epoch)
                train_loaders = self.task_loader.get_loaders("train")
                if not train_loaders:
                    raise RuntimeError("run_type includes train but no train datasets")
                batches = (b for b in itertools.chain(*train_loaders) if b.get_batch_size() > 0)
                window, start, shape, end = self.steps_per_dispatch, iteration, None, ""
                asked = time.perf_counter()
                for batch in prefetch_to_device(batches, self._to_device):
                    got = time.perf_counter()
                    if iteration >= self.max_iterations:
                        # the last step ended an epoch early; the JAX loop
                        # counts this batch and names the final snapshot
                        # one step past the state it holds
                        break
                    if window > 1:
                        prev, shape = shape, _signature(batch)
                        if iteration > start and shape != prev:
                            # a change of shape ends the window, as it
                            # flushes the JAX loop's stack
                            end, start = self._end_window(start, iteration, scalars, val_batch,
                                                          timer), iteration
                            if end:
                                break
                    iteration += 1
                    self.timings.setdefault("first_step_start", got)
                    self.state, scalars = self._train_step(self.state, batch)
                    self.timings["loader_wait_s"].append(got - asked)
                    self.timings["step_s"].append(time.perf_counter() - asked)
                    if iteration - start == window or iteration >= self.max_iterations:
                        end, start = self._end_window(start, iteration, scalars, val_batch,
                                                      timer), iteration
                        if end:
                            break
                    asked = time.perf_counter()
                if not end and iteration > start:
                    # the epoch's last window, shorter than steps_per_dispatch
                    end = self._end_window(start, iteration, scalars, val_batch, timer)
                if end == "exit":
                    return
                should_stop = end == "stop"
                epoch += 1
                if self.max_epochs is not None and epoch >= int(self.max_epochs):
                    break
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.timings["loop_s"] = time.perf_counter() - loop_start
        finally:
            self._restore_sigterm(old_sigterm)
        self.finalize(iteration)

    def _end_window(self, start: int, iteration: int, scalars, val_batch, timer) -> str:
        """The end of the window of steps ``start`` + 1 .. ``iteration`` (one
        step, or up to ``steps_per_dispatch``): after a SIGTERM on any rank
        the state is saved and the run ends (``"exit"``; resume continues
        here); the log and the snapshot fire when a step of the window
        crossed their interval, with the window's last scalars, as in the
        JAX trainer's windows (``"stop"`` when early stopping ends the
        run)."""
        preempted = self._preempted
        if coll.is_distributed():
            preempted = bool(coll.all_reduce_max_scalar(float(preempted)))
        if preempted:
            self.checkpoint.save(self.state, iteration)
            self.writer.write(f"preemption checkpoint saved @ iter {iteration}; exiting",
                              "warning")
            return "exit"
        crossed = range(start + 1, iteration + 1)
        if any(j % self.log_interval == 0 for j in crossed):
            self._logistics_log(iteration, scalars, val_batch, timer)
        if any(j % self.snapshot_interval == 0 for j in crossed):
            if self._try_full_validation(iteration):
                return "stop"
        return ""

    def _install_preemption_handler(self):
        """SIGTERM → checkpoint and exit at the next step boundary (main
        thread only; off with ``checkpoint_on_preemption: false``)."""
        self._preempted = False
        self._sigterm_installed = False
        if not bool(self.tp.get("checkpoint_on_preemption", True)):
            return None
        if threading.current_thread() is not threading.main_thread():
            return None

        def _on_term(signum, frame):
            self._preempted = True

        old = signal.signal(signal.SIGTERM, _on_term)
        self._sigterm_installed = True
        return old

    def _restore_sigterm(self, old) -> None:
        if self._sigterm_installed:
            # None: the previous handler was set outside Python
            signal.signal(signal.SIGTERM, old if old is not None else signal.SIG_DFL)
            self._sigterm_installed = False

    def _first_val_batch(self):
        loaders = self.task_loader.get_loaders("val")
        if not loaders:
            return None
        return next(iter(loaders[0]), None)

    @staticmethod
    def _host(scalars: Mapping[str, torch.Tensor]) -> Dict[str, float]:
        """Device scalars → host floats in one transfer; over ranks their
        mean (a collective: every rank reads the same scalars)."""
        values = torch.stack([v.detach().float().reshape(()) for v in scalars.values()])
        if coll.is_distributed():
            coll.all_reduce_(values).div_(coll.get_world_size())
        return dict(zip(scalars, values.tolist()))

    def _logistics_log(self, iteration, scalars, val_batch, timer) -> None:
        host_scalars = {f"train/{k}": v for k, v in self._host(scalars).items()}
        if val_batch is not None:
            vscal, _ = self._eval_step(self.state, self._to_device(val_batch))
            host_scalars.update({f"val/{k}": v for k, v in self._host(vscal).items()})
        host_scalars["lr"] = float(self.lr_schedule(iteration))
        self.meter.update(host_scalars)
        self.writer.add_scalars(host_scalars, iteration)
        eta = ""
        if self.max_iterations != math.inf:
            per_iter = timer.unix_time_since_start() / max(1, iteration - self._start_iter)
            eta = f", eta {int(per_iter * (self.max_iterations - iteration))}s"
        self.writer.write(f"iter {iteration}/{self.max_iterations}: {self.meter}{eta}")

    # ================================================================ validation
    def _try_full_validation(self, iteration: int) -> bool:
        metrics = self.evaluate_set("val")
        named = {f"val/{k}": v for k, v in metrics.items()}
        self.writer.write(f"full val @ {iteration}: "
                          + ", ".join(f"{k}={v:.4f}" for k, v in named.items()))
        self.writer.add_scalars(named, iteration)
        monitored = dict(named)
        monitored["total_loss"] = (self.meter.meters["train/total_loss"].global_avg
                                   if "train/total_loss" in self.meter.meters
                                   else metrics.get("total_loss", 0.0))
        stop = bool(coll.broadcast_scalar(float(self.early_stopping(iteration, monitored))))
        if coll.broadcast_scalar(float(self.early_stopping.is_best)):
            self.checkpoint.save_best(self.state)
        self.checkpoint.save(self.state, iteration)
        return stop

    def evaluate_set(self, dataset_type: str = "val") -> Dict[str, float]:
        """The mean of each eval-step scalar over the set's batches, and the
        evaluator's corpus metrics."""
        loaders = self.task_loader.get_loaders(dataset_type)
        if not loaders:
            return {}
        if self.evaluator is not None:
            self.evaluator.reset()
        sums: Dict[str, float] = {}
        count = 0
        batches = (b for b in itertools.chain(*loaders) if b.get_batch_size() > 0)
        for batch, arrays in prefetch_to_device(batches, lambda b: (b, self._to_device(b))):
            scalars, output = self._eval_step(self.state, arrays)
            for k, v in self._host(scalars).items():
                sums[k] = sums.get(k, 0.0) + v
            count += 1
            if self.evaluator is not None:
                self.evaluator.collect(batch, {
                    k: (v.float() if v.is_floating_point() else v).cpu().numpy()
                    for k, v in output.items()})
        metrics = {k: v / max(count, 1) for k, v in sums.items()}
        if self.evaluator is not None:
            metrics.update(self.evaluator.summarize())
        return metrics

    # ================================================================ inference
    def inference(self) -> Dict[str, Dict[str, float]]:
        results = {}
        for dataset_type in ("val", "test"):
            if dataset_type == "val" and "val" not in self.run_type:
                continue
            if dataset_type == "test" and not any(
                    k in self.run_type for k in ("inference", "test", "predict")):
                continue
            metrics = self.evaluate_set(dataset_type)
            if metrics:
                self.writer.write(f"{dataset_type} inference: "
                                  + ", ".join(f"{k}={v:.4f}" for k, v in metrics.items()))
                results[dataset_type] = metrics
        return results

    # ================================================================= finalize
    def finalize(self, iteration: int) -> None:
        metrics = self.evaluate_set("val")
        if metrics:
            self.writer.write("final val: " + ", ".join(f"{k}={v:.4f}"
                                                        for k, v in metrics.items()))
            monitored = {f"val/{k}": v for k, v in metrics.items()}
            monitored["total_loss"] = metrics.get("total_loss", 0.0)
            self.early_stopping(iteration, monitored)
            if coll.broadcast_scalar(float(self.early_stopping.is_best)):
                self.checkpoint.save_best(self.state)
        self.checkpoint.save(self.state, iteration)
        self.checkpoint.save_final_weights(self.state, self.model_name)
        self.writer.write(f"training done @ iter {iteration}; "
                          f"early stopping: {self.early_stopping.summary()}")
        if "inference" in self.run_type or "predict" in self.run_type:
            self.inference()
