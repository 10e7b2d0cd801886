"""Checkpoints: ``torch.save`` snapshots with the JAX package's layout and
its tolerant load.

Port of ``antmmf_tpu/common/checkpoint.py``. Under ``save_dir``:

* ``models/model_<n>``: the full state at step n (``save``): the step, the
  fp32 masters (the frozen ones too, never updated) and the AdamW state
  (``count``, ``mu`` in its own dtype, ``nu``; of the trainable parameters
  only) keyed by flax path, under gradient accumulation the fp32
  accumulator ``acc`` and ``mini_step`` (so a snapshot inside an
  accumulation window resumes bit for bit), the ``torch.Generator`` state,
  and with MoCo
  the momentum towers (fp32, by flax path) and the queues (``moco``:
  ``text_queue/queue``, ``ptr``, ``filled``); ``_gc`` keeps the newest
  ``max_ckpt_num`` of them;
* ``models/best``: the same, saved when early stopping sees a new best;
* ``<model_name>_final``: the masters alone (``save_final_weights``);
* ``config.yaml`` and ``git_info.json`` (branch, commit, status).

Each file is written under a temporary name and renamed into place, so a
reader never meets half a file. Tensors are stored as they are in the
module (a Dense weight [out, in]), keyed by the flax path that
``utils.weights.flax_paths`` gives. ``restore_state`` puts a snapshot back
bit for bit and refreshes the module's compute-dtype copies from the
masters. ``load_model_weights`` is the weights-only tolerant load: leaves
whose path and shape agree are copied, the rest reported as missing,
shape-mismatched or unexpected, with ``pretrained_mapping`` prefix remaps
first, as ``merge_params_tolerant`` does; the queues and momentum towers
take part as ``moco/...`` and ``momentum/...`` leaves, as they do in the
JAX package's variables, so a MoCo checkpoint loaded into a model without
a queue reports them as unexpected; it reads the port's checkpoints
and a ``params.npz`` of ``/``-joined flax paths in flax layout (the port's
``model_dir`` format) through ``read_weights``, which needs no
``TrainState``. ``resume`` applies ``resume``, ``resume_file`` and
``restart``. ``find_weights`` and ``load_weights`` serve a trainer's
``save_dir`` (or a ``params.npz``) to a predictor.

Over ranks every rank calls ``save``: the main rank's ``fsdp`` ranks
gather the sharded masters and state onto its host in buckets
(``TrainState.host_copy``), and the main rank alone writes the whole
tensors, in the layout above; a restore reads the whole tensors and keeps
each rank's slices, so a snapshot resumes at any world size.
"""

from __future__ import annotations

import glob
import json
import os
import re
import subprocess
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from antmmf_torch.common.configuration import Configuration, convert_to_config
from antmmf_torch.modules.moco import queue_buffers
from antmmf_torch.parallel import collectives as coll
from antmmf_torch.utils.weights import flax_paths, to_torch_layout, unstack_layers


def merge_params_tolerant(target: Mapping[str, torch.Tensor], loaded: Mapping[str, Any],
                          pretrained_mapping: Optional[Mapping[str, str]] = None,
                          logger: Optional[Any] = None
                          ) -> Tuple[Dict[str, Any], Dict[str, list]]:
    """Leaves of ``loaded`` (flat, by path) whose path, after the
    ``pretrained_mapping`` prefix remaps, and shape agree with ``target``'s.
    Returns (the matched leaves, a report of loaded / missing /
    shape_mismatch / unexpected paths)."""
    if pretrained_mapping:
        remapped = {}
        for path, leaf in loaded.items():
            for src, dst in dict(pretrained_mapping).items():
                if path.startswith(src):
                    path = dst + path[len(src):]
                    break
            remapped[path] = leaf
        loaded = remapped
    report: Dict[str, list] = {"loaded": [], "missing": [], "shape_mismatch": [],
                               "unexpected": []}
    merged = {}
    for path, tleaf in target.items():
        if path not in loaded:
            report["missing"].append(path)
            continue
        shape = tuple(np.shape(loaded[path]))
        if shape != tuple(tleaf.shape):
            report["shape_mismatch"].append(f"{path}: ckpt{shape} vs model{tuple(tleaf.shape)}")
            continue
        merged[path] = loaded[path]
        report["loaded"].append(path)
    report["unexpected"] = [path for path in loaded if path not in target]
    if logger is not None:
        for kind in ("missing", "shape_mismatch", "unexpected"):
            for item in report[kind][:20]:
                logger.write(f"checkpoint partial-load {kind}: {item}", level="warning")
    return merged, report


def read_weights(path: str, shapes: Optional[Mapping[str, Any]] = None
                 ) -> Dict[str, torch.Tensor]:
    """A weights file's leaves by flax path, in the port's layouts: a port
    checkpoint's ``params`` with its ``moco/...`` and ``momentum/...``
    collections, or a ``params.npz`` of flax-layout leaves (a scanned
    decoder's stacked layers split into ``layer_{i}``; ``shapes``, the
    target parameters' shapes by flax path, tells a 4-D ``nn.Conv2d`` kernel
    from a patch convolution's)."""
    if path.endswith(".npz"):
        with np.load(path) as npz:
            flat = unstack_layers({k: npz[k] for k in npz.files})
        shapes = shapes or {}
        return {k: torch.from_numpy(to_torch_layout(k, v, shapes.get(k)))
                for k, v in flat.items()}
    tree = torch.load(path, map_location="cpu", weights_only=True)
    loaded = dict(tree["params"])
    for collection in ("moco", "momentum"):
        loaded.update({f"{collection}/{p}": t for p, t in tree.get(collection, {}).items()})
    return loaded


def _model_number(path: str) -> int:
    return int(os.path.basename(path)[len("model_"):])


def find_weights(model_dir: str) -> str:
    """The file a ``model_dir`` serves, in the JAX predictor's order: a
    trainer's ``<model_name>_final``, then ``models/best``, then the newest
    ``models/model_<n>`` by number (``model_1000`` after ``model_999``); a
    ``params.npz`` when the directory holds none of them."""
    found = (sorted(glob.glob(os.path.join(model_dir, "*_final")))
             or glob.glob(os.path.join(model_dir, "models", "best"))
             or sorted((p for p in glob.glob(os.path.join(model_dir, "models", "model_*"))
                        if re.fullmatch(r"model_\d+", os.path.basename(p))), key=_model_number)
             or glob.glob(os.path.join(model_dir, "params.npz")))
    if not found:
        raise FileNotFoundError(f"No trainer checkpoint (*_final, models/best, models/model_<n>) "
                                f"and no params.npz in model_dir {model_dir!r}")
    return found[-1]


@torch.no_grad()
def load_weights(model: torch.nn.Module, path: str) -> None:
    """Every parameter of ``model`` from ``read_weights(path)``, cast to its
    dtype and device. A missing or unused parameter leaf, or one of another
    shape, raises; a checkpoint's ``moco`` and ``momentum`` collections are
    training state and are not read."""
    paths = flax_paths(model)
    shapes = {paths[n]: p.shape for n, p in model.named_parameters()}
    loaded = {p: t for p, t in read_weights(path, shapes).items()
              if p.split("/")[0] not in ("moco", "momentum")}
    missing = sorted(p for p in paths.values() if p not in loaded)
    unused = sorted(set(loaded) - set(paths.values()))
    if missing or unused:
        raise KeyError(f"{path} does not match the model: missing {missing[:8]}, "
                       f"unused {unused[:8]}")
    for name, param in model.named_parameters():
        value = loaded[paths[name]]
        if tuple(value.shape) != tuple(param.shape):
            raise ValueError(f"{paths[name]}: shape {tuple(value.shape)} does not fit {name} "
                             f"{tuple(param.shape)}")
        param.copy_(value)


def _git_provenance(repo_dir: str) -> Dict[str, str]:
    def run(*args: str) -> str:
        try:
            return subprocess.run(["git", *args], cwd=repo_dir, capture_output=True, text=True,
                                  timeout=10).stdout.strip()
        except Exception:
            return ""

    return {"branch": run("rev-parse", "--abbrev-ref", "HEAD"),
            "commit": run("rev-parse", "HEAD"), "status": run("status", "--short")[:4000]}


def _atomic_save(obj: Any, path: str) -> None:
    tmp = f"{path}.tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


class Checkpoint:
    def __init__(self, config: Mapping, logger: Optional[Any] = None, load_only: bool = False):
        self.config = convert_to_config(config)
        tp = self.config.get("training_parameters", {})
        self.logger = logger
        self.save_dir = os.path.abspath(tp.get("save_dir", "./save"))
        self.models_dir = os.path.join(self.save_dir, "models")
        self.max_to_keep = tp.get("max_ckpt_num", None)
        if not load_only and coll.is_main_process():
            os.makedirs(self.models_dir, exist_ok=True)
            Configuration(self.config.to_dict()).save(os.path.join(self.save_dir, "config.yaml"))
            with open(os.path.join(self.save_dir, "git_info.json"), "w") as f:
                json.dump(_git_provenance(os.getcwd()), f, indent=2)

    # ------------------------------------------------------------------- save
    def _state_tree(self, state) -> Optional[Dict[str, Any]]:
        """The whole state on the host of the main rank; ``None`` on the
        others (every rank calls it: the gathers are collectives)."""
        names = flax_paths(state.model)
        opt = state.opt_state

        def whole(tensors):
            host = state.host_copy(tensors)
            return None if host is None else {names[n]: t for n, t in host.items()}

        # every rank draws from its own generator
        gens = coll.all_gather_object(state.generator.get_state()) \
            if coll.get_world_size() > 1 else None
        tree = {"step": int(state.step), "params": whole(state.params),
                "opt_state": {"count": int(opt["count"]), "mu": whole(opt["mu"]),
                              "nu": whole(opt["nu"])},
                "generator": state.generator.get_state()}
        if "acc" in opt:
            tree["opt_state"].update(acc=whole(opt["acc"]), mini_step=int(opt["mini_step"]))
        if state.momentum is not None:
            tree["momentum"] = whole(state.momentum)
        if not coll.is_main_process():
            return None
        if gens is not None:
            tree["rank_generators"] = gens
        queues = queue_buffers(state.model)
        if queues:
            tree["moco"] = {p: t.detach().to("cpu", copy=True) for p, t in queues.items()}
        return tree

    def save(self, state, iteration: Optional[int] = None, tag: Optional[str] = None) -> str:
        """Every rank calls it; the main rank writes."""
        iteration = int(iteration if iteration is not None else state.step)
        path = os.path.join(self.models_dir, tag or f"model_{iteration}")
        tree = self._state_tree(state)
        if tree is not None:
            _atomic_save(tree, path)
            if tag is None:
                self._gc()
        coll.synchronize()
        return path

    def save_best(self, state) -> str:
        return self.save(state, tag="best")

    def save_final_weights(self, state, model_name: str = "model") -> str:
        path = os.path.join(self.save_dir, f"{model_name}_final")
        params = state.host_copy(state.params)
        if params is not None:
            names = flax_paths(state.model)
            _atomic_save({"params": {names[n]: t for n, t in params.items()}}, path)
        coll.synchronize()
        return path

    def _gc(self) -> None:
        if not self.max_to_keep:
            return
        nums = {int(m.group(1)): d for d in os.listdir(self.models_dir)
                if (m := re.fullmatch(r"model_(\d+)", d))}
        for n in sorted(nums)[:-int(self.max_to_keep)]:
            os.remove(os.path.join(self.models_dir, nums[n]))

    # ---------------------------------------------------------------- restore
    def latest_path(self) -> Optional[str]:
        if not os.path.isdir(self.models_dir):
            return None
        nums = {int(m.group(1)): d for d in os.listdir(self.models_dir)
                if (m := re.fullmatch(r"model_(\d+)", d))}
        return os.path.join(self.models_dir, nums[max(nums)]) if nums else None

    @torch.no_grad()
    def restore_state(self, state, path: Optional[str] = None):
        """Full resume, bit for bit: step, masters, AdamW state (with the
        accumulator), generator, and the queues and momentum towers of a
        MoCo state."""
        path = path or self.latest_path()
        if path is None:
            return state, False
        tree = torch.load(path, map_location="cpu", weights_only=True)
        names = flax_paths(state.model)
        opt = state.opt_state
        trees = [("params", state.params), ("mu", opt["mu"]), ("nu", opt["nu"])]
        if "acc" in opt:
            trees.append(("acc", opt["acc"]))
            opt["mini_step"] = tree["opt_state"]["mini_step"]
        for name, dst in trees:
            src = tree["params"] if name == "params" else tree["opt_state"][name]
            for n, t in dst.items():
                t.copy_(state.local(n, src[names[n]]))
        for p, t in queue_buffers(state.model).items():
            t.copy_(tree["moco"][p])
        if state.momentum is not None:
            for n, t in state.momentum.items():
                t.copy_(state.local(n, tree["momentum"][names[n]]))
            state.sync_key_module()
        opt["count"] = tree["opt_state"]["count"]
        state.step = tree["step"]
        gens, world = tree.get("rank_generators"), coll.get_world_size()
        if gens is not None and len(gens) == world:
            state.generator.set_state(gens[coll.get_rank()])
        else:
            state.generator.set_state(tree["generator"])
            if world > 1:
                # another world size: a generator of this rank's own from here
                state.generator.manual_seed(coll.rank_seed(int(tree["step"]), coll.get_rank()))
        state.sync_model(frozen=True)
        return state, True

    @torch.no_grad()
    def load_model_weights(self, state, path: str,
                           pretrained_mapping: Optional[Mapping[str, str]] = None):
        """Weights-only tolerant load (the restart / finetune path) from a
        port checkpoint or a ``params.npz`` of flax-layout leaves."""
        names = flax_paths(state.model)
        # the whole tensors (gathered over the fsdp ranks), sliced back after
        params = state.gathered(state.params)
        target = {names[n]: t for n, t in params.items()}
        loaded = read_weights(path, {p: t.shape for p, t in target.items()})
        target.update({f"moco/{p}": t for p, t in queue_buffers(state.model).items()})
        momentum = state.gathered(state.momentum) if state.momentum is not None else {}
        target.update({f"momentum/{names[n]}": t for n, t in momentum.items()})
        merged, report = merge_params_tolerant(target, loaded, pretrained_mapping, self.logger)
        for leaf_path, value in merged.items():
            target[leaf_path].copy_(value)
        for mine, whole in ((state.params, params), (state.momentum or {}, momentum)):
            for n, t in mine.items():
                if whole[n] is not t:
                    t.copy_(state.local(n, whole[n]))
        if state.momentum is not None:
            state.sync_key_module()
        state.sync_model(frozen=True)
        return state, report

    def resume(self, state, tp: Optional[Mapping] = None):
        """Apply the resume / resume_file / restart flags."""
        tp = convert_to_config(tp if tp is not None
                               else self.config.get("training_parameters", {}))
        resume_file = tp.get("resume_file")
        if resume_file:
            if bool(tp.get("restart", False)):
                state, report = self.load_model_weights(
                    state, resume_file, tp.get("pretrained_mapping") or None)
                return state, {"mode": "restart", **{k: len(v) for k, v in report.items()}}
            state, ok = self.restore_state(state, resume_file)
            return state, {"mode": "resume_file", "ok": ok}
        if bool(tp.get("resume", False)):
            state, ok = self.restore_state(state)
            return state, {"mode": "resume", "ok": ok}
        return state, {"mode": "none"}
