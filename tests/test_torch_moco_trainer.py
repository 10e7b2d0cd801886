"""The port's trainer with MoCo against the JAX trainer, on the CPU.

* The trainer on ``video_retrieval_moco.local.yml`` (momentum towers at
  μ 0.99, queues of 64 filled with random rows; seed 1, 6 steps, log every
  step) against one JAX ``BaseTrainer`` run, the port started from JAX's
  initial params (``restart`` from a ``params.npz``), momentum towers and
  queues (``load_flax_variables``): each step's train and val loss at atol
  1e-4; after the run the momentum towers at atol 1e-6, the queues at atol
  1e-5, ``ptr`` and ``filled`` exactly (6 · 4 keys into 64 slots); the key
  module holds the momentum towers' values.
* Resuming from ``model_4`` restores the momentum towers, the key module's
  copies and the queues bit for bit; the tolerant ``restart`` of that
  checkpoint into a model without a queue or momentum reports every
  ``moco/`` and ``momentum/`` leaf as unexpected, and loads every parameter.
"""

import os

import jax
import numpy as np
import pytest
import torch

from antmmf_torch.common.build import build_config as t_build_config
from antmmf_torch.modules import moco as t_moco
from antmmf_torch.trainers.build import build_trainer as t_build_trainer
from antmmf_torch.utils.weights import (
    export_flax_variables,
    flatten_flax,
    flax_paths,
    load_flax_variables,
)
from antmmf_tpu.common.build import build_config as j_build_config
from antmmf_tpu.trainers.build import build_trainer as j_build_trainer
from test_torch_trainer import jax_saves_skipped, jitted_jax_init

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = os.path.join(REPO, "projects", "base_vtp", "configs", "video_retrieval_moco.local.yml")
LOSS_ATOL, MOMENTUM_ATOL, QUEUE_ATOL = 1e-4, 1e-6, 1e-5
STEPS = 6
OPTS = ["training_parameters.seed", "1", "training_parameters.max_iterations", str(STEPS),
        "training_parameters.log_interval", "1", "training_parameters.snapshot_interval", "4"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the port's side: the suite runs several test
    processes side by side, whose thread pools would contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    jdir, tdir = (str(tmp_path_factory.mktemp(n)) for n in ("jax", "port"))
    jt = j_build_trainer(j_build_config(CFG, opts=OPTS + ["training_parameters.save_dir", jdir]))
    with jitted_jax_init():
        jt.load()
    init = jax.device_get(jt.state.variables)
    npz = os.path.join(jdir, "params.npz")
    np.savez(npz, **flatten_flax(init["params"]))
    with jax_saves_skipped():
        jt.train()
    final = jax.device_get(jt.state.variables)

    tt = t_build_trainer(t_build_config(CFG, opts=OPTS + [
        "training_parameters.save_dir", tdir, "training_parameters.device", "cpu",
        "training_parameters.restart", "true", "training_parameters.resume_file", npz]))
    tt.load()
    load_flax_variables(tt.shell.module, {"moco": init["moco"], "momentum": init["momentum"]},
                        tt.state)
    saved = {}
    real_save = tt.checkpoint.save

    def save(state, iteration=None, tag=None):
        if iteration == 4:
            saved["momentum"] = {n: t.clone() for n, t in state.momentum.items()}
            saved["queues"] = {k: v.clone() for k, v in
                               t_moco.queue_buffers(state.model).items()}
        return real_save(state, iteration, tag)

    tt.checkpoint.save = save
    tt.train()
    return dict(jax=jt, port=tt, final=final, saved=saved, port_dir=tdir)


def _series(trainer, key):
    return list(trainer.meter.meters[key].deque)


@pytest.mark.parametrize("key", ["train/total_loss", "val/total_loss"])
def test_trainer_losses_match_jax(runs, key):
    np.testing.assert_allclose(_series(runs["port"], key), _series(runs["jax"], key),
                               atol=LOSS_ATOL, rtol=0)


def test_trainer_momentum_and_queues_match_jax(runs):
    port = runs["port"]
    exported = export_flax_variables(port.shell.module, port.state)
    assert port.state.step == STEPS
    j_mom, t_mom = flatten_flax(runs["final"]["momentum"]), flatten_flax(exported["momentum"])
    assert sorted(t_mom) == sorted(j_mom)
    for path, ref in j_mom.items():
        np.testing.assert_allclose(t_mom[path], ref, atol=MOMENTUM_ATOL, rtol=0, err_msg=path)
    j_q, t_q = flatten_flax(runs["final"]["moco"]), flatten_flax(exported["moco"])
    assert sorted(t_q) == sorted(j_q)
    for path, ref in j_q.items():
        if path.endswith("queue"):
            np.testing.assert_allclose(t_q[path], ref, atol=QUEUE_ATOL, rtol=0, err_msg=path)
        else:  # 4 keys a step into 64 slots of a random (full) queue
            expected = (STEPS * 4) % 64 if path.endswith("ptr") else 64
            assert int(t_q[path]) == int(ref) == expected, path


def test_key_module_holds_the_momentum_towers(runs):
    state = runs["port"].state
    key = dict(state.key_module.named_parameters())
    for name, m in state.momentum.items():
        assert torch.equal(key[name.split(".", 1)[1]].detach(), m), name


def test_resume_restores_moco_state_bit_for_bit(runs):
    t = t_build_trainer(t_build_config(CFG, opts=OPTS + [
        "training_parameters.save_dir", runs["port_dir"], "training_parameters.device", "cpu",
        "training_parameters.resume_file", os.path.join(runs["port_dir"], "models", "model_4")]))
    t.load()
    assert t.state.step == 4
    for name, ref in runs["saved"]["momentum"].items():
        assert torch.equal(t.state.momentum[name], ref), name
    key = dict(t.state.key_module.named_parameters())
    assert all(torch.equal(key[n.split(".", 1)[1]].detach(), m)
               for n, m in t.state.momentum.items())
    for path, ref in t_moco.queue_buffers(t.shell.module).items():
        assert torch.equal(ref, runs["saved"]["queues"][path]), path


def test_restart_into_a_model_without_moco_reports_unused_leaves(runs, tmp_path):
    cfg = t_build_config(CFG, opts=["training_parameters.save_dir", str(tmp_path),
                                    "training_parameters.device", "cpu",
                                    "model_attributes.univl_retrieval.with_queue", "false",
                                    "model_attributes.univl_retrieval.with_momentum", "false"])
    t = t_build_trainer(cfg)
    t.load()
    _, report = t.checkpoint.load_model_weights(
        t.state, os.path.join(runs["port_dir"], "models", "model_4"))
    state = runs["port"].state
    expected = {f"moco/{p}" for p in t_moco.queue_buffers(state.model)}
    expected |= {f"momentum/{flax_paths(state.model)[n]}" for n in state.momentum}
    assert set(report["unexpected"]) == expected
    assert not report["missing"] and not report["shape_mismatch"]
    assert len(report["loaded"]) == len(t.state.params)
