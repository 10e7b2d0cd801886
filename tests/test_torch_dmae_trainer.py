"""The port's ``retrieval_trainer`` on DMAE against the JAX trainer, on the CPU.

One JAX ``RetrievalTrainer`` run on ``msrvtt_retrieval.local.yml`` (seed 1,
4 steps, log every step, full validation at step 4) and the port's trainer
on the same config, restarted from the JAX trainer's initial parameters
(``restart`` from a ``params.npz``), reading the same fixture videos:

* each step's train and val loss terms and total at atol 1e-4;
* every corpus evaluation (the full validation at step 4, the final one
  and the test inference): the L1 and L3 recalls (R@1/5/10, median and mean
  rank both ways, ``mean_recall``, ``l3_simi_t2v-mean_recall``) exactly;
* early stopping monitors ``val/l3_simi_t2v-mean_recall`` and ends with the
  JAX trainer's best value and iteration; ``best`` is saved.
"""

import os

import jax
import numpy as np
import pytest
import torch

from antmmf_torch.common.build import build_config as t_build_config
from antmmf_torch.trainers.build import build_trainer as t_build_trainer
from antmmf_torch.trainers.retrieval_trainer import RetrievalTrainer as TRetrieval
from antmmf_torch.utils.weights import flatten_flax
from antmmf_tpu.common.build import build_config as j_build_config
from antmmf_tpu.trainers.build import build_trainer as j_build_trainer
from test_torch_trainer import jax_saves_skipped, jitted_jax_init

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = os.path.join(REPO, "projects", "dmae_vtp", "configs", "msrvtt_retrieval.local.yml")
LOSS_ATOL = 1e-4
OPTS = ["training_parameters.seed", "1", "training_parameters.log_interval", "1"]
RECALL_KEYS = [f"{lvl}_simi_{d}-{m}" for lvl in ("l1", "l3") for d in ("t2v", "v2t")
               for m in ("r@1", "r@5", "r@10", "median_rank", "mean_rank")] + \
    ["mean_recall", "l3_simi_t2v-mean_recall"]


def _record(trainer):
    results, real = [], trainer.evaluate_set

    def evaluate_set(dataset_type="val"):
        results.append((dataset_type, real(dataset_type)))
        return results[-1][1]

    trainer.evaluate_set = evaluate_set
    return results


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
    npz = os.path.join(jdir, "params.npz")
    np.savez(npz, **flatten_flax(jax.device_get(jt.state.variables["params"])))
    j_vals = _record(jt)
    with jax_saves_skipped():
        jt.train()
    tt = t_build_trainer(t_build_config(CFG, opts=OPTS + [
        "training_parameters.save_dir", tdir, "training_parameters.device", "cpu",
        "training_parameters.restart", "true", "training_parameters.resume_file", npz]))
    tt.load()
    t_vals = _record(tt)
    tt.train()
    return dict(jax=jt, port=tt, j_vals=j_vals, t_vals=t_vals, port_dir=tdir)


def test_the_port_builds_its_retrieval_trainer(runs):
    assert type(runs["port"]) is TRetrieval
    assert runs["port"].resume_info["missing"] == 0 == runs["port"].resume_info["unexpected"]


@pytest.mark.parametrize("key", ["total_loss", "losses/level1_similarity_loss",
                                 "losses/level3_similarity_loss"])
@pytest.mark.parametrize("split", ["train", "val"])
def test_step_losses_match_jax(runs, split, key):
    t = list(runs["port"].meter.meters[f"{split}/{key}"].deque)
    j = list(runs["jax"].meter.meters[f"{split}/{key}"].deque)
    assert len(t) == len(j) == 4
    np.testing.assert_allclose(t, j, atol=LOSS_ATOL, rtol=0)


def test_corpus_recalls_match_jax_exactly(runs):
    j_vals, t_vals = runs["j_vals"], runs["t_vals"]
    assert [d for d, _ in t_vals] == [d for d, _ in j_vals] == ["val", "val", "test"]
    for (_, j), (_, t) in zip(j_vals, t_vals):
        assert sorted(t) == sorted(j)
        assert {k: t[k] for k in RECALL_KEYS} == {k: j[k] for k in RECALL_KEYS}


def test_early_stopping_on_the_l3_metric(runs):
    t, j = runs["port"].early_stopping.summary(), runs["jax"].early_stopping.summary()
    assert t["metric"] == "val/l3_simi_t2v-mean_recall"
    assert t == j
    assert os.path.exists(os.path.join(runs["port_dir"], "models", "best"))
