"""The task heads through the port's trainer against the JAX trainer, on the CPU.

``trainer_runs(model)``: ``video_retrieval.local.yml`` with the model
overridden (``model_class``) to ``univl_caption`` (2 decoder layers of 8
heads, the ``captioning`` evaluator, which scores nothing: neither trainer
generates during validation), ``univl_classification`` (4 labels, the
fixture's ``label`` as ``targets``; the retrieval evaluator reads its
embeddings) or ``univl_mcqa`` (the ``video_mcqa`` dataset on the
multiple-choice fixture, B=2 on a data axis of 2, no evaluator). One JAX
``BaseTrainer`` run (seed 1, 4 steps, log every step, full validation every
2) against ``antmmf_torch.run``'s trainer on the same config on the CPU,
restarted from the JAX initial parameters written as a flax-path
``params.npz``: each logged train and val loss term, metric and
``total_loss`` at atol 1e-4 (fp32 sums in another order, compounded by the
updates); each full validation's scalars at atol 1e-4, and the same best
iteration.

This file runs ``univl_caption``; ``test_torch_cls_trainer.py`` and
``test_torch_mcqa_trainer.py`` run the other two with these helpers (one
JAX trainer run a file).
"""

import os

import jax
import numpy as np
import pytest
import torch

from antmmf_torch import run
from antmmf_torch.utils.weights import flatten_flax
from antmmf_tpu.common.build import build_config as j_build_config
from antmmf_tpu.trainers.build import build_trainer as j_build_trainer
from test_torch_trainer import jax_saves_skipped, jitted_jax_init

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = os.path.join(REPO, "projects", "base_vtp", "configs", "video_retrieval.local.yml")
STEPS, LOSS_ATOL = 4, 1e-4
MODEL = "model_attributes.univl_retrieval"
TASK = "task_attributes.univl_task"
MCQA = f"{TASK}.dataset_attributes.video_mcqa"
OPTS = ["training_parameters.seed", "1", "training_parameters.max_iterations", str(STEPS),
        "training_parameters.log_interval", "1", "training_parameters.snapshot_interval", "2",
        "training_parameters.num_workers", "0"]
CASES = {
    "univl_caption": ([f"{MODEL}.decoder_layers", "2", f"{MODEL}.decoder_heads", "8",
                       "training_parameters.evaluator", "captioning"],
                      ("caption_cross_entropy",), ("caption_token_acc",)),
    "univl_classification": ([f"{MODEL}.num_labels", "4"], ("cls_loss",), ("cls_acc",)),
    "univl_mcqa": ([f"{TASK}.datasets", "['video_mcqa']", f"{MCQA}.data_root_dir",
                    "tests/data/video", f"{MCQA}.annotations",
                    "{'train': 'msrvtt_multi_choice_qa.jsonl'}", f"{MCQA}.video_root", "data/mp4",
                    f"{MCQA}.frames_per_clip", "2", f"{MCQA}.image",
                    "{'size': 64, 'resize': 72, 'norm_preset': 'clip'}",
                    "training_parameters.batch_size", "2",
                    "training_parameters.test_batch_size", "2",
                    "training_parameters.mesh", "{'data': 2, 'model': 4}",
                    "training_parameters.evaluator", "null"],
                   ("mcqa_loss",), ("mcqa_acc",)),
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the port's side: the suite runs several test
    processes side by side, whose thread pools would contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _record_validations(trainer):
    results, real = [], trainer.evaluate_set

    def evaluate_set(dataset_type="val"):
        results.append((dataset_type, real(dataset_type)))
        return results[-1][1]

    trainer.evaluate_set = evaluate_set
    return results


def trainer_runs(model, tmp_path_factory):
    """The JAX trainer's run and the port's on ``model``'s case."""
    opts = OPTS + [f"{MODEL}.model_class", model] + CASES[model][0]
    jdir, tdir = (str(tmp_path_factory.mktemp(n)) for n in ("jax", "port"))
    jt = j_build_trainer(j_build_config(CFG, opts=opts + ["training_parameters.save_dir", jdir]))
    with jitted_jax_init():
        jt.load()
    npz = os.path.join(jdir, "params.npz")
    np.savez(npz, **flatten_flax(jax.device_get(jt.state.variables["params"])))
    j_vals = _record_validations(jt)
    with jax_saves_skipped():
        jt.train()
    trainer = {}
    real_build = run.build_trainer

    def build_trainer(config):  # keep the port's trainer to read its meters
        trainer["port"] = real_build(config)
        trainer["vals"] = _record_validations(trainer["port"])
        return trainer["port"]

    run.build_trainer = build_trainer
    try:
        run.main(["--config", CFG, *opts, "training_parameters.save_dir", tdir,
                  "training_parameters.device", "cpu", "training_parameters.restart", "true",
                  "training_parameters.resume_file", npz])
    finally:
        run.build_trainer = real_build
    return dict(model=model, jax=jt, port=trainer["port"], j_vals=j_vals, t_vals=trainer["vals"])


def check_step_for_step(runs):
    _, losses, metrics = CASES[runs["model"]]
    keys = [f"{split}/{k}" for split in ("train", "val")
            for k in [f"losses/{t}" for t in losses] + [f"metrics/{m}" for m in metrics]
            + ["total_loss"]]
    port, ref = runs["port"].meter.meters, runs["jax"].meter.meters
    assert set(keys) <= set(ref) and set(keys) <= set(port)
    for key in keys:
        got, want = list(port[key].deque), list(ref[key].deque)
        assert len(got) == len(want) == STEPS, key
        np.testing.assert_allclose(got, want, atol=LOSS_ATOL, rtol=0, err_msg=key)
    assert runs["port"].state.step == STEPS


def check_validations(runs):
    j_vals, t_vals = runs["j_vals"], runs["t_vals"]
    assert [d for d, _ in t_vals] == [d for d, _ in j_vals]
    for (_, j), (_, t) in zip(j_vals, t_vals):
        assert sorted(t) == sorted(j)
        for key in j:
            assert abs(t[key] - j[key]) <= LOSS_ATOL, key
    je, te = runs["jax"].early_stopping, runs["port"].early_stopping
    assert te.monitored_metric == je.monitored_metric
    assert te.best_iteration == je.best_iteration


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return trainer_runs("univl_caption", tmp_path_factory)


def test_trainer_scalars_match_jax_step_for_step(runs):
    check_step_for_step(runs)


def test_full_validations_and_best_match_jax(runs):
    """The captioning evaluator collects nothing from the forward."""
    check_validations(runs)
    assert all("bleu4" not in m for _, m in runs["t_vals"])
