"""``univl_roi`` through the port's trainer against the JAX trainer, on the CPU.

One JAX ``BaseTrainer`` run on ``roi_pretrain.local.yml`` (seed 1, 4 steps,
log every step, full validation every 2) against ``antmmf_torch.run`` on
the same config, restarted from the JAX initial parameters written as a
flax-path ``params.npz``. Both read the fixture's 4 documents with the
same region masking, ITM swaps and MLM masking (bit for bit,
``test_torch_roi_data.py``). flax draws its dropout from its rng stream,
which torch cannot reproduce, so the region encoder's dropout (rate 0.1,
the only dropout this config trains with) is set to 0 on both sides by
replacing the module-level ``ImageFeatureEncoder`` name of each package's
``univl_roi`` module; nothing else changes. Checks: each logged train and
val loss term, metric and ``total_loss`` at atol 1e-4 (fp32 sums in
another order, compounded by the updates); each full validation's scalars
at atol 1e-4 and the same best iteration.

The port with its dropout on is run twice from the same seed: the losses
repeat bit for bit (its masks come from the trainer's generator), differ
from the rate-0 run's, and a resume from ``model_4`` restores the state
bit for bit.
"""

import functools
import os

import jax
import numpy as np
import pytest
import torch

from antmmf_torch import run
from antmmf_torch.common.build import build_config as t_build_config
from antmmf_torch.models import univl_roi as t_roi
from antmmf_torch.trainers.build import build_trainer as t_build_trainer
from antmmf_torch.utils.weights import flatten_flax
from antmmf_tpu.common.build import build_config as j_build_config
from antmmf_tpu.models import univl_roi as j_roi
from antmmf_tpu.trainers.build import build_trainer as j_build_trainer
from test_torch_task_trainer import _record_validations, one_torch_thread  # noqa: F401
from test_torch_trainer import jax_saves_skipped, jitted_jax_init

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = os.path.join(REPO, "projects", "base_vtp", "configs", "roi_pretrain.local.yml")
STEPS, LOSS_ATOL = 4, 1e-4
OPTS = ["training_parameters.seed", "1", "training_parameters.max_iterations", str(STEPS),
        "training_parameters.log_interval", "1", "training_parameters.snapshot_interval", "2",
        "training_parameters.num_workers", "0"]
TERMS = ("itm_loss", "masked_lm_loss", "masked_region_classification")
METRICS = ("itm_acc", "masked_lm_acc", "mrc_acc")


class _JaxNoDropout(j_roi.ImageFeatureEncoder):
    dropout: float = 0.0


def _port(save_dir, *extra):
    trainer = {}
    real_build = run.build_trainer

    def build_trainer(config):  # keep the port's trainer to read its meters
        trainer["port"] = real_build(config)
        trainer["vals"] = _record_validations(trainer["port"])
        return trainer["port"]

    run.build_trainer = build_trainer
    try:
        run.main(["--config", CFG, *OPTS, "training_parameters.save_dir", save_dir,
                  "training_parameters.device", "cpu", *extra])
    finally:
        run.build_trainer = real_build
    return trainer["port"], trainer["vals"]


def _losses(trainer):
    return list(trainer.meter.meters["train/total_loss"].deque)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    jdir, tdir, d1, d2 = (str(tmp_path_factory.mktemp(n))
                          for n in ("jax", "port", "drop1", "drop2"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_roi, "ImageFeatureEncoder", _JaxNoDropout)
        mp.setattr(t_roi, "ImageFeatureEncoder",
                   functools.partial(t_roi.ImageFeatureEncoder, dropout=0.0))
        jt = j_build_trainer(j_build_config(CFG, opts=OPTS + ["training_parameters.save_dir",
                                                              jdir]))
        with jitted_jax_init():
            jt.load()
        npz = os.path.join(jdir, "params.npz")
        np.savez(npz, **flatten_flax(jax.device_get(jt.state.variables["params"])))
        j_vals = _record_validations(jt)
        with jax_saves_skipped():
            jt.train()
        port, t_vals = _port(tdir, "training_parameters.restart", "true",
                             "training_parameters.resume_file", npz)
    drop = [_port(d, "training_parameters.restart", "true",
                  "training_parameters.resume_file", npz)[0] for d in (d1, d2)]
    return dict(jax=jt, port=port, j_vals=j_vals, t_vals=t_vals, drop=drop, drop_dir=d1)


def test_trainer_scalars_match_jax_step_for_step(runs):
    keys = [f"{split}/{k}" for split in ("train", "val")
            for k in [f"losses/{t}" for t in TERMS] + [f"metrics/{m}" for m in METRICS]
            + ["total_loss"]]
    port, ref = runs["port"].meter.meters, runs["jax"].meter.meters
    assert set(keys) <= set(ref) and set(keys) <= set(port)
    for key in keys:
        got, want = list(port[key].deque), list(ref[key].deque)
        assert len(got) == len(want) == STEPS, key
        np.testing.assert_allclose(got, want, atol=LOSS_ATOL, rtol=0, err_msg=key)
    assert runs["port"].state.step == STEPS
    assert all(v > 0 for v in port["train/losses/masked_region_classification"].deque)


def test_full_validations_and_best_match_jax(runs):
    j_vals, t_vals = runs["j_vals"], runs["t_vals"]
    assert [d for d, _ in t_vals] == [d for d, _ in j_vals]
    for (_, j), (_, t) in zip(j_vals, t_vals):
        assert sorted(t) == sorted(j)
        for key in j:
            assert abs(t[key] - j[key]) <= LOSS_ATOL, key
    je, te = runs["jax"].early_stopping, runs["port"].early_stopping
    assert te.monitored_metric == je.monitored_metric == "val/total_loss"
    assert te.best_iteration == je.best_iteration


def test_region_dropout_repeats_bit_for_bit(runs):
    """Two runs with the region encoder's dropout on give the same losses,
    bit for bit; the dropout moves them off the rate-0 run's after the
    first step's identical init."""
    first, second = (_losses(t) for t in runs["drop"])
    assert first == second and len(first) == STEPS
    assert first != _losses(runs["port"])
    encoder = runs["drop"][0].shell.module.region_encoder
    assert encoder.dropout.rate == 0.1
    assert runs["port"].shell.module.region_encoder.dropout.rate == 0.0


def test_resume_from_model_4_is_bit_for_bit(runs):
    ref = runs["drop"][0]
    t = t_build_trainer(t_build_config(CFG, opts=OPTS + [
        "training_parameters.save_dir", runs["drop_dir"], "training_parameters.device", "cpu",
        "training_parameters.resume_file", os.path.join(runs["drop_dir"], "models", "model_4")]))
    t.load()
    assert t.state.step == ref.state.step == STEPS
    for name, value in ref.state.params.items():
        assert torch.equal(t.state.params[name], value), name
    for k in ("mu", "nu"):
        for name, value in ref.state.opt_state[k].items():
            assert torch.equal(t.state.opt_state[k][name], value), (k, name)
    assert torch.equal(t.state.generator.get_state(), ref.state.generator.get_state())
