"""Pink instruction tuning through the port's trainer against the JAX
trainer, on the CPU.

One JAX ``BaseTrainer`` run on ``pink_instruct.local.yml`` (seed 5, 6
iterations, logged every iteration, the full validation at 6) against
``antmmf_torch.run`` on the same config, restarted from the JAX initial
parameters written as a flax-path ``params.npz``. Both read the fixture's
interleaved sources bit for bit (``test_torch_pink_data.py``). Checks: each
logged train and val ``lm_loss`` and ``total_loss`` at atol 1e-4 (fp32
sums in another order, compounded by the updates), the global norm of the
unclipped gradients at atol 1e-3 (every parameter takes part on both sides:
the q/v base kernels' gradients are zero in JAX and absent in the port),
the logged lr, the full validations and the best iteration. This config
freezes nothing through ``frozen_params`` and trains at weight decay 0,
where the two packages agree on the stop-gradiented base kernels
(``test_torch_pink_train.py`` shows where they part). The loss falls.
"""

import os

import jax
import numpy as np
import pytest

from antmmf_torch import run
from antmmf_torch.utils.weights import flatten_flax
from antmmf_tpu.common.build import build_config as j_build_config
from antmmf_tpu.trainers.build import build_trainer as j_build_trainer
from test_torch_task_trainer import _record_validations, one_torch_thread  # noqa: F401
from test_torch_trainer import jax_saves_skipped, jitted_jax_init

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = os.path.join(REPO, "projects", "pink", "configs", "pink_instruct.local.yml")
STEPS, LOSS_ATOL, NORM_ATOL = 6, 1e-4, 1e-3
OPTS = ["training_parameters.seed", "5", "training_parameters.log_interval", "1",
        "training_parameters.num_workers", "0"]
KEYS = [f"{split}/{k}" for split in ("train", "val") for k in ("losses/lm_loss", "total_loss")]


def port_run(save_dir, *extra):
    """``antmmf_torch.run.main`` on the config at ``save_dir`` on the CPU;
    returns the trainer and its full validations."""
    held = {}
    real_build = run.build_trainer

    def build_trainer(config):  # keep the port's trainer to read its meters
        held["port"] = real_build(config)
        held["vals"] = _record_validations(held["port"])
        return held["port"]

    run.build_trainer = build_trainer
    try:
        run.main(["--config", CFG, *OPTS, *extra, "training_parameters.save_dir", save_dir,
                  "training_parameters.device", "cpu"])
    finally:
        run.build_trainer = real_build
    return held["port"], held["vals"]


def trainer_runs(tmp_path_factory, *extra, port_extra=()):
    """The JAX trainer's run and the port's, restarted from JAX's initial
    parameters, with the overrides ``extra`` on both and ``port_extra`` on
    the port's alone."""
    jdir, tdir = (str(tmp_path_factory.mktemp(n)) for n in ("jax", "port"))
    jt = j_build_trainer(j_build_config(CFG, opts=OPTS + list(extra)
                                        + ["training_parameters.save_dir", jdir]))
    with jitted_jax_init():
        jt.load()
    npz = os.path.join(jdir, "params.npz")
    np.savez(npz, **flatten_flax(jax.device_get(jt.state.variables["params"])))
    j_vals = _record_validations(jt)
    with jax_saves_skipped():
        jt.train()
    port, t_vals = port_run(tdir, *extra, *port_extra, "training_parameters.restart", "true",
                            "training_parameters.resume_file", npz)
    return dict(jax=jt, port=port, j_vals=j_vals, t_vals=t_vals, npz=npz)


def check_step_for_step(runs):
    port, ref = runs["port"].meter.meters, runs["jax"].meter.meters
    assert set(KEYS + ["lr"]) <= set(ref) and set(KEYS + ["lr"]) <= set(port)
    for key in KEYS:
        got, want = list(port[key].deque), list(ref[key].deque)
        assert len(got) == len(want) == STEPS, key
        np.testing.assert_allclose(got, want, atol=LOSS_ATOL, rtol=0, err_msg=key)
    np.testing.assert_allclose(list(port["lr"].deque), list(ref["lr"].deque), rtol=1e-7)
    assert runs["port"].state.step == STEPS


def check_validations(runs, best=True):
    j_vals, t_vals = runs["j_vals"], runs["t_vals"]
    assert [d for d, _ in t_vals] == [d for d, _ in j_vals]
    for (_, j), (_, t) in zip(j_vals, t_vals):
        assert sorted(t) == sorted(j)
        for key in j:
            assert abs(t[key] - j[key]) <= LOSS_ATOL, key
    if not best:
        return
    je, te = runs["jax"].early_stopping, runs["port"].early_stopping
    assert te.monitored_metric == je.monitored_metric
    assert te.best_iteration == je.best_iteration


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return trainer_runs(tmp_path_factory)


def test_trainer_scalars_match_jax_step_for_step(runs):
    check_step_for_step(runs)
    port, ref = runs["port"].meter.meters, runs["jax"].meter.meters
    np.testing.assert_allclose(list(port["train/grad_norm"].deque),
                               list(ref["train/grad_norm"].deque), atol=NORM_ATOL, rtol=0)


def test_full_validations_and_best_match_jax(runs):
    check_validations(runs)
    val = [m["total_loss"] for d, m in runs["t_vals"] if d == "val"]
    assert len(val) == 2 and val[-1] < list(runs["port"].meter.meters["val/total_loss"].deque)[0]


def test_every_parameter_trains_but_the_frozen_base(runs):
    state = runs["port"].state
    frozen = sorted(set(state.params) - set(state.trainable))
    assert frozen == sorted(
        [f"decoder.layer_{i}.attention.{x}_proj.weight" for i in range(2) for x in "qv"]
        + ["output_adapter.base.weight", "output_adapter.base.bias"])
    assert sorted(state.opt_state["mu"]) == sorted(state.trainable)
    assert "acc" not in state.opt_state  # no accumulation configured
