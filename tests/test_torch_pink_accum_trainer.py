"""Pink instruction tuning with ``gradient_accumulation_steps`` 2, the clip
on and ``pink_7b.yml``'s ``frozen_params``, through the port's trainer
against the JAX trainer, on the CPU; and a resume from a snapshot inside
an accumulation window, bit for bit.

The JAX run and the port's as in ``test_torch_pink_trainer.py`` (same
tolerances) with those three overrides on both. The port's logged
``grad_norm`` covers the trainable parameters only (the norm the clip
reads), JAX's every leaf, frozen ones included, so the port's is the
smaller. The port's run saves a snapshot every iteration: ``model_3`` holds
a state one micro-step into the second window (``mini_step`` 1). A fresh
trainer resumed from it holds that state; one step of the trainer on the
batch that iteration 4 read closes the window and gives ``model_4``'s
state bit for bit (masters, moments, accumulator, counts, generator).
"""

import os

import pytest
import torch

from antmmf_torch.common.build import build_config as t_build_config
from antmmf_torch.trainers import base_trainer as t_base_trainer
from antmmf_torch.trainers.build import build_trainer as t_build_trainer
from test_torch_pink_trainer import CFG, OPTS, check_step_for_step, check_validations, \
    trainer_runs
from test_torch_task_trainer import one_torch_thread  # noqa: F401

PINK_7B = "projects/pink/configs/pink_7b.yml"


def _frozen():
    return str(list(t_build_config(PINK_7B)["optimizer_attributes"]["frozen_params"]))


ACCUM = ["training_parameters.gradient_accumulation_steps", "2",
         "training_parameters.clip_gradients", "true",
         "optimizer_attributes.frozen_params", _frozen()]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    batches = []
    real = t_base_trainer.make_train_step

    def recording(shell, tx, momentum=0.0):  # each iteration's batch, for the resume
        step = real(shell, tx, momentum)

        def train_step(state, batch):
            batches.append({k: v.clone() for k, v in batch.items()})
            return step(state, batch)

        return train_step

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(t_base_trainer, "make_train_step", recording)
        out = trainer_runs(tmp_path_factory, *ACCUM,
                           port_extra=("training_parameters.snapshot_interval", "1"))
    out["batches"] = batches
    return out


def test_trainer_scalars_match_jax_step_for_step(runs):
    check_step_for_step(runs)
    port, ref = runs["port"].meter.meters, runs["jax"].meter.meters
    assert all(t < j for t, j in zip(port["train/grad_norm"].deque, ref["train/grad_norm"].deque))


def test_full_validations_match_jax(runs):
    """The port validates at every snapshot (interval 1), JAX at 6 (its
    default interval): the port's last validations are held to JAX's."""
    j_vals, t_vals = runs["j_vals"], runs["t_vals"]
    assert len(t_vals) == len(j_vals) + 5
    check_validations(dict(runs, t_vals=t_vals[5:]), best=False)


def test_only_the_trainable_parameters_hold_state(runs):
    state = runs["port"].state
    trainable = [n for n in state.params if n.endswith(("lora_a", "lora_b"))
                 or n.startswith("vision_proj.")]
    assert sorted(state.trainable) == sorted(
        n for n in trainable if not n.startswith("output_adapter.base"))
    for key in ("mu", "nu", "acc"):
        assert sorted(state.opt_state[key]) == sorted(state.trainable), key
    assert state.opt_state["count"] == 3 and state.opt_state["mini_step"] == 0
    assert state.optimizer_state_bytes() == 12 * sum(state.params[n].numel()
                                                     for n in state.trainable)


def _resumed(runs, name):
    """A fresh trainer on the port run's save_dir, resumed from ``name``."""
    save_dir = runs["port"].checkpoint.save_dir
    trainer = t_build_trainer(t_build_config(CFG, opts=OPTS + ACCUM + [
        "training_parameters.save_dir", save_dir, "training_parameters.device", "cpu",
        "training_parameters.resume_file", os.path.join(save_dir, "models", name)]))
    trainer.load()
    return trainer


def _states(state) -> dict:
    return {"params": state.params, **{k: state.opt_state[k] for k in ("mu", "nu", "acc")}}


def test_resume_inside_an_accumulation_window_is_bit_for_bit(runs):
    mid = _resumed(runs, "model_3")
    state = mid.state
    assert state.step == 3 and state.opt_state["mini_step"] == 1 and state.opt_state["count"] == 1
    assert all(t.any() for t in state.opt_state["acc"].values())  # one micro-gradient in
    before = {n: state.params[n].clone() for n in state.trainable}
    state, _ = mid._train_step(state, runs["batches"][3])  # iteration 4
    ref = _resumed(runs, "model_4").state
    assert state.step == ref.step == 4
    assert state.opt_state["mini_step"] == ref.opt_state["mini_step"] == 0
    assert state.opt_state["count"] == ref.opt_state["count"] == 2
    got, want = _states(state), _states(ref)
    for key, tree in want.items():
        for name, value in tree.items():
            assert torch.equal(got[key][name], value), (key, name)
    assert torch.equal(state.generator.get_state(), ref.generator.get_state())
    # the window's update moved every trainable master
    assert not any(torch.equal(before[n], state.params[n]) for n in state.trainable)
