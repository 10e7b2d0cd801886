"""``univl_mcqa`` through the port's trainer against the JAX trainer, on the
CPU: one JAX ``BaseTrainer`` run against ``antmmf_torch.run``, step for step
(the case, its checks and tolerances are in ``test_torch_task_trainer.py``).
"""

import pytest

from test_torch_task_trainer import (  # noqa: F401  (one_torch_thread is autouse)
    check_step_for_step,
    check_validations,
    one_torch_thread,
    trainer_runs,
)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return trainer_runs("univl_mcqa", tmp_path_factory)


def test_trainer_scalars_match_jax_step_for_step(runs):
    check_step_for_step(runs)


def test_full_validations_and_best_match_jax(runs):
    check_validations(runs)
    assert all(set(m) <= {"total_loss", "losses/mcqa_loss", "metrics/mcqa_acc"}
               for _, m in runs["t_vals"])
