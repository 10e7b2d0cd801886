"""Trainer factory: ``training_parameters.trainer`` → registered trainer.

Port of ``antmmf_tpu/trainers/build.py``. Importing it registers the port's
trainers, tasks, dataset builders, samplers and models.
"""

from __future__ import annotations

from typing import Mapping

import antmmf_torch.datasets.samplers  # noqa: F401  (registry side effects)
import antmmf_torch.datasets.mcqa_dataset  # noqa: F401
import antmmf_torch.datasets.pink_instruct_dataset  # noqa: F401
import antmmf_torch.datasets.roi_dataset  # noqa: F401
import antmmf_torch.datasets.video_text_dataset  # noqa: F401
import antmmf_torch.models  # noqa: F401
import antmmf_torch.tasks  # noqa: F401
import antmmf_torch.tasks.iteration_strategies  # noqa: F401
import antmmf_torch.trainers.base_trainer  # noqa: F401
import antmmf_torch.trainers.retrieval_trainer  # noqa: F401
from antmmf_torch.common.configuration import convert_to_config
from antmmf_torch.common.registry import registry


def build_trainer(config: Mapping):
    config = convert_to_config(config)
    name = config.get("training_parameters", {}).get("trainer", "base_trainer")
    return registry.get_trainer_class(name)(config)
