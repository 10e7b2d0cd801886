from antmmf_torch.tasks.base_task import BaseTask  # noqa: F401
