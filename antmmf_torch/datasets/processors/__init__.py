# importing text_processors registers the processors
from antmmf_torch.datasets.processors import text_processors  # noqa: F401
