# importing the processor modules registers the processors
from antmmf_torch.datasets.processors import image_processors, text_processors  # noqa: F401
