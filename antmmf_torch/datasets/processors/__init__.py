# importing the processor modules registers the processors
from antmmf_torch.datasets.processors import (  # noqa: F401
    image_processors,
    pink_conversation,
    pink_processors,
    region_processors,
    text_processors,
)
