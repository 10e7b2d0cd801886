# importing the processor modules registers the processors
from antmmf_torch.datasets.processors import (  # noqa: F401
    audio_processors,
    image_processors,
    m2omni_processing,
    pink_conversation,
    pink_processors,
    region_processors,
    text_processors,
)
