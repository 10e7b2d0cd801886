# importing the predictor modules registers the predictors
from antmmf_torch.predictors import (  # noqa: F401
    base_predictor,
    caption_predictor,
    generation_predictor,
)
