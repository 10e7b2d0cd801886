# importing the predictor modules registers the predictors
from antmmf_torch.predictors import base_predictor, generation_predictor  # noqa: F401
