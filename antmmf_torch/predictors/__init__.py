# importing base_predictor registers the predictors
from antmmf_torch.predictors import base_predictor  # noqa: F401
