# importing the model modules registers the models
from antmmf_torch.models import pink, univl  # noqa: F401
