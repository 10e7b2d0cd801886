# importing univl registers the models
from antmmf_torch.models import univl  # noqa: F401
