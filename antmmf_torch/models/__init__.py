# importing the model modules registers the models
from antmmf_torch.models import dmae, pink, univl, univl_pretrain  # noqa: F401
