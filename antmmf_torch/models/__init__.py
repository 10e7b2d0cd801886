# importing the model modules registers the models
from antmmf_torch.models import (  # noqa: F401
    dmae,
    m2_omni,
    pink,
    univl,
    univl_caption,
    univl_cls,
    univl_mcqa,
    univl_pretrain,
    univl_roi,
)
