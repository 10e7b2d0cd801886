"""UniVL classification finetune: a label head over the fused video-text pair.

Port of ``antmmf_tpu/models/univl_cls.py``: the retrieval towers give the
text embedding t and the clip mean v; the feature [t; v; |t − v|; t·v]
goes through a 2-layer ``mlp`` ``ClassifierLayer`` (``cls_head``, in the
compute dtype) to fp32 logits. With ``targets`` in the batch the model
returns ``cls_loss`` (the mean negative log-likelihood) and ``cls_acc``.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import torch

from antmmf_torch.common.registry import registry
from antmmf_torch.models.univl import UnivlForVideoTextRetrieval
from antmmf_torch.modules.classifier import ClassifierLayer


@registry.register_model("univl_classification")
class UnivlForClassification(UnivlForVideoTextRetrieval):
    global_batch_over_ranks = False  # its own forward: not run over ranks yet

    def __init__(self, num_labels: int = 2, embed_dim: int = 512, device=None, **kw):
        super().__init__(embed_dim=embed_dim, device=device, **kw)
        self.cls_head = ClassifierLayer("mlp", 4 * embed_dim, num_labels, num_layers=2,
                                        dtype=self.dtype, device=device)

    def _forward(self, batch: Mapping[str, torch.Tensor], deterministic: bool) -> Dict:
        t = self.base.forward_text_encoder(batch["caption_input_ids"],
                                           batch["caption_input_mask"],
                                           batch.get("caption_segment_ids"))["text_embed"]
        v = self.base.forward_img_encoder(batch["image_data"])["clip_embed"].mean(dim=1)
        fused = torch.cat([t, v, (t - v).abs(), t * v], dim=-1)
        logits = self.cls_head(fused).float()
        out: Dict[str, Any] = {"logits": logits, "text_embed": t, "visual_embed": v}
        if "targets" in batch:
            targets = batch["targets"]
            nll = -torch.log_softmax(logits, dim=-1).gather(-1, targets[:, None])
            out["losses"] = {"cls_loss": nll.mean()}
            out["metrics"] = {"cls_acc": (logits.argmax(dim=-1) == targets).float().mean()}
        return out
