"""UniVL multiple-choice video QA: score the video against each option.

Port of ``antmmf_tpu/models/univl_mcqa.py``: the B·O options fold into one
text-tower call (so its attention kernel runs once a layer, not once an
option); each option's embedding meets the video's clip embeddings under
the clamped ``logit_scale``, and an option's logit is the logsumexp over
clips less log(n_clips). With ``targets`` in the batch the model returns
``mcqa_loss`` and ``mcqa_acc``.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Mapping

import torch

from antmmf_torch.common.registry import registry
from antmmf_torch.models.univl import UnivlForVideoTextRetrieval


@registry.register_model("univl_mcqa")
class UnivlForMultiChoiceQA(UnivlForVideoTextRetrieval):
    global_batch_over_ranks = False  # its own forward: not run over ranks yet

    def _forward(self, batch: Mapping[str, torch.Tensor], deterministic: bool) -> Dict:
        clip_embed = self.base.forward_img_encoder(batch["image_data"])["clip_embed"]
        ids, mask = batch["options_input_ids"], batch["options_input_mask"]
        B, O, L = ids.shape
        opt = self.base.forward_text_encoder(ids.reshape(B * O, L),
                                             mask.reshape(B * O, L))["text_embed"]
        scale = torch.exp(torch.clamp(self.logit_scale, 0.0, math.log(100.0)))
        sims = torch.einsum("bod,bcd->boc", opt.reshape(B, O, -1).float(), clip_embed.float())
        logits = torch.logsumexp(sims * scale, dim=-1) - math.log(float(sims.shape[-1]))
        out: Dict[str, Any] = {"logits": logits}
        if "targets" in batch:
            targets = batch["targets"]
            nll = -torch.log_softmax(logits, dim=-1).gather(-1, targets[:, None])
            out["losses"] = {"mcqa_loss": nll.mean()}
            out["metrics"] = {"mcqa_acc": (logits.argmax(dim=-1) == targets).float().mean()}
        return out
