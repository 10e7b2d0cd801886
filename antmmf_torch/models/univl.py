"""UniVL two-tower video-text retrieval: the serving forward.

Port of ``antmmf_tpu/models/univl.py``: ``l2_normalize``, the
``UnivlVideoBase`` towers (frames fold into the batch for the ViT, then
frame → clip mean pooling) and ``UnivlForVideoTextRetrieval``'s clip-logsumexp
similarity with the clamped fp32 ``logit_scale``. Outputs ``l1_simi``,
``sim``, ``text_embed``, ``visual_embed`` and ``logits``. Losses, the MoCo
queue, the cross-encoder and hard-negative mining are not ported yet.
"""

from __future__ import annotations

import inspect
import math
from typing import Any, Dict, Mapping, Optional

import torch
from torch import nn

from antmmf_torch.common.registry import registry
from antmmf_torch.modules.encoders.text_encoder import PRESETS as BERT_PRESETS, BertEncoder
from antmmf_torch.modules.vision.vit import PRESETS as VIT_PRESETS, VisionTransformer


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-6) -> torch.Tensor:
    """x / (‖x‖ + eps) with an fp32 norm (the result promotes to fp32)."""
    return x / (torch.linalg.vector_norm(x.float(), dim=dim, keepdim=True) + eps)


class UnivlVideoBase(nn.Module):
    """The two towers and their projections into the shared space."""

    def __init__(self, vit_preset: str = "vit_base_patch32", image_size: int = 224,
                 bert_preset: str = "bert_base", embed_dim: int = 512, n_clips: int = 1,
                 token_merge_r: int = 0, dtype=torch.bfloat16, device=None):
        super().__init__()
        self.n_clips = n_clips
        vit_kw = VIT_PRESETS[vit_preset]
        self.img_encoder = VisionTransformer(image_size=image_size,
                                             token_merge_r=token_merge_r,
                                             dtype=dtype, device=device, **vit_kw)
        bert_kw = BERT_PRESETS[bert_preset]
        self.text_encoder = BertEncoder(dtype=dtype, device=device, **bert_kw)
        kw = dict(bias=False, dtype=dtype, device=device)
        self.img_fc = nn.Linear(vit_kw["embed_dim"], embed_dim, **kw)
        self.text_fc = nn.Linear(bert_kw["hidden_size"], embed_dim, **kw)

    def forward_img_encoder(self, image_data: torch.Tensor) -> Dict[str, torch.Tensor]:
        """image_data float[B, F, H, W, 3] → clip_embed [B, n_clips, D]."""
        B, F = image_data.shape[:2]
        if F % self.n_clips:
            raise ValueError(f"{F} frames do not split into {self.n_clips} clips")
        enc = self.img_encoder(image_data.reshape((B * F,) + image_data.shape[2:]))
        pooled = enc["pooled"].reshape(B, F, -1)
        clip_feat = pooled.reshape(B, self.n_clips, F // self.n_clips, -1).mean(dim=2)
        return {"clip_embed": l2_normalize(self.img_fc(clip_feat)), "frame_pooled": pooled}

    def forward_text_encoder(self, input_ids: torch.Tensor, input_mask: torch.Tensor,
                             segment_ids: Optional[torch.Tensor] = None
                             ) -> Dict[str, torch.Tensor]:
        enc = self.text_encoder(input_ids, input_mask, segment_ids)
        return {"text_embed": l2_normalize(self.text_fc(enc["pooled_output"])),
                "sequence_output": enc["sequence_output"],
                "pooled_output": enc["pooled_output"]}


@registry.register_model("univl_retrieval")
@registry.register_model("univl")
class UnivlForVideoTextRetrieval(nn.Module):
    """Two-tower (L1) retrieval, serving forward.

    ``from_config`` takes the JAX model's ``model_attributes``; keys that only
    shape training (losses, dropout, remat, ...) do not change this forward
    and are ignored, as the JAX ``from_config`` ignores unknown keys. The
    cross-encoder and sequence parallelism are refused."""

    def __init__(self, vit_preset: str = "vit_base_patch32", image_size: int = 224,
                 bert_preset: str = "bert_base", embed_dim: int = 512, n_clips: int = 1,
                 token_merge_r: int = 0, init_logit_scale: float = 2.6592,
                 dtype_str: str = "bfloat16", with_cross_encoder: bool = False,
                 sequence_parallel: str = "none", device=None):
        super().__init__()
        if with_cross_encoder:
            raise NotImplementedError("the UniVL cross-encoder is not ported yet")
        if sequence_parallel != "none":
            raise NotImplementedError("sequence parallelism is not ported yet")
        self.dtype = getattr(torch, dtype_str)
        self.base = UnivlVideoBase(vit_preset, image_size, bert_preset, embed_dim, n_clips,
                                   token_merge_r, self.dtype, device)
        self.logit_scale = nn.Parameter(
            torch.tensor(init_logit_scale, dtype=torch.float32, device=device))

    @classmethod
    def from_config(cls, config: Mapping[str, Any], device=None) -> "UnivlForVideoTextRetrieval":
        names = set(inspect.signature(cls.__init__).parameters) - {"self", "device"}
        return cls(device=device, **{k: v for k, v in dict(config).items() if k in names})

    def similarity(self, text_embed: torch.Tensor, clip_embed: torch.Tensor) -> torch.Tensor:
        """[Bt, D] × [Bv, n_clips, D] → [Bt, Bv] via logsumexp over clips."""
        scale = torch.exp(torch.clamp(self.logit_scale, 0.0, math.log(100.0)))
        sims = torch.einsum("td,vcd->tvc", text_embed.float(), clip_embed.float())
        return torch.logsumexp(sims * scale, dim=-1) - math.log(float(sims.shape[-1]))

    def forward(self, batch: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        text = self.base.forward_text_encoder(batch["caption_input_ids"],
                                              batch["caption_input_mask"],
                                              batch.get("caption_segment_ids"))
        clip_embed = self.base.forward_img_encoder(batch["image_data"])["clip_embed"]
        sim = self.similarity(text["text_embed"], clip_embed)
        return {"l1_simi": sim, "sim": sim, "text_embed": text["text_embed"],
                "visual_embed": clip_embed.mean(dim=1), "logits": sim}
