"""DMAE: two towers with a temporal encoder and WTI token-wise interaction.

Port of ``antmmf_tpu/models/dmae.py``:

* ``wti_similarity``: every text token against every frame token; invalid
  pairs are zeroed before the max (not filled with −inf), so a word whose
  similarities are all negative contributes 0; each side's maxima weighted
  by its token weights, the two directions averaged;
* ``TokenWeightHead``: an fp32 ``weight_proj`` logit a token, softmaxed over
  the valid tokens only;
* ``DmaeForVideoTextRetrieval``: the UniVL towers; the frame-pooled
  features through ``frame_fc`` and the ``seqTransf`` temporal encoder
  (pre-norm with a final norm, ``embed_dim // 64`` heads, the frame mask as
  key bias) plus a residual; L1 = the text embedding against the masked
  frame mean, L2-normalised, times the clamped scale (no clip logsumexp);
  L3 = WTI of ``token_fc``'s text tokens and the temporal frame tokens,
  times the scale. Losses ``level1_similarity_loss`` (symmetric CrossEn)
  and ``level3_similarity_loss`` (``l3_weight`` × the symmetric DMAE
  NegNCE at logit scale 1). The outputs keep the JAX model's keys, the
  ``wti_*`` components that the retrieval trainer's corpus L3 needs
  included.
"""

from __future__ import annotations

import inspect
import math
from typing import Any, Dict, Mapping, Optional

import torch
from torch import nn

from antmmf_torch.common.registry import registry
from antmmf_torch.models.univl import UnivlVideoBase, l2_normalize
from antmmf_torch.modules.layers import draws, make_attention_mask
from antmmf_torch.modules.losses.contrastive import NEG_INF, neg_nce_dmae, symmetric_cross_en
from antmmf_torch.modules.transformers.base import TransformerEncoder


def wti_similarity(text_tokens: torch.Tensor, text_weights: torch.Tensor,
                   video_tokens: torch.Tensor, video_weights: torch.Tensor,
                   text_mask: torch.Tensor, video_mask: torch.Tensor) -> torch.Tensor:
    """Weighted token-wise interaction, fp32 [Bt, Bv], from tokens [Bt, Lt, D]
    and [Bv, Lv, D], weights [Bt, Lt] and [Bv, Lv], masks of the same shapes."""
    c = torch.einsum("tld,vmd->tvlm", text_tokens.float(), video_tokens.float())
    c = c * text_mask[:, None, :, None].float() * video_mask[None, :, None, :].float()
    sim_t2v = torch.einsum("tvl,tl->tv", c.amax(dim=-1), text_weights.float())
    sim_v2t = torch.einsum("tvm,vm->tv", c.amax(dim=-2), video_weights.float())
    return 0.5 * (sim_t2v + sim_v2t)


class TokenWeightHead(nn.Module):
    """Per-token importance weights: an fp32 logit a token, softmaxed over
    the tokens whose mask is set."""

    def __init__(self, dim: int, device=None):
        super().__init__()
        self.weight_proj = nn.Linear(dim, 1, dtype=torch.float32, device=device)

    def forward(self, tokens: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        logits = self.weight_proj(tokens.float())[..., 0]
        return torch.softmax(torch.where(mask > 0, logits, NEG_INF), dim=-1)


@registry.register_model("dmae_retrieval")
@registry.register_model("dmae")
class DmaeForVideoTextRetrieval(nn.Module):
    """``from_config`` takes the JAX model's ``model_attributes``; keys that
    change neither the forward nor the loss here (``remat``, ``use_pallas``,
    ``max_text_len``) are ignored. ``dropout`` reaches the towers, not the
    temporal encoder, as in JAX; a training forward draws its masks from the
    ``generator`` it is given."""

    def __init__(self, vit_preset: str = "vit_base_patch32", image_size: int = 224,
                 bert_preset: str = "bert_base", embed_dim: int = 512, n_clips: int = 1,
                 temporal_layers: int = 2, dropout: float = 0.0, neg_nce_margin: float = 0.0,
                 neg_nce_weight: float = 1.0, l3_weight: float = 1.0,
                 init_logit_scale: float = 2.6592, dtype_str: str = "bfloat16", device=None):
        super().__init__()
        dtype = getattr(torch, dtype_str)
        self.neg_nce_margin, self.neg_nce_weight, self.l3_weight = \
            neg_nce_margin, neg_nce_weight, l3_weight
        self.base = UnivlVideoBase(vit_preset, image_size, bert_preset, embed_dim, n_clips,
                                   dtype=dtype, device=device, dropout=dropout)
        visual_hidden, text_hidden = self.base.img_fc.in_features, self.base.text_fc.in_features
        self.temporal_encoder = TransformerEncoder(
            embed_dim, temporal_layers, max(1, embed_dim // 64), norm_style="pre",
            final_norm=True, dtype=dtype, device=device)
        self.frame_fc = nn.Linear(visual_hidden, embed_dim, bias=False, dtype=dtype,
                                  device=device)
        self.token_fc = nn.Linear(text_hidden, embed_dim, bias=False, dtype=dtype,
                                  device=device)
        self.text_weight_head = TokenWeightHead(text_hidden, device)
        self.video_weight_head = TokenWeightHead(embed_dim, device)
        self.logit_scale = nn.Parameter(
            torch.tensor(init_logit_scale, dtype=torch.float32, device=device))

    @classmethod
    def from_config(cls, config: Mapping[str, Any], device=None) -> "DmaeForVideoTextRetrieval":
        names = set(inspect.signature(cls.__init__).parameters) - {"self", "device"}
        return cls(device=device, **{k: v for k, v in dict(config).items() if k in names})

    def forward(self, batch: Mapping[str, torch.Tensor], deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> Dict[str, Any]:
        with draws(generator, active=not deterministic):
            return self._forward(batch)

    def _forward(self, batch: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
        text = self.base.forward_text_encoder(batch["caption_input_ids"],
                                              batch["caption_input_mask"],
                                              batch.get("caption_segment_ids"))
        video = self.base.forward_img_encoder(batch["image_data"])
        scale = torch.exp(torch.clamp(self.logit_scale, 0.0, math.log(100.0)))

        # L1: the text embedding against the temporal encoder's masked frame mean
        frames = self.frame_fc(video["frame_pooled"])  # [B, F, D]
        B, F = frames.shape[:2]
        video_mask = batch.get("video_mask")
        if video_mask is None:
            video_mask = torch.ones(B, F, dtype=torch.long, device=frames.device)
        frames_t = self.temporal_encoder(frames, make_attention_mask(video_mask)) + frames
        denom = video_mask.sum(-1, keepdim=True).clamp(min=1)
        v_pooled = l2_normalize((frames_t * video_mask[..., None]).sum(1) / denom)
        t_pooled = text["text_embed"]
        l1 = (t_pooled.float() @ v_pooled.float().T) * scale

        # L3: WTI over the text tokens and the frame tokens
        text_mask = batch["caption_input_mask"]
        text_tokens = l2_normalize(self.token_fc(text["sequence_output"]))
        video_tokens = l2_normalize(frames_t)
        tw = self.text_weight_head(text["sequence_output"], text_mask)
        vw = self.video_weight_head(frames_t, video_mask)
        l3 = wti_similarity(text_tokens, tw, video_tokens, vw, text_mask, video_mask) * scale

        kw = dict(logit_scale=1.0, c_neg=self.neg_nce_weight, margin=self.neg_nce_margin)
        losses = {"level1_similarity_loss": symmetric_cross_en(l1),
                  "level3_similarity_loss": self.l3_weight * 0.5 * (
                      neg_nce_dmae(l3, **kw) + neg_nce_dmae(l3.T, **kw))}
        return {"l1_simi": l1, "l3_simi": l3, "sim": l3, "logits": l3,
                "text_embed": t_pooled, "visual_embed": v_pooled,
                "wti_text_tokens": text_tokens, "wti_text_weights": tw,
                "wti_video_tokens": video_tokens, "wti_video_weights": vw,
                "wti_text_mask": text_mask, "wti_video_mask": video_mask,
                "losses": losses}
