"""UniVL video-text retrieval: two towers plus the optional cross-encoder.

Port of ``antmmf_tpu/models/univl.py``: ``l2_normalize``, the
``UnivlVideoBase`` towers (frames fold into the batch for the ViT, then
frame → clip mean pooling) with the cross-encoder (text and visual streams
projected to one width, typed, concatenated and run through a post-LN
encoder with the pair's key-padding bias) and ``UnivlForVideoTextRetrieval``:
the clip-logsumexp similarity with the clamped fp32 ``logit_scale``, the
symmetric cross-entropy L1 loss, and with the cross-encoder the L2 loss,
either over in-step mined hard negatives (training, ``hard_mining_k`` > 1)
or over the full B×B pair grid. Outputs ``l1_simi``, ``sim``, ``text_embed``,
``visual_embed``, ``logits`` and ``losses`` (plus the L2 outputs).
Other ``loss_type`` values, the MoCo queue, dropout and sequence parallelism
raise until they are ported.
"""

from __future__ import annotations

import inspect
import math
from typing import Any, Dict, Mapping, Optional

import torch
from torch import nn

from antmmf_torch.common.registry import registry
from antmmf_torch.modules.encoders.text_encoder import PRESETS as BERT_PRESETS, BertEncoder
from antmmf_torch.modules.layers import make_attention_mask
from antmmf_torch.modules.losses.contrastive import symmetric_cross_en
from antmmf_torch.modules.transformers.base import TransformerEncoder
from antmmf_torch.modules.vision.vit import PRESETS as VIT_PRESETS, VisionTransformer


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-6) -> torch.Tensor:
    """x / (‖x‖ + eps) with an fp32 norm (the result promotes to fp32)."""
    return x / (torch.linalg.vector_norm(x.float(), dim=dim, keepdim=True) + eps)


class UnivlVideoBase(nn.Module):
    """The two towers, their projections into the shared space and, with
    ``with_cross_encoder``, the L2 cross-encoder."""

    def __init__(self, vit_preset: str = "vit_base_patch32", image_size: int = 224,
                 bert_preset: str = "bert_base", embed_dim: int = 512, n_clips: int = 1,
                 token_merge_r: int = 0, with_cross_encoder: bool = False,
                 cross_layers: int = 2, dtype=torch.bfloat16, device=None):
        super().__init__()
        self.n_clips = n_clips
        vit_kw = VIT_PRESETS[vit_preset]
        self.img_encoder = VisionTransformer(image_size=image_size,
                                             token_merge_r=token_merge_r,
                                             dtype=dtype, device=device, **vit_kw)
        bert_kw = BERT_PRESETS[bert_preset]
        self.text_encoder = BertEncoder(dtype=dtype, device=device, **bert_kw)
        kw = dict(dtype=dtype, device=device)
        text_hidden, visual_hidden = bert_kw["hidden_size"], vit_kw["embed_dim"]
        self.img_fc = nn.Linear(visual_hidden, embed_dim, bias=False, **kw)
        self.text_fc = nn.Linear(text_hidden, embed_dim, bias=False, **kw)
        self.with_cross_encoder = with_cross_encoder
        if with_cross_encoder:
            width = max(text_hidden, visual_hidden)
            self.cross_text_proj = nn.Linear(text_hidden, width, **kw)
            self.cross_visual_proj = nn.Linear(visual_hidden, width, **kw)
            self.cross_type_embed = nn.Embedding(2, width, **kw)
            self.cross_encoder = TransformerEncoder(
                width, cross_layers, max(1, width // 64), norm_style="post",
                final_norm=False, dtype=dtype, device=device)
            self.cross_pooler = nn.Linear(width, width, **kw)
            # the trained L2 match score, computed in fp32
            self.cross_sim_head = nn.Linear(width, 1, dtype=torch.float32, device=device)

    def forward_img_encoder(self, image_data: torch.Tensor) -> Dict[str, torch.Tensor]:
        """image_data float[B, F, H, W, 3] → clip_embed [B, n_clips, D], the
        per-frame pooled features and the visual tokens [B, F, N, C]."""
        B, F = image_data.shape[:2]
        if F % self.n_clips:
            raise ValueError(f"{F} frames do not split into {self.n_clips} clips")
        enc = self.img_encoder(image_data.reshape((B * F,) + image_data.shape[2:]))
        pooled = enc["pooled"].reshape(B, F, -1)
        clip_feat = pooled.reshape(B, self.n_clips, F // self.n_clips, -1).mean(dim=2)
        seq = enc["sequence"]
        return {"clip_embed": l2_normalize(self.img_fc(clip_feat)), "frame_pooled": pooled,
                "visual_tokens": seq.reshape(B, F, seq.shape[1], -1)}

    def forward_text_encoder(self, input_ids: torch.Tensor, input_mask: torch.Tensor,
                             segment_ids: Optional[torch.Tensor] = None
                             ) -> Dict[str, torch.Tensor]:
        enc = self.text_encoder(input_ids, input_mask, segment_ids)
        return {"text_embed": l2_normalize(self.text_fc(enc["pooled_output"])),
                "sequence_output": enc["sequence_output"],
                "pooled_output": enc["pooled_output"]}

    def forward_cross_encoder(self, text_seq: torch.Tensor, text_mask: torch.Tensor,
                              visual_seq: torch.Tensor, visual_mask: torch.Tensor
                              ) -> Dict[str, torch.Tensor]:
        """Type-embedded text [P, Lt, Ct] and visual [P, Lv, Cv] streams,
        concatenated, through the shared encoder under their key bias."""
        t = self.cross_text_proj(text_seq) + self.cross_type_embed(
            torch.zeros(text_seq.shape[:2], dtype=torch.long, device=text_seq.device))
        v = self.cross_visual_proj(visual_seq) + self.cross_type_embed(
            torch.ones(visual_seq.shape[:2], dtype=torch.long, device=visual_seq.device))
        mask = torch.cat([text_mask, visual_mask.to(text_mask.dtype)], dim=1)
        seq = self.cross_encoder(torch.cat([t, v], dim=1), make_attention_mask(mask))
        pooled = torch.tanh(self.cross_pooler(seq[:, 0]))
        return {"cross_sequence": seq, "cross_pooled": pooled, "cross_mask": mask}

    def cross_pair_scores(self, text_seq: torch.Tensor, text_mask: torch.Tensor,
                          visual_seq: torch.Tensor, visual_mask: torch.Tensor) -> torch.Tensor:
        """The trained L2 match score of each (text, video) pair → f32[P]."""
        cross = self.forward_cross_encoder(text_seq, text_mask, visual_seq, visual_mask)
        return self.cross_sim_head(cross["cross_pooled"].float())[..., 0]


@registry.register_model("univl_retrieval")
@registry.register_model("univl")
class UnivlForVideoTextRetrieval(nn.Module):
    """Two-tower (L1) retrieval with the optional L2 cross-encoder.

    ``from_config`` takes the JAX model's ``model_attributes``; keys that
    change neither the forward nor the loss here (remat, use_pallas,
    scan_layers, ...) are ignored, as the JAX ``from_config`` ignores unknown
    keys. ``forward(batch, deterministic)`` follows the JAX ``__call__``:
    with ``deterministic=False`` and ``hard_mining_k`` > 1 the L2 loss runs
    over mined pairs, otherwise over the full pair grid."""

    def __init__(self, vit_preset: str = "vit_base_patch32", image_size: int = 224,
                 bert_preset: str = "bert_base", embed_dim: int = 512, n_clips: int = 1,
                 token_merge_r: int = 0, init_logit_scale: float = 2.6592,
                 dtype_str: str = "bfloat16", with_cross_encoder: bool = False,
                 cross_layers: int = 2, hard_mining_k: int = 0, loss_type: str = "cross_en",
                 with_queue: bool = False, dropout: float = 0.0,
                 training_head_only: bool = False, sequence_parallel: str = "none",
                 device=None):
        super().__init__()
        if sequence_parallel != "none":
            raise NotImplementedError("sequence parallelism is not ported yet")
        if loss_type != "cross_en" or with_queue:
            raise NotImplementedError(f"loss_type {loss_type!r} and the MoCo queue are not "
                                      f"ported yet; only cross_en without a queue is")
        if dropout:
            raise NotImplementedError(f"dropout {dropout} is not ported yet; only 0 is")
        self.dtype = getattr(torch, dtype_str)
        self.hard_mining_k = hard_mining_k
        self.training_head_only = training_head_only
        self.base = UnivlVideoBase(vit_preset, image_size, bert_preset, embed_dim, n_clips,
                                   token_merge_r, with_cross_encoder, cross_layers,
                                   self.dtype, device)
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

    def forward(self, batch: Mapping[str, torch.Tensor],
                deterministic: bool = True) -> Dict[str, Any]:
        text = self.base.forward_text_encoder(batch["caption_input_ids"],
                                              batch["caption_input_mask"],
                                              batch.get("caption_segment_ids"))
        video = self.base.forward_img_encoder(batch["image_data"])
        text_embed, clip_embed = text["text_embed"], video["clip_embed"]
        if self.training_head_only:
            text_embed, clip_embed = text_embed.detach(), clip_embed.detach()
        sim = self.similarity(text_embed, clip_embed)
        output: Dict[str, Any] = {"l1_simi": sim, "sim": sim, "text_embed": text_embed,
                                  "visual_embed": clip_embed.mean(dim=1), "logits": sim}
        losses = {"level1_similarity_loss": symmetric_cross_en(sim)}
        if self.base.with_cross_encoder:
            self._level2(batch, text, video, sim, deterministic, output, losses)
        output["losses"] = losses
        return output

    def _level2(self, batch, text, video, sim, deterministic, output, losses) -> None:
        """The L2 loss (``univl.py:458-505`` of the JAX package)."""
        text_seq, text_mask = text["sequence_output"], batch["caption_input_mask"]
        B = text_seq.shape[0]
        vis_tokens = video["visual_tokens"]  # [B, F, Lv, C]
        F, Lv = vis_tokens.shape[1], vis_tokens.shape[2]
        vis_seq = vis_tokens.reshape(B, F * Lv, -1)
        video_mask = batch.get("video_mask")
        if video_mask is None:
            video_mask = torch.ones(B, F, dtype=torch.long, device=vis_seq.device)
        vis_mask = video_mask.repeat_interleave(Lv, dim=1)
        k = min(self.hard_mining_k, B) if self.hard_mining_k > 0 else 0
        if not deterministic and k > 1:
            # each text row meets its positive and its k-1 hardest L1
            # negatives (stop-gradient sims, the positive excluded)
            eye = torch.eye(B, device=sim.device)
            masked = sim.detach() + eye * torch.finfo(torch.float32).min
            hard_idx = torch.topk(masked, k - 1, dim=-1).indices
            cols = torch.cat([torch.arange(B, device=sim.device)[:, None], hard_idx], dim=1)
            flat = cols.reshape(-1)
            scores = self.base.cross_pair_scores(
                text_seq.repeat_interleave(k, dim=0), text_mask.repeat_interleave(k, dim=0),
                vis_seq[flat], vis_mask[flat]).reshape(B, k)
            # the positive sits in column 0 of each mined row
            losses["level2_similarity_loss"] = -torch.log_softmax(scores, dim=-1)[:, 0].mean()
            output["l2_pair_scores"] = scores
            output["l2_pair_cols"] = cols
        else:
            # the full B×B grid, pair (i, j) at i·B + j
            l2 = self.base.cross_pair_scores(
                text_seq.repeat_interleave(B, dim=0), text_mask.repeat_interleave(B, dim=0),
                vis_seq.repeat(B, 1, 1), vis_mask.repeat(B, 1)).reshape(B, B)
            output["l2_simi"] = l2
            losses["level2_similarity_loss"] = symmetric_cross_en(l2)
        output["text_seq"] = text_seq
        output["visual_tokens"] = vis_tokens
