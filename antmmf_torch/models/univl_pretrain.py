"""UniVL video-text pretraining: VTC + VTM + MLM (+ dual MLM, FOM).

Port of ``antmmf_tpu/models/univl_pretrain.py`` (``UnivlForVideoPretraining``)
on the towers and cross-encoder of ``models/univl.py``:

* VTC: the clip-logsumexp similarity under the clamped fp32 ``logit_scale``,
  scored by ``symmetric_cross_en`` (``vtc_loss``);
* VTM: labels ``arange(B) % 2`` (1 = matched); even rows meet the video of
  the previous row (the visual stream rolled by one along the batch), odd
  rows their own; the cross-encoder's pooled pair → ``ITMHead``
  (``itm_loss``, ``itm_acc``);
* MLM: a second cross-encoder pass over the matched pairs; its first Lt
  (text) positions → ``MLMHead`` with the decoder tied to the text tower's
  word embedding (``masked_lm_loss``, ``masked_lm_acc``);
* ``dual_mlm`` (SNP-S3): the text tower's output → a second ``MLMHead`` tied
  to the same table (``text_masked_lm_loss``, ``text_masked_lm_acc``);
* ``with_fom``: in training, one permutation of the frames a batch and a
  shuffle mask a row (probability ``fom_shuffle_prob``) drawn from the
  ``generator`` the trainer passes (its ``TrainState`` generator); the
  frame-pooled features of shuffled rows are permuted and ``FOMHead``
  predicts each frame's original position (``fom_loss``, ``fom_acc``).
  The JAX package draws both from its ``dropout`` rng stream, which torch
  cannot reproduce; without training nothing is shuffled.

* ``attentive_masking``: in training, the caption's MLM positions are
  redrawn in proportion to the text tower's word importance
  (``BertEncoder.word_importance`` of ``caption_raw_input_ids``, its
  probabilities from the einsum core, no gradient) on one step in two:
  ``n_mask = max(1, int(L · attentive_mask_ratio))`` positions a row by a
  Gumbel top-k over log(importance + 1e-6) with noise from uniform(1e-9,
  1), never a special token ([CLS], [SEP], padding id 0) or a padded
  position; they become ``mask_token_id`` with the raw ids as labels. A
  coin (probability 0.5) a step picks these ids and labels or the
  processor's uniform ones. The top-k is ``utils.text_utils.top_k``, ties
  at the lower index as ``jax.lax.top_k``. Both draws come from the
  trainer's generator (``attentive_draws``); the JAX package draws them
  from its ``dropout`` stream.

The output holds ``losses``, ``metrics``, ``text_embed``, ``visual_embed``
and, with their objectives, ``sim``/``l1_simi``, ``itm_logits`` and
``mlm_logits``; ``logits`` is ``sim`` (else the first loss). ``dropout``
reaches the towers and the cross-encoder, its masks drawn in training from
the same generator.
"""

from __future__ import annotations

import inspect
from typing import Any, Dict, Mapping, Optional, Tuple

import torch
from torch import nn

from antmmf_torch.common.registry import registry
from antmmf_torch.models.univl import UnivlVideoBase, clip_similarity
from antmmf_torch.modules.layers import draws
from antmmf_torch.modules.losses.contrastive import symmetric_cross_en
from antmmf_torch.modules.transformers.heads.fom import FOMHead
from antmmf_torch.modules.transformers.heads.itm import ITMHead
from antmmf_torch.modules.transformers.heads.mlm import MLMHead
from antmmf_torch.utils.text_utils import top_k

SPECIAL_IDS = (101, 102, 0)  # [CLS], [SEP] and padding: never masked


@registry.register_model("univl_pretrain")
class UnivlForVideoPretraining(nn.Module):
    """``from_config`` takes the JAX model's ``model_attributes``; keys that
    change neither the forward nor the loss here (``remat``, ``use_pallas``,
    ``max_text_len``: the text tower's positions come from its preset) are
    ignored."""

    def __init__(self, vit_preset: str = "vit_base_patch32", image_size: int = 224,
                 bert_preset: str = "bert_base", embed_dim: int = 512, n_clips: int = 1,
                 cross_layers: int = 2, dropout: float = 0.0, with_vtc: bool = True,
                 with_vtm: bool = True, with_mlm: bool = True, dual_mlm: bool = False,
                 with_fom: bool = False, attentive_masking: bool = False,
                 attentive_mask_ratio: float = 0.15, mask_token_id: int = 103,
                 fom_shuffle_prob: float = 0.15, init_logit_scale: float = 2.6592,
                 dtype_str: str = "bfloat16", device=None):
        super().__init__()
        dtype = getattr(torch, dtype_str)
        self.with_vtc, self.with_vtm, self.with_mlm = with_vtc, with_vtm, with_mlm
        self.dual_mlm, self.with_fom, self.fom_shuffle_prob = dual_mlm, with_fom, fom_shuffle_prob
        self.attentive_masking, self.attentive_mask_ratio = attentive_masking, attentive_mask_ratio
        self.mask_token_id = mask_token_id
        self.base = UnivlVideoBase(vit_preset, image_size, bert_preset, embed_dim, n_clips,
                                   with_cross_encoder=True, cross_layers=cross_layers,
                                   dtype=dtype, device=device, cross_sim_head=False,
                                   dropout=dropout)
        self.logit_scale = nn.Parameter(
            torch.tensor(init_logit_scale, dtype=torch.float32, device=device))
        emb = self.base.text_encoder.embeddings.word_embeddings
        vocab, text_hidden = emb.num_embeddings, emb.embedding_dim
        cross_width = self.base.cross_pooler.in_features
        kw = dict(dtype=dtype, device=device)
        if with_mlm or dual_mlm:
            self.mlm_head = MLMHead(cross_width, vocab, text_hidden, **kw)
        if dual_mlm:
            self.text_mlm_head = MLMHead(text_hidden, vocab, text_hidden, **kw)
        if with_vtm:
            self.itm_head = ITMHead(cross_width, **kw)
        if with_fom:
            visual_hidden = self.base.img_fc.in_features
            self.fom_head = FOMHead(visual_hidden, n_clips * 8, **kw)

    @classmethod
    def from_config(cls, config: Mapping[str, Any], device=None) -> "UnivlForVideoPretraining":
        names = set(inspect.signature(cls.__init__).parameters) - {"self", "device"}
        return cls(device=device, **{k: v for k, v in dict(config).items() if k in names})

    def word_embedding_table(self) -> nn.Parameter:
        """The text tower's word-embedding parameter, which both MLM heads
        decode against."""
        return self.base.text_encoder.embeddings.word_embeddings.weight

    @staticmethod
    def vtm_pairs(vis_seq: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(labels, visual stream) of the VTM pairs: odd rows keep their own
        video (label 1), even rows take the previous row's (label 0)."""
        labels = torch.arange(vis_seq.shape[0], device=vis_seq.device) % 2
        return labels, torch.where(labels[:, None, None] == 1, vis_seq,
                                   torch.roll(vis_seq, 1, dims=0))

    def fom_order(self, B: int, F: int, device, generator: Optional[torch.Generator]
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One frame permutation for the batch and a shuffle flag a row."""
        perm = torch.randperm(F, generator=generator, device=device)
        return perm, torch.rand(B, generator=generator, device=device) < self.fom_shuffle_prob

    def attentive_draws(self, B: int, L: int, device, generator: Optional[torch.Generator]
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The Gumbel top-k's uniforms in [1e-9, 1) [B, L] and the step's coin."""
        u = torch.rand(B, L, generator=generator, device=device)
        return 1e-9 + (1.0 - 1e-9) * u, torch.rand((), generator=generator, device=device) < 0.5

    def attentive_mask(self, raw_ids: torch.Tensor, input_mask: torch.Tensor,
                       segment_ids: Optional[torch.Tensor], uniform_ids: torch.Tensor,
                       uniform_labels: Optional[torch.Tensor],
                       generator: Optional[torch.Generator]
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(ids, labels) of the step: importance-sampled or the processor's."""
        B, L = raw_ids.shape
        with torch.no_grad():
            importance = self.base.text_encoder.word_importance(raw_ids, input_mask, segment_ids)
        special = torch.zeros_like(raw_ids, dtype=torch.bool)
        for token in SPECIAL_IDS:
            special |= raw_ids == token
        off = special | (input_mask == 0)
        imp = torch.where(off, 0.0, importance.float()) + 1e-6
        n_mask = max(1, int(L * self.attentive_mask_ratio))
        uniform, use_att = self.attentive_draws(B, L, raw_ids.device, generator)
        scores = torch.log(imp) - torch.log(-torch.log(uniform))
        scores = torch.where(off, torch.finfo(torch.float32).min, scores)
        _, pos = top_k(scores, n_mask)
        chosen = torch.zeros(B, L, dtype=torch.bool, device=raw_ids.device)
        chosen[torch.arange(B, device=raw_ids.device)[:, None], pos] = True
        chosen &= ~special & (input_mask > 0)
        att_ids = torch.where(chosen, self.mask_token_id, raw_ids)
        att_labels = torch.where(chosen, raw_ids, -1)
        ids = torch.where(use_att, att_ids, uniform_ids)
        labels = att_labels if uniform_labels is None else torch.where(use_att, att_labels,
                                                                       uniform_labels)
        return ids, labels

    def forward(self, batch: Mapping[str, torch.Tensor], deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> Dict[str, Any]:
        with draws(generator, active=not deterministic):
            return self._forward(batch, deterministic, generator)

    def _forward(self, batch: Mapping[str, torch.Tensor], deterministic: bool,
                 generator: Optional[torch.Generator]) -> Dict[str, Any]:
        losses: Dict[str, torch.Tensor] = {}
        metrics: Dict[str, torch.Tensor] = {}
        input_ids, input_mask = batch["caption_input_ids"], batch["caption_input_mask"]
        lm_labels = batch.get("caption_lm_label_ids")
        if self.attentive_masking and not deterministic:
            input_ids, lm_labels = self.attentive_mask(
                batch.get("caption_raw_input_ids", input_ids), input_mask,
                batch.get("caption_segment_ids"), input_ids, lm_labels, generator)
        text = self.base.forward_text_encoder(input_ids, input_mask,
                                              batch.get("caption_segment_ids"))
        video = self.base.forward_img_encoder(batch["image_data"])
        out: Dict[str, Any] = {"text_embed": text["text_embed"],
                               "visual_embed": video["clip_embed"].mean(dim=1)}
        if self.with_vtc:
            sim = clip_similarity(text["text_embed"], video["clip_embed"], self.logit_scale)
            out["l1_simi"] = out["sim"] = sim
            losses["vtc_loss"] = symmetric_cross_en(sim)

        B = input_ids.shape[0]
        vis_tokens = video["visual_tokens"]  # [B, F, Lv, C]
        F, Lv = vis_tokens.shape[1], vis_tokens.shape[2]
        vis_seq = vis_tokens.reshape(B, F * Lv, -1)
        video_mask = batch.get("video_mask")
        if video_mask is None:
            video_mask = torch.ones(B, F, dtype=torch.long, device=vis_seq.device)
        vis_mask = video_mask.repeat_interleave(Lv, dim=1)  # each frame's mask over its tokens

        if self.with_vtm:
            labels, vtm_vis = self.vtm_pairs(vis_seq)
            cross = self.base.forward_cross_encoder(text["sequence_output"], input_mask,
                                                    vtm_vis, vis_mask)
            itm_logits = self.itm_head(cross["cross_pooled"])
            scored = ITMHead.loss_metric(itm_logits, labels)
            losses.update(scored["losses"])
            metrics.update(scored["metrics"])
            out["itm_logits"] = itm_logits

        if self.with_mlm and lm_labels is not None:
            cross = self.base.forward_cross_encoder(text["sequence_output"], input_mask,
                                                    vis_seq, vis_mask)
            mlm_logits = self.mlm_head(cross["cross_sequence"][:, :input_ids.shape[1]],
                                       self.word_embedding_table())
            scored = MLMHead.loss_metric(mlm_logits, lm_labels)
            losses["masked_lm_loss"] = scored["losses"]["masked_lm_loss"]
            metrics["masked_lm_acc"] = scored["metrics"]["masked_lm_acc"]
            out["mlm_logits"] = mlm_logits

        if self.dual_mlm and lm_labels is not None:
            text_logits = self.text_mlm_head(text["sequence_output"],
                                             self.word_embedding_table())
            scored = MLMHead.loss_metric(text_logits, lm_labels)
            losses["text_masked_lm_loss"] = scored["losses"]["masked_lm_loss"]
            metrics["text_masked_lm_acc"] = scored["metrics"]["masked_lm_acc"]

        if self.with_fom:
            frames = video["frame_pooled"]  # [B, F, C]
            steps = torch.arange(F, device=frames.device)
            if deterministic:
                perm, shuffle = steps, torch.zeros(B, dtype=torch.bool, device=frames.device)
            else:
                perm, shuffle = self.fom_order(B, F, frames.device, generator)
            feats = torch.where(shuffle[:, None, None], frames[:, perm], frames)
            targets = torch.where(shuffle[:, None], perm[None, :], steps[None, :])
            fom_logits = self.fom_head(feats)[:, :, :F]
            scored = FOMHead.loss_metric(fom_logits, targets, shuffle[:, None].expand(B, F))
            losses["fom_loss"] = scored["losses"]["fom_loss"]
            metrics["fom_acc"] = scored["metrics"]["fom_acc"]

        out["losses"] = losses
        out["metrics"] = metrics
        out["logits"] = out.get("sim", next(iter(losses.values())))
        return out
