"""UniVL ROI: document-image pretraining over region features, OCR and a caption.

Port of ``antmmf_tpu/models/univl_roi.py`` (``UnivlRoiModel``). The caption
runs through the BERT tower; the visual stream of the cross-encoder is, in
this order:

* the detector regions through ``ImageFeatureEncoder``
  (``spatial_projection`` to the visual width, the boxes with their w·h,
  region dropout at the encoder's default rate 0.1, drawn from the
  trainer's generator in training);
* with ``with_grid_stream`` and ``image_data``, the ViT's tokens of every
  frame (frames fold into the batch, as ``forward_img_encoder`` does);
* the OCR wordpieces through BERT's embeddings, with LayoutLM's 2D box
  embeddings summed in before the LayerNorm when the batch has
  ``ocr_bboxes``.

Heads on the cross-encoder: the tied MLM over the caption's positions
(``masked_lm_loss``, ``masked_lm_acc``), ITM on the pooled pair with the
batch's ``itm_labels`` (else ``arange(B) % 2``; ``itm_loss``, ``itm_acc``)
and, with ``with_mrc``, MRC over the region positions, right after the
caption's (``masked_region_classification``, ``mrc_acc``). ``logits`` is
the MLM's, else the ITM's. Without the grid stream the ViT is not built,
as the JAX tree has no parameters for it. ``dropout`` reaches the towers,
the OCR embeddings and the cross-encoder, not the region encoder (which
keeps its own 0.1, as in JAX); a training forward draws every mask from
the same generator.
"""

from __future__ import annotations

import inspect
from typing import Any, Dict, Mapping, Optional

import torch
from torch import nn

from antmmf_torch.common.registry import registry
from antmmf_torch.models.layoutlm import LayoutEmbeddings
from antmmf_torch.models.univl import UnivlVideoBase
from antmmf_torch.modules.encoders.image_feature_encoder import ImageFeatureEncoder
from antmmf_torch.modules.layers import draws
from antmmf_torch.modules.transformers.heads.itm import ITMHead
from antmmf_torch.modules.transformers.heads.mlm import MLMHead
from antmmf_torch.modules.transformers.heads.mrc import MRCHead

REGION_BOX_DIM = 5  # RegionProcessor's boxes: normalised xyxy and the area


@registry.register_model("univl_roi")
class UnivlRoiModel(nn.Module):
    """``from_config`` takes the JAX model's ``model_attributes``; other keys
    are ignored."""

    def __init__(self, vit_preset: str = "vit_base_patch32", image_size: int = 224,
                 bert_preset: str = "bert_base", embed_dim: int = 512, n_clips: int = 1,
                 cross_layers: int = 2, region_dim: int = 2048, with_grid_stream: bool = True,
                 with_mlm: bool = True, with_itm: bool = True, with_mrc: bool = False,
                 region_classes: int = 13, ocr_layout: bool = True,
                 ocr_layout_max_position: int = 1024, dropout: float = 0.0,
                 dtype_str: str = "bfloat16", device=None):
        super().__init__()
        dtype = getattr(torch, dtype_str)
        self.with_grid_stream, self.with_mlm, self.with_itm = with_grid_stream, with_mlm, with_itm
        self.with_mrc, self.ocr_layout = with_mrc, ocr_layout
        self.base = UnivlVideoBase(vit_preset, image_size, bert_preset, embed_dim, n_clips,
                                   with_cross_encoder=True, cross_layers=cross_layers,
                                   dtype=dtype, device=device, cross_sim_head=False,
                                   with_visual=with_grid_stream, dropout=dropout)
        emb = self.base.text_encoder.embeddings.word_embeddings
        vocab, text_hidden = emb.num_embeddings, emb.embedding_dim
        cross_width = self.base.cross_pooler.in_features
        kw = dict(dtype=dtype, device=device)
        self.region_encoder = ImageFeatureEncoder("spatial_projection", region_dim,
                                                  self.base.visual_hidden, REGION_BOX_DIM, **kw)
        if ocr_layout:
            self.ocr_layout_embeddings = LayoutEmbeddings(text_hidden, ocr_layout_max_position,
                                                          **kw)
        if with_mlm:
            self.mlm_head = MLMHead(cross_width, vocab, text_hidden, **kw)
        if with_itm:
            self.itm_head = ITMHead(cross_width, **kw)
        if with_mrc:
            self.mrc_head = MRCHead(cross_width, region_classes, **kw)

    @classmethod
    def from_config(cls, config: Mapping[str, Any], device=None) -> "UnivlRoiModel":
        names = set(inspect.signature(cls.__init__).parameters) - {"self", "device"}
        return cls(device=device, **{k: v for k, v in dict(config).items() if k in names})

    def word_embedding_table(self) -> nn.Parameter:
        """The text tower's word-embedding parameter, which the MLM decodes against."""
        return self.base.text_encoder.embeddings.word_embeddings.weight

    def visual_stream(self, batch: Mapping[str, torch.Tensor], deterministic: bool,
                      generator: Optional[torch.Generator]):
        """(sequence [B, Lv, C], mask [B, Lv]): regions, grid tokens, OCR."""
        streams, masks = [], []

        def ones(t):
            return torch.ones(t.shape[:2], dtype=torch.long, device=t.device)

        if "region_feature" in batch:
            regions = self.region_encoder(batch["region_feature"], batch.get("region_boxes"),
                                          deterministic, generator)
            streams.append(regions)
            masks.append(batch.get("region_mask", ones(regions)))
        if self.with_grid_stream and "image_data" in batch:
            tokens = self.base.forward_img_encoder(batch["image_data"])["visual_tokens"]
            B, F, Lv = tokens.shape[:3]
            streams.append(tokens.reshape(B, F * Lv, -1))
            video_mask = batch.get("video_mask")
            if video_mask is None:
                video_mask = torch.ones(B, F, dtype=torch.long, device=tokens.device)
            masks.append(video_mask.repeat_interleave(Lv, dim=1))
        if "ocr_input_ids" in batch:
            extra = None
            if self.ocr_layout and "ocr_bboxes" in batch:
                extra = self.ocr_layout_embeddings(batch["ocr_bboxes"])
            ocr = self.base.text_encoder.embeddings_apply(batch["ocr_input_ids"], None, extra)
            streams.append(ocr)
            masks.append(batch.get("ocr_input_mask", ones(ocr)))
        return torch.cat(streams, dim=1), torch.cat([m.long() for m in masks], dim=1)

    def forward(self, batch: Mapping[str, torch.Tensor], deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> Dict[str, Any]:
        with draws(generator, active=not deterministic):
            return self._forward(batch, deterministic, generator)

    def _forward(self, batch: Mapping[str, torch.Tensor], deterministic: bool,
                 generator: Optional[torch.Generator]) -> Dict[str, Any]:
        ids, mask = batch["caption_input_ids"], batch["caption_input_mask"]
        B, Lt = ids.shape
        text = self.base.forward_text_encoder(ids, mask, batch.get("caption_segment_ids"))
        visual_seq, visual_mask = self.visual_stream(batch, deterministic, generator)
        cross = self.base.forward_cross_encoder(text["sequence_output"], mask, visual_seq,
                                                visual_mask)
        out: Dict[str, Any] = {"cross_pooled": cross["cross_pooled"],
                               "text_embed": text["text_embed"]}
        losses: Dict[str, torch.Tensor] = {}
        metrics: Dict[str, torch.Tensor] = {}
        lm_labels = batch.get("caption_lm_label_ids")
        if self.with_mlm and lm_labels is not None:
            logits = self.mlm_head(cross["cross_sequence"][:, :Lt], self.word_embedding_table())
            scored = MLMHead.loss_metric(logits, lm_labels)
            losses.update(scored["losses"])
            metrics.update(scored["metrics"])
            out["logits"] = logits
        if self.with_itm:
            labels = batch.get("itm_labels")
            if labels is None:
                labels = torch.arange(B, device=ids.device) % 2
            itm_logits = self.itm_head(cross["cross_pooled"])
            scored = ITMHead.loss_metric(itm_logits, labels.long())
            losses.update(scored["losses"])
            metrics.update(scored["metrics"])
            out.setdefault("logits", itm_logits)
        if self.with_mrc and "region_to_predict" in batch and "region_feature" in batch:
            R = batch["region_feature"].shape[1]
            mrc_logits = self.mrc_head(cross["cross_sequence"][:, Lt:Lt + R])
            scored = self.mrc_head.loss_metric(mrc_logits, batch["region_to_predict"],
                                               batch["region_cls_dis"])
            losses.update(scored["losses"])
            metrics.update(scored["metrics"])
            out["mrc_logits"] = mrc_logits
        out["losses"] = losses
        out["metrics"] = metrics
        return out
