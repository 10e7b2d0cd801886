"""Region and OCR processors for document images.

Own copy of ``antmmf_tpu/datasets/processors/region_processors.py``:

* ``region_processor``: detector features, absolute xyxy boxes and class
  distributions, cut or zero-padded to ``max_features``; boxes normalised
  by the image size with their area appended (5 wide); in training, each
  real region in turn draws one ``random()`` from the processor's numpy
  generator: below ``mask_region_prob`` it is MRC-supervised, and below
  90 % of that its features are zeroed together with those of every region
  whose IoU with it exceeds ``overlap_threshold``;
* ``ocr_processor``: OCR lines tokenised into wordpieces, each line closed
  by ``line_sep`` (";") and its tokens carrying the line box bucketised
  LayoutLM-style to [0, 1000]; the concatenation is cut to ``max_length``
  (a line can be cut inside) and zero-padded, boxes included.

The same seed gives the same arrays as the JAX package, bit for bit.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np

from antmmf_torch.common.registry import registry
from antmmf_torch.datasets.processors.processors import BaseProcessor
from antmmf_torch.datasets.processors.text_processors import DEFAULT_VOCAB, _resolve_vocab_path
from antmmf_torch.utils.tokenization import BertTokenizer


def _pairwise_iou(boxes: np.ndarray) -> np.ndarray:
    """IoU [M, M] of absolute xyxy boxes [M, 4]."""
    lt = np.maximum(boxes[:, None, :2], boxes[None, :, :2])
    rb = np.minimum(boxes[:, None, 2:], boxes[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area = np.prod(np.clip(boxes[:, 2:] - boxes[:, :2], 0, None), axis=1)
    union = area[:, None] + area[None, :] - inter
    return inter / np.maximum(union, 1e-9)


@registry.register_processor("region_processor")
class RegionProcessor(BaseProcessor):
    """Item {features [M, D], bbox [M, 4] absolute xyxy, cls_prob [M, C],
    image_height, image_width} → region_feature f32[R, D], region_boxes
    f32[R, 5], region_mask and region_to_predict int64[R], region_cls_dis
    f32[R, C] (R = ``max_features``)."""

    def __init__(self, config: Optional[Mapping[str, Any]] = None, *a, **k):
        super().__init__(config)
        cfg = self.config
        self.max_features = int(cfg.get("max_features", 10))
        self.feature_dim = int(cfg.get("feature_dim", 2048))
        self.region_kl_fc_dim = int(cfg.get("region_kl_fc_dim", 13))
        self.mask_region_prob = float(cfg.get("mask_region_prob", 0.15))
        self.overlap_threshold = float(cfg.get("overlap_threshold", 0.4))
        self.rng = np.random.default_rng(cfg.get("seed"))

    def __call__(self, item: Mapping[str, Any], mask_regions: bool = True) -> Dict[str, Any]:
        feats = np.asarray(item["features"], np.float32)
        boxes = np.asarray(item["bbox"], np.float32).reshape(-1, 4)
        cls_prob = np.asarray(item.get("cls_prob",
                                       np.zeros((len(boxes), self.region_kl_fc_dim))),
                              np.float32)
        h = float(item.get("image_height", 1.0))
        w = float(item.get("image_width", 1.0))
        M = min(len(boxes), self.max_features)

        R, D, C = self.max_features, self.feature_dim, self.region_kl_fc_dim
        out_feat = np.zeros((R, feats.shape[-1] if feats.size else D), np.float32)
        out_boxes = np.zeros((R, 5), np.float32)
        out_cls = np.zeros((R, cls_prob.shape[-1] if cls_prob.size else C), np.float32)
        out_mask = np.zeros((R,), np.int64)
        to_predict = np.zeros((R,), np.int64)

        out_feat[:M] = feats[:M]
        out_cls[:M] = cls_prob[:M]
        out_mask[:M] = 1
        nb = boxes[:M] / np.asarray([w, h, w, h], np.float32)
        areas = np.clip(nb[:, 2] - nb[:, 0], 0, None) * np.clip(nb[:, 3] - nb[:, 1], 0, None)
        out_boxes[:M, :4] = nb
        out_boxes[:M, 4] = areas

        if mask_regions and M:
            overlaps = _pairwise_iou(boxes[:M])
            for i in range(M):
                prob = self.rng.random()
                if prob >= self.mask_region_prob:
                    continue
                to_predict[i] = 1
                if prob / self.mask_region_prob < 0.9:
                    out_feat[i] = 0.0
                    for j in np.nonzero(overlaps[i] > self.overlap_threshold)[0]:
                        out_feat[j] = 0.0
        return {"region_feature": out_feat, "region_boxes": out_boxes, "region_mask": out_mask,
                "region_to_predict": to_predict, "region_cls_dis": out_cls}


@registry.register_processor("ocr_processor")
class OCRProcessor(BaseProcessor):
    """Item {ocr_text [str], ocr_box [[x0, y0, x1, y1]] absolute, image_height,
    image_width} → ocr_input_ids and ocr_input_mask int64[L], ocr_bboxes
    int64[L, 4] (L = ``max_length``)."""

    def __init__(self, config: Optional[Mapping[str, Any]] = None, *a, **k):
        super().__init__(config)
        cfg = self.config
        self.tokenizer = BertTokenizer(_resolve_vocab_path(cfg.get("vocab_file", DEFAULT_VOCAB)),
                                       do_lower_case=bool(cfg.get("do_lower_case", True)))
        self.max_length = int(cfg.get("max_length", 64))
        self.line_sep = str(cfg.get("line_sep", ";"))

    def __call__(self, item: Mapping[str, Any]) -> Dict[str, Any]:
        h = float(item.get("image_height", 1.0)) or 1.0
        w = float(item.get("image_width", 1.0)) or 1.0
        tokens: list = []
        tok_boxes: list = []
        for text, box in zip(list(item.get("ocr_text", [])), list(item.get("ocr_box", []))):
            x0, y0, x1, y1 = [float(v) for v in box]
            bucket = [int(min(max(v, 0.0), 1000)) for v in
                      (x0 * 1000.0 / w, y0 * 1000.0 / h, x1 * 1000.0 / w, y1 * 1000.0 / h)]
            pieces = self.tokenizer.tokenize(str(text)) + [self.line_sep]
            tokens.extend(pieces)
            tok_boxes.extend([bucket] * len(pieces))
        L = self.max_length
        ids = self.tokenizer.convert_tokens_to_ids(tokens[:L])
        n = len(ids)
        out_ids = np.zeros((L,), np.int64)
        out_mask = np.zeros((L,), np.int64)
        out_boxes = np.zeros((L, 4), np.int64)
        out_ids[:n] = ids
        out_mask[:n] = 1
        if n:
            out_boxes[:n] = np.asarray(tok_boxes[:L], np.int64)
        return {"ocr_input_ids": out_ids, "ocr_input_mask": out_mask, "ocr_bboxes": out_boxes}
