"""ROI document-image dataset: region features, OCR lines with layout boxes
and a caption in one sample.

Port of ``antmmf_tpu/datasets/roi_dataset.py`` (``RoiDataset``, builder
``roi_dataset``). Annotation rows (jsonl): ``caption``, ``feature`` (the
path of an ``.npz`` under ``features_root`` holding ``features`` [M, D],
``bbox`` [M, 4] absolute xyxy, ``cls_prob`` [M, C], ``image_height``,
``image_width``), optional ``ocr_text`` / ``ocr_box`` lines, ``label`` and
``id``. A sample holds the ``univl_roi`` batch fields: ``region_*``
(``RegionProcessor``), ``ocr_input_ids``/``_mask``/``ocr_bboxes``
(``OCRProcessor``), ``caption_*`` with ``caption_raw_input_ids``,
``itm_labels``, and ``targets`` and ``id``.

In pretraining and training, the draws come in the JAX dataset's order:
the region masking from the region processor's generator; the ITM swap
from the dataset's (``random()`` below ``itm_swap_prob``, then
``integers(0, len)``: the caption and the OCR lines of that row replace
this row's, label 0, unless the row drawn is this one, label 1); then the
caption's MLM masking from ``MaskedTokenProcessor``'s own generator, and
the raw ids at probability 0, which draws nothing.
"""

from __future__ import annotations

import os
from typing import Any, Mapping

import numpy as np

from antmmf_torch.common.registry import registry
from antmmf_torch.datasets.base_dataset import BaseDataset
from antmmf_torch.datasets.base_dataset_builder import BaseDatasetBuilder
from antmmf_torch.datasets.database.annotated import AnnotatedDatabase
from antmmf_torch.datasets.processors.region_processors import OCRProcessor, RegionProcessor
from antmmf_torch.datasets.processors.text_processors import DEFAULT_VOCAB, MaskedTokenProcessor
from antmmf_torch.structures.sample import Sample


class RoiDataset(BaseDataset):
    def __init__(self, name: str, dataset_type: str, config: Mapping):
        super().__init__(name, dataset_type, config)
        cfg = self.config
        root = cfg.get("data_root_dir", ".")
        ann_cfg = cfg.get("annotations", {})
        ann_path = ann_cfg.get(dataset_type) or ann_cfg.get("train")
        if ann_path is None:
            raise ValueError(f"No annotation path for {dataset_type!r}")
        self.annotations = AnnotatedDatabase(os.path.join(root, ann_path))
        self.features_root = os.path.join(root, cfg.get("features_root", ""))
        self.region_processor = RegionProcessor(dict(cfg.get("region", {})))
        self.use_ocr = bool(cfg.get("use_ocr", True))
        if self.use_ocr:
            self.ocr_processor = OCRProcessor(dict(cfg.get("ocr", {})))
        text_cfg = dict(cfg.get("text", {}))
        text_cfg.setdefault("vocab_file", DEFAULT_VOCAB)
        text_cfg.setdefault("max_seq_length", int(cfg.get("max_text_len", 30)))
        self.caption_processor = MaskedTokenProcessor(text_cfg)
        self.pretraining = bool(cfg.get("pretraining", False))
        self.itm_swap_prob = float(cfg.get("itm_swap_prob", 0.5))
        self.rng = np.random.default_rng(cfg.get("seed", 1234))

    def __len__(self) -> int:
        return len(self.annotations)

    def _load_feature_item(self, ann: Mapping[str, Any]) -> Mapping[str, Any]:
        with np.load(os.path.join(self.features_root, str(ann["feature"]))) as z:
            return {k: z[k] for k in z.files}

    def get_item(self, idx: int) -> Sample:
        ann = self.annotations[idx]
        sample = Sample()
        feat_item = self._load_feature_item(ann)
        train = self.pretraining and self.is_training()
        sample.update(self.region_processor(feat_item, mask_regions=train))

        itm_label, src = 1, ann
        if train and len(self) > 1 and self.rng.random() < self.itm_swap_prob:
            j = int(self.rng.integers(0, len(self)))
            if j != idx:
                itm_label, src = 0, self.annotations[j]
        sample["itm_labels"] = np.int64(itm_label)

        if self.use_ocr:
            h = feat_item.get("image_height", src.get("image_height", 1.0))
            w = feat_item.get("image_width", src.get("image_width", 1.0))
            sample.update(self.ocr_processor({
                "ocr_text": src.get("ocr_text", []), "ocr_box": src.get("ocr_box", []),
                "image_height": float(np.asarray(h).reshape(-1)[0]),
                "image_width": float(np.asarray(w).reshape(-1)[0])}))

        caption = str(src.get("caption", src.get("text", "")))
        masked = self.caption_processor({"text": caption}, probability=None if train else 0.0)
        raw = self.caption_processor({"text": caption}, probability=0.0)
        for key in ("input_ids", "input_mask", "segment_ids", "lm_label_ids"):
            sample[f"caption_{key}"] = masked[key]
        sample["caption_raw_input_ids"] = raw["input_ids"]
        if "label" in ann:
            sample["targets"] = np.int64(ann["label"])
        sample["id"] = np.int64(ann.get("id", idx))
        return sample


@registry.register_builder("roi_dataset")
class RoiDatasetBuilder(BaseDatasetBuilder):
    def __init__(self, dataset_name: str = "roi_dataset"):
        super().__init__(dataset_name)

    def _load(self, dataset_type: str, config, *args: Any, **kw: Any):
        return RoiDataset(self.dataset_name, dataset_type, config)
