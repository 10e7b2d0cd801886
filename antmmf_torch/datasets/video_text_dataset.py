"""Video-text retrieval and pretraining dataset (MSR-VTT jsonl format).

Port of ``antmmf_tpu/datasets/video_text_dataset.py`` for video media. A
sample holds the batch schema of the JAX package (fixed shapes):

  image_data        float32[F, H, W, 3]   (F = n_clips * frames_per_clip; NHWC)
  video_mask        int64[F]
  caption_input_ids / caption_input_mask / caption_segment_ids /
  caption_lm_label_ids                    int64[L] (masked when ``mlm`` is on)
  caption_raw_input_ids                   int64[L] (never masked)
  image_vid         int64 scalar: the unique-video id (multi-gt retrieval eval)
  caption_tid       int64 scalar: the caption id
  targets           int64 scalar (when the annotation has a label)

Clips come through ``MultiSourceLoader`` (``video_source``: ``video``,
``keyframes``, ``lmdb`` or ``auto``), whose numpy ``Generator`` is seeded
from the dataset config's ``seed`` (default 0), as in the JAX package, so
training draws the same random frames. With ``mlm`` (the
``video_text_pretrain`` builder turns it on) training captions are masked
for the masked-LM loss by the caption processor (its ``text`` config);
evaluation captions are not, so their labels are all -1. Image media
(``media_format`` ``image`` or ``mixed``) raises until it is ported.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Mapping

import numpy as np

from antmmf_torch.common.registry import registry
from antmmf_torch.datasets.base_dataset import BaseDataset
from antmmf_torch.datasets.base_dataset_builder import BaseDatasetBuilder
from antmmf_torch.datasets.database.annotated import AnnotatedDatabase
from antmmf_torch.datasets.database.video_database import MultiSourceLoader
from antmmf_torch.datasets.processors.image_processors import NormalizedImageProcessor
from antmmf_torch.datasets.processors.text_processors import MaskedTokenProcessor
from antmmf_torch.structures.sample import Sample


class VideoTextDataset(BaseDataset):
    def __init__(self, name: str, dataset_type: str, config: Mapping):
        super().__init__(name, dataset_type, config)
        cfg = self.config
        self.media_format = cfg.get("media_format", "video")
        if self.media_format != "video":
            raise NotImplementedError(f"media_format {self.media_format!r} is not ported yet; "
                                      f"video is")
        root = cfg.get("data_root_dir", ".")
        ann_cfg = cfg.get("annotations", {})
        ann_path = ann_cfg.get(dataset_type) or ann_cfg.get("train")
        if ann_path is None:
            raise ValueError(f"No annotation path for {dataset_type!r}")
        self.annotations = AnnotatedDatabase(os.path.join(root, ann_path))
        media_root = os.path.join(root, cfg.get("video_root", cfg.get("image_root", "")))
        self.video_db = MultiSourceLoader(media_root, source=cfg.get("video_source", "auto"),
                                          seed=cfg.get("seed", 0))
        # ASR transcripts (one json {start[], end[], text[]} per clip) stand in
        # for an empty caption
        self.asr_root = cfg.get("asr_root")
        if self.asr_root is not None:
            self.asr_root = os.path.join(root, self.asr_root)

        self.n_clips = int(cfg.get("n_clips", 1))
        self.frames_per_clip = int(cfg.get("frames_per_clip", cfg.get("num_frames", 4)))
        img_cfg = dict(cfg.get("image", {"size": 224}))
        if dataset_type != "train":  # augmentation is train-only
            img_cfg.pop("train_augment", None)
        self.image_processor = NormalizedImageProcessor(img_cfg)

        text_cfg = dict(cfg.get("text", {}))
        text_cfg.setdefault("vocab_file", "tests/data/vocabs/bert-base-uncased_30522_vocab.txt")
        text_cfg.setdefault("max_seq_length", int(cfg.get("max_text_len", 30)))
        self.caption_processor = MaskedTokenProcessor(text_cfg)
        self.mlm = bool(cfg.get("mlm", False))

        # caption → unique-video grouping for multi-gt retrieval eval
        self.video_ids: List[int] = []
        uniq: Dict[str, int] = {}
        for ann in self.annotations.data:
            key = str(ann.get("clip_name", ann.get("image", "")))
            if key not in uniq:
                uniq[key] = len(uniq)
            self.video_ids.append(uniq[key])
        self.num_unique_videos = len(uniq)

    def __len__(self) -> int:
        return len(self.annotations)

    def get_label(self, idx: int):
        return self.annotations[idx].get("label", 0)

    def _load_frames(self, ann: Mapping) -> np.ndarray:
        clips = self.video_db.get(str(ann["clip_name"]), n_clips=self.n_clips,
                                  frames_per_clip=self.frames_per_clip, start=ann.get("start"),
                                  end=ann.get("end"), is_training=self.is_training())
        return clips.reshape((-1,) + clips.shape[2:])  # uint8 [n_clips·fpc, H, W, 3]

    def _asr_caption(self, ann: Mapping) -> str:
        clip = os.path.splitext(str(ann.get("clip_name", "")))[0]
        path = os.path.join(self.asr_root, os.path.basename(clip))
        if not os.path.exists(path):
            return ""
        try:
            with open(path, encoding="utf-8") as f:
                return " ".join(json.load(f).get("text", []))
        except (OSError, ValueError):
            return ""

    def get_item(self, idx: int) -> Sample:
        ann = self.annotations[idx]
        frames = self._load_frames(ann)
        image_data = np.stack([self.image_processor.transform_array(f)
                               for f in frames]).astype(np.float32)

        sample = Sample()
        sample["image_data"] = image_data
        sample["video_mask"] = np.ones((image_data.shape[0],), dtype=np.int64)
        sample["image_vid"] = np.int64(self.video_ids[idx])
        sample["caption_tid"] = np.int64(idx)

        caption = str(ann.get("caption", ann.get("text", "")))
        if not caption and self.asr_root is not None:
            caption = self._asr_caption(ann)
        masked = self.caption_processor(
            {"text": caption}, probability=None if self.mlm and self.is_training() else 0.0)
        raw = self.caption_processor({"text": caption}, probability=0.0)
        for key in ("input_ids", "input_mask", "segment_ids", "lm_label_ids"):
            sample[f"caption_{key}"] = masked[key]
        sample["caption_raw_input_ids"] = raw["input_ids"]
        sample["caption_text"] = caption
        if "label" in ann:
            sample["targets"] = np.int64(ann["label"])
        return sample


@registry.register_builder("video_text_retrieval")
@registry.register_builder("univl_dataset")
class VideoTextRetrievalBuilder(BaseDatasetBuilder):
    def __init__(self, dataset_name: str = "video_text_retrieval"):
        super().__init__(dataset_name)

    def _load(self, dataset_type: str, config, *args: Any, **kw: Any):
        return VideoTextDataset(self.dataset_name, dataset_type, config)


@registry.register_builder("video_text_pretrain")
class VideoTextPretrainBuilder(BaseDatasetBuilder):
    """The same pipeline with MLM caption masking on (pretraining)."""

    def __init__(self, dataset_name: str = "video_text_pretrain"):
        super().__init__(dataset_name)

    def _load(self, dataset_type: str, config, *args: Any, **kw: Any):
        return VideoTextDataset(self.dataset_name, dataset_type, {**config.to_dict(), "mlm": True})
