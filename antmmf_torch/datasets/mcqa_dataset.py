"""Multiple-choice video QA dataset (MSR-VTT MC format).

Port of ``antmmf_tpu/datasets/mcqa_dataset.py`` (fixture
``tests/data/video/msrvtt_multi_choice_qa.jsonl``: {qid, clip_name,
options[5], answer}). A sample holds:

  image_data          float32[F, H, W, 3]  (F = n_clips · frames_per_clip)
  video_mask          int64[F]
  options_input_ids / options_input_mask   int64[n_options, L] (unmasked;
                      missing options are empty strings)
  targets             int64 scalar (the answer's index)
  qid                 str

Clips come through ``MultiSourceLoader`` seeded from the config's ``seed``
and the options through ``MaskedTokenProcessor`` at probability 0, in the
JAX dataset's order, so a batch equals the JAX one.
"""

from __future__ import annotations

import os
from typing import Any, Mapping

import numpy as np

from antmmf_torch.common.registry import registry
from antmmf_torch.datasets.base_dataset import BaseDataset
from antmmf_torch.datasets.base_dataset_builder import BaseDatasetBuilder
from antmmf_torch.datasets.database.annotated import AnnotatedDatabase
from antmmf_torch.datasets.database.video_database import MultiSourceLoader
from antmmf_torch.datasets.processors.image_processors import NormalizedImageProcessor
from antmmf_torch.datasets.processors.text_processors import DEFAULT_VOCAB, MaskedTokenProcessor
from antmmf_torch.structures.sample import Sample


class MultiChoiceQADataset(BaseDataset):
    def __init__(self, name: str, dataset_type: str, config: Mapping):
        super().__init__(name, dataset_type, config)
        cfg = self.config
        root = cfg.get("data_root_dir", ".")
        annotations = cfg.get("annotations", {})
        ann = annotations.get(dataset_type) or annotations.get("train")
        self.annotations = AnnotatedDatabase(os.path.join(root, ann))
        self.video_db = MultiSourceLoader(os.path.join(root, cfg.get("video_root", "")),
                                          source=cfg.get("video_source", "auto"),
                                          seed=cfg.get("seed", 0))
        self.n_clips = int(cfg.get("n_clips", 1))
        self.frames_per_clip = int(cfg.get("frames_per_clip", 4))
        self.n_options = int(cfg.get("n_options", 5))
        img_cfg = dict(cfg.get("image", {"size": 224}))
        if dataset_type != "train":  # augmentation is train-only
            img_cfg.pop("train_augment", None)
        self.image_processor = NormalizedImageProcessor(img_cfg)
        text_cfg = dict(cfg.get("text", {}))
        text_cfg.setdefault("vocab_file", DEFAULT_VOCAB)
        text_cfg.setdefault("max_seq_length", int(cfg.get("max_text_len", 30)))
        self.caption_processor = MaskedTokenProcessor(text_cfg)

    def __len__(self) -> int:
        return len(self.annotations)

    def get_item(self, idx: int) -> Sample:
        ann = self.annotations[idx]
        clips = self.video_db.get(str(ann["clip_name"]), n_clips=self.n_clips,
                                  frames_per_clip=self.frames_per_clip,
                                  is_training=self.is_training())
        frames = clips.reshape((-1,) + clips.shape[2:])
        sample = Sample()
        sample["image_data"] = np.stack([self.image_processor.transform_array(f)
                                         for f in frames]).astype(np.float32)
        sample["video_mask"] = np.ones((frames.shape[0],), np.int64)
        options = list(ann.get("options", []))[: self.n_options]
        options += [""] * (self.n_options - len(options))
        outs = [self.caption_processor({"text": str(opt)}, probability=0.0) for opt in options]
        sample["options_input_ids"] = np.stack([o["input_ids"] for o in outs])
        sample["options_input_mask"] = np.stack([o["input_mask"] for o in outs])
        sample["targets"] = np.int64(int(ann.get("answer", 0)))
        sample["qid"] = str(ann.get("qid", idx))
        return sample


@registry.register_builder("video_mcqa")
@registry.register_builder("univl_mcqa")
class MultiChoiceQABuilder(BaseDatasetBuilder):
    def __init__(self, dataset_name: str = "video_mcqa"):
        super().__init__(dataset_name)

    def _load(self, dataset_type: str, config, *args: Any, **kw: Any):
        return MultiChoiceQADataset(self.dataset_name, dataset_type, config)
