"""Pink instruction-tuning dataset: per-format adapters and the seeded
interleave of several sources.

Port of ``antmmf_tpu/datasets/pink_instruct_dataset.py`` (builder
``pink_instruct``). Each source is a jsonl file with a ``format``:

* ``vqa``: the question inside ``<qes>…</qes>`` in one of
  ``VQA_INSTRUCTIONS`` (or, without ``add_marks``, with the single-word
  hint), the first of ``answers`` or ``answer``;
* ``caption``: one of ``CAPTION_INSTRUCTIONS``, the caption;
* ``grounding``: ``<des>expr</des>`` in a grounding template, the
  serialised box as the answer;
* ``region_caption``: the serialised box in a region template, the caption;
* ``pointing``: the question and a point (or box) normalised by the raw
  width and height, no ``expand2square``; the answer;
* ``conversations``: the row's turns as they are.

``interleave_index`` orders the global rows: round robin without weights,
else a source drawn a row from ``default_rng(seed)`` by weight;
``first_exhausted`` stops at the first source used up, ``all_exhausted``
restarts used-up sources until every one has been used up once. Each item
draws its template from ``default_rng((seed, idx))``, so an item is the
same in every run and every worker. A row's image is read with OpenCV,
resized, centre-cropped and normalised; a row without an image, or a file
that does not read, gives a black frame; ``image_data`` is [1, H, W, C]. A
row that names an image where OpenCV is missing raises.
"""

from __future__ import annotations

import json
import os
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from antmmf_torch.common.registry import registry
from antmmf_torch.datasets.base_dataset import BaseDataset
from antmmf_torch.datasets.base_dataset_builder import BaseDatasetBuilder
from antmmf_torch.datasets.processors.image_processors import NormalizedImageProcessor, cv2
from antmmf_torch.datasets.processors.pink_conversation import PinkConversationProcessor
from antmmf_torch.datasets.processors.pink_processors import (
    REGION_CAPTION_TEMPLATES,
    VISUAL_GROUNDING_TEMPLATES,
    serialize_box,
)
from antmmf_torch.structures.sample import Sample

BEGIN_QUESTION, END_QUESTION = "<qes>", "</qes>"
BEGIN_DESCRIPTION, END_DESCRIPTION = "<des>", "</des>"
BEGIN_LOC, END_LOC = "<loc>", "</loc>"

VQA_INSTRUCTIONS = (
    "Please answer this question about the image: <question>",
    "Look at the image and give a short answer: <question>",
    "Based on the image, answer briefly: <question>",
)
CAPTION_INSTRUCTIONS = (
    "Describe the image briefly.",
    "Give a short caption for this image.",
    "What is shown in the image?",
)


def interleave_index(lengths: Sequence[int], probabilities: Optional[Sequence[float]] = None,
                     seed: int = 42, stopping_strategy: str = "all_exhausted") -> np.ndarray:
    """The global row order that interleaves the sources (see the module
    docstring); int64."""
    lengths = [int(n) for n in lengths]
    if any(n <= 0 for n in lengths):
        raise ValueError(f"every source needs rows, got lengths={lengths}")
    if stopping_strategy not in ("all_exhausted", "first_exhausted"):
        raise ValueError(f"unknown stopping_strategy {stopping_strategy!r}")
    n = len(lengths)
    offsets = np.cumsum([0] + lengths[:-1])
    oversample = stopping_strategy == "all_exhausted"
    if probabilities is None:
        m = max(lengths) if oversample else min(lengths)
        cols = [offsets[i] + (np.arange(m) % lengths[i]) for i in range(n)]
        return np.stack(cols, axis=1).reshape(-1)
    p = np.asarray(probabilities, np.float64)
    if (p < 0).any() or p.sum() <= 0:
        raise ValueError(f"bad probabilities {probabilities}")
    if not oversample and (p == 0).any():
        raise ValueError("zero probability with first_exhausted never finishes that source")
    p = p / p.sum()
    rng = np.random.default_rng(seed)
    counters = np.zeros(n, np.int64)
    done = np.zeros(n, bool)
    out: List[int] = []
    while True:
        i = int(rng.choice(n, p=p))
        out.append(int(offsets[i] + counters[i] % lengths[i]))
        counters[i] += 1
        if counters[i] >= lengths[i]:
            done[i] = True
            if not oversample or done.all():
                break
    return np.asarray(out, np.int64)


def build_conversations(fmt: str, row: Mapping[str, Any],
                        pick: Callable[[Sequence[str]], str], add_marks: bool = True,
                        expand2square: bool = True) -> Tuple[List[Dict[str, str]], bool]:
    """row → ([{from, value}, ...], has_image) for one example."""
    w = float(row.get("width", 1.0))
    h = float(row.get("height", 1.0))
    if fmt == "conversations":
        return [dict(m) for m in row["conversations"]], \
            bool(row.get("image") or row.get("image_path"))
    if fmt == "vqa":
        q = str(row["question"])
        instr = (pick(VQA_INSTRUCTIONS).replace("<question>", BEGIN_QUESTION + q + END_QUESTION)
                 if add_marks else q + "\nAnswer the question using a single word or phrase.")
        answers = row.get("answers")
        answer = str(answers[0] if answers else row["answer"])
    elif fmt == "caption":
        instr = pick(CAPTION_INSTRUCTIONS)
        answer = str(row["caption"])
    elif fmt == "grounding":
        expr = str(row.get("expr", row.get("caption", "")))
        instr = pick(VISUAL_GROUNDING_TEMPLATES).replace(
            "<expr>", BEGIN_DESCRIPTION + expr + END_DESCRIPTION if add_marks else expr)
        answer = serialize_box(row["bbox"], w, h, expand2square=expand2square)
    elif fmt == "region_caption":
        loc = serialize_box(row["bbox"], w, h, expand2square=expand2square)
        instr = pick(REGION_CAPTION_TEMPLATES).replace("<objs>", loc)
        answer = str(row["caption"])
    elif fmt == "pointing":  # raw 1/width and 1/height, no expand2square
        if "point" in row:
            px, py = row["point"]
            loc = "[{:.3f},{:.3f}]".format(px / w, py / h)
        else:
            b = row["bbox"]
            loc = "[{:.3f},{:.3f},{:.3f},{:.3f}]".format(b[0] / w, b[1] / h, b[2] / w, b[3] / h)
        instr = f"{row['question']} {BEGIN_LOC}{loc}{END_LOC}"
        answer = str(row["answer"])
    else:
        raise KeyError(f"Unknown pink_instruct format {fmt!r}")
    return [{"from": "human", "value": instr}, {"from": "gpt", "value": answer}], True


class PinkInstructDataset(BaseDataset):
    """The interleaved sources as ``PinkModel`` training items: ``input_ids``,
    ``input_mask``, ``labels`` (answer tokens only), ``image_data`` and
    ``id``."""

    def __init__(self, name: str, dataset_type: str, config: Mapping):
        super().__init__(name, dataset_type, config)
        cfg = self.config
        root = cfg.get("data_root_dir", ".")
        self.add_marks = bool(cfg.get("add_marks", True))
        self.expand2square = bool(cfg.get("expand2square", True))
        self.seed = int(cfg.get("seed", 42))
        self.sources: List[Dict[str, Any]] = []
        weights: List[float] = []
        weighted = False
        for src in cfg.get("sources", []):
            path = os.path.join(root, src["annotations"])
            with open(path, encoding="utf-8") as f:
                rows = [json.loads(line) for line in f if line.strip()]
            if not rows:
                raise ValueError(f"empty annotation file {path}")
            self.sources.append({"rows": rows,
                                 "image_dir": os.path.join(root, src.get("image_dir", "")),
                                 "format": str(src.get("format", "vqa"))})
            weights.append(float(src.get("weight", 1.0)))
            weighted = weighted or "weight" in src
        if not self.sources:
            raise ValueError("pink_instruct needs at least one source")
        lengths = [len(s["rows"]) for s in self.sources]
        self._bounds = np.cumsum([0] + lengths)
        self.index_mapping = interleave_index(
            lengths, weights if weighted else None, seed=self.seed,
            stopping_strategy=str(cfg.get("stopping_strategy", "all_exhausted")))
        self.image_processor = NormalizedImageProcessor(dict(cfg.get("image", {"size": 224})))
        self.image_size = int(self.image_processor.size)
        conv_cfg = dict(cfg.get("conversation", {}))
        # the model puts the vision tokens in front of the text, so the
        # prompt carries no <im_patch> placeholders unless asked to
        conv_cfg.setdefault("num_patch_tokens", 0)
        self.conversation = PinkConversationProcessor(conv_cfg)

    def __len__(self) -> int:
        return len(self.index_mapping)

    def _route(self, global_idx: int) -> Tuple[Dict[str, Any], int]:
        src_i = int(np.searchsorted(self._bounds, global_idx, "right")) - 1
        return self.sources[src_i], int(global_idx - self._bounds[src_i])

    def _image(self, src: Mapping[str, Any], row: Mapping[str, Any], has_image: bool
               ) -> np.ndarray:
        name = row.get("image", row.get("image_path"))
        if has_image and name:
            if cv2 is None:
                raise RuntimeError(f"pink_instruct: row names image {name!r}, and reading it "
                                   "needs cv2")
            raw = cv2.imread(os.path.join(src["image_dir"], str(name)))
            if raw is not None:
                return self.image_processor.transform_array(raw[:, :, ::-1])
        return np.zeros((self.image_size, self.image_size, 3), np.float32)

    def get_item(self, idx: int) -> Sample:
        src, row_i = self._route(int(self.index_mapping[idx]))
        row = src["rows"][row_i]
        rng = np.random.default_rng((self.seed, idx))
        convs, has_image = build_conversations(
            src["format"], row, pick=lambda pool: pool[int(rng.integers(0, len(pool)))],
            add_marks=self.add_marks, expand2square=self.expand2square)
        enc = self.conversation({"conversations": convs, "has_image": has_image})
        sample = Sample()
        for key in ("input_ids", "input_mask", "labels"):
            sample[key] = enc[key]
        sample["image_data"] = self._image(src, row, has_image)[None]  # [T=1, H, W, C]
        sample["id"] = np.int64(idx)
        return sample


@registry.register_builder("pink_instruct")
class PinkInstructBuilder(BaseDatasetBuilder):
    def __init__(self, dataset_name: str = "pink_instruct"):
        super().__init__(dataset_name)

    def _load(self, dataset_type: str, config, *args: Any, **kwargs: Any):
        return PinkInstructDataset(self.dataset_name, dataset_type, config)
