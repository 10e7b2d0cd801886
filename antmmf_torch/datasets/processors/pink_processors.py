"""Pink referential-comprehension processors: boxes to text and back, and
the grounding / region-caption prompts.

Own copy of ``antmmf_tpu/datasets/processors/pink_processors.py``: a box is
normalised to [0, 1] (by default inside the square that ``expand2square``
pads the image to) and written into the text as ``<loc>[x1,y1,x2,y2]</loc>``
with 3 decimals; ``parse_boxes`` reads every ``[x1,y1,x2,y2]`` of generated
text back into pixel boxes. ``pink_box`` and ``pink_prompt`` are the
registered processors; ``pink_prompt`` picks its instruction from the
template pools with its own numpy ``default_rng(seed)``, one
``integers(0, len(pool))`` an item, as the JAX processor draws.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np

from antmmf_torch.common.registry import registry
from antmmf_torch.datasets.processors.processors import BaseProcessor
from antmmf_torch.utils.conversation import get_conv_template

BEGIN_LOC, END_LOC = "<loc>", "</loc>"

VISUAL_GROUNDING_TEMPLATES = (
    "Where is <expr>?",
    "Where is <expr>? answer in [x0,y0,x1,y1] format.",
    "What are the coordinates of <expr> in the image?",
    "Can you point out <expr> in the image and provide the coordinates of "
    "its location?",
    "Please, point out the position of <expr> in the image by giving its "
    "coordinates.",
)
REGION_CAPTION_TEMPLATES = (
    "Describe the region <objs> in the image.",
    "What is in the region <objs>?",
    "Give a short description of the area <objs>.",
)

_BOX_RE = re.compile(r"\[\s*([0-9.]+)\s*,\s*([0-9.]+)\s*,\s*([0-9.]+)\s*,\s*([0-9.]+)\s*\]")


def expand2square_offset(width: float, height: float) -> Tuple[float, float, float]:
    """(offset_x, offset_y, scale) from pixel coordinates into the square-padded
    normalised frame."""
    side = max(width, height)
    return (side - width) / 2.0, (side - height) / 2.0, 1.0 / side


def serialize_box(box: Sequence[float], width: float, height: float,
                  expand2square: bool = True, with_tags: bool = True) -> str:
    """An xyxy pixel box → ``<loc>[x1,y1,x2,y2]</loc>``, normalised, 3 decimals."""
    x1, y1, x2, y2 = [float(v) for v in box]
    if expand2square:
        ox, oy, s = expand2square_offset(width, height)
        scaled = [(x1 + ox) * s, (y1 + oy) * s, (x2 + ox) * s, (y2 + oy) * s]
    else:
        scaled = [x1 / width, y1 / height, x2 / width, y2 / height]
    body = "[{:.3f},{:.3f},{:.3f},{:.3f}]".format(*scaled)
    return BEGIN_LOC + body + END_LOC if with_tags else body


def parse_boxes(text: str, width: float = 1.0, height: float = 1.0,
                expand2square: bool = True) -> np.ndarray:
    """Every ``[x1,y1,x2,y2]`` of ``text`` → pixel xyxy boxes float32 [N, 4]."""
    boxes = []
    for m in _BOX_RE.finditer(text):
        x1, y1, x2, y2 = (float(g) for g in m.groups())
        if expand2square:
            side = max(width, height)
            ox, oy = (side - width) / 2.0, (side - height) / 2.0
            boxes.append([x1 * side - ox, y1 * side - oy, x2 * side - ox, y2 * side - oy])
        else:
            boxes.append([x1 * width, y1 * height, x2 * width, y2 * height])
    return np.asarray(boxes, np.float32).reshape(-1, 4)


@registry.register_processor("pink_box")
class PinkBoxProcessor(BaseProcessor):
    """{'box', 'width', 'height'} → {'location_tokens'}; ``parse`` reads back."""

    def __init__(self, config: Optional[Mapping[str, Any]] = None, *args, **kwargs):
        super().__init__(config)
        self.expand2square = bool(self.config.get("expand2square", True))
        self.with_tags = bool(self.config.get("with_tags", True))

    def __call__(self, item: Mapping[str, Any], *args, **kwargs) -> Dict[str, Any]:
        return {"location_tokens": serialize_box(item["box"], item["width"], item["height"],
                                                 self.expand2square, self.with_tags)}

    def parse(self, text: str, width: float = 1.0, height: float = 1.0) -> np.ndarray:
        return parse_boxes(text, width, height, self.expand2square)


@registry.register_processor("pink_prompt")
class PinkPromptProcessor(BaseProcessor):
    """{task: visual_grounding | region_caption, expr | phrase, box, width,
    height} → {"prompt", "answer", "text"}, ``text`` the whole conversation
    under ``conv_template``."""

    def __init__(self, config: Optional[Mapping[str, Any]] = None, *args, **kwargs):
        super().__init__(config)
        self.template = str(self.config.get("conv_template", "vicuna_v1"))
        self.expand2square = bool(self.config.get("expand2square", True))
        self.rng = np.random.default_rng(self.config.get("seed"))

    def __call__(self, item: Mapping[str, Any], *args, **kwargs) -> Dict[str, Any]:
        task = item.get("task", "visual_grounding")
        loc = serialize_box(item["box"], item["width"], item["height"], self.expand2square)
        if task == "visual_grounding":
            pool = VISUAL_GROUNDING_TEMPLATES
            q = pool[int(self.rng.integers(0, len(pool)))].replace(
                "<expr>", str(item.get("expr", item.get("phrase", ""))))
            answer = loc
        elif task == "region_caption":
            pool = REGION_CAPTION_TEMPLATES
            q = pool[int(self.rng.integers(0, len(pool)))].replace("<objs>", loc)
            answer = str(item.get("phrase", item.get("caption", "")))
        else:
            raise KeyError(f"Unknown pink task {task!r}")
        conv = get_conv_template(self.template)
        conv.append_message(conv.roles[0], q)
        conv.append_message(conv.roles[1], answer)
        return {"prompt": q, "answer": answer, "text": conv.get_prompt()}
