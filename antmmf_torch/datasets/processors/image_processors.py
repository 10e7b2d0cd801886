"""Image processors: host-side resize, crop and normalisation producing
fixed-shape float arrays in HWC layout.

Own copy of the serving path of ``antmmf_tpu/datasets/processors/
image_processors.py``: ``NormalizedImageProcessor.transform_array`` with
what it calls (shorter-side bilinear resize with OpenCV, nearest-neighbour
without it; centre crop, zero-padded when the image is smaller;
normalisation). The ``train_augment`` block belongs to training and raises.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional, Sequence, Tuple

import numpy as np

from antmmf_torch.common.registry import registry
from antmmf_torch.datasets.processors.processors import BaseProcessor

try:
    import cv2
except ImportError:  # the numpy resize below takes over
    cv2 = None

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
NORM_PRESETS = {"imagenet": (IMAGENET_MEAN, IMAGENET_STD), "clip": (CLIP_MEAN, CLIP_STD),
                "none": ((0.0, 0.0, 0.0), (1.0, 1.0, 1.0))}


def _to_float_hwc(image: np.ndarray) -> np.ndarray:
    img = np.asarray(image)
    if img.ndim == 2:
        img = img[:, :, None]
    if img.dtype == np.uint8:
        img = img.astype(np.float32) / 255.0
    return img.astype(np.float32)


def resize_image(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """Bilinear resize to (h, w)."""
    h, w = size
    if cv2 is not None:
        out = cv2.resize(img, (w, h), interpolation=cv2.INTER_LINEAR)
        return out[:, :, None] if out.ndim == 2 else out
    ys = np.linspace(0, img.shape[0] - 1, h).astype(int)
    xs = np.linspace(0, img.shape[1] - 1, w).astype(int)
    return img[ys][:, xs]


def resize_shorter_side(img: np.ndarray, target: int) -> np.ndarray:
    h, w = img.shape[:2]
    if h <= w:
        new_h, new_w = target, max(1, round(w * target / h))
    else:
        new_h, new_w = max(1, round(h * target / w)), target
    return resize_image(img, (new_h, new_w))


def center_crop(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    th, tw = size
    h, w = img.shape[:2]
    if h < th or w < tw:
        img = np.pad(img, ((0, max(0, th - h)), (0, max(0, tw - w)), (0, 0)))
        h, w = img.shape[:2]
    top, left = (h - th) // 2, (w - tw) // 2
    return img[top: top + th, left: left + tw]


def normalize(img: np.ndarray, mean: Sequence[float], std: Sequence[float]) -> np.ndarray:
    mean = np.asarray(mean, dtype=np.float32).reshape(1, 1, -1)
    std = np.asarray(std, dtype=np.float32).reshape(1, 1, -1)
    return (img - mean) / std


@registry.register_processor("normalized_image")
class NormalizedImageProcessor(BaseProcessor):
    """Shorter-side resize → centre crop → normalise; float32 [H, W, 3]."""

    def __init__(self, config: Optional[Mapping[str, Any]] = None):
        super().__init__(config)
        cfg = self.config
        if cfg.get("train_augment"):
            raise NotImplementedError("train_augment is not ported yet")
        self.size = int(cfg.get("size", 224))
        self.resize_target = int(cfg.get("resize", self.size))
        default_mean, default_std = NORM_PRESETS[cfg.get("norm_preset", "imagenet")]
        self.mean = tuple(cfg.get("mean", default_mean))
        self.std = tuple(cfg.get("std", default_std))

    def transform_array(self, img: np.ndarray) -> np.ndarray:
        img = _to_float_hwc(img)
        if img.shape[2] == 1:
            img = np.repeat(img, 3, axis=2)
        img = resize_shorter_side(img, self.resize_target)
        img = center_crop(img, (self.size, self.size))
        return normalize(img, self.mean, self.std)
