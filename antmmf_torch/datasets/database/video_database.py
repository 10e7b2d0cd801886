"""Video database: clip-addressable video sources with ClipBERT sparse sampling.

Own copy of ``antmmf_tpu/datasets/database/video_database.py``:
``VideoClipsDatabase`` (n_clips × frames_per_clip sparse sampling of video
files, with time windows), ``KeyFramesDatabase`` (folders of frame images),
``LmdbVideoDatabase`` (packed frame stacks) and the ``MultiSourceLoader``
that dispatches between them. Each database owns a numpy ``Generator``
seeded as in the JAX package, so the same seed samples the same frames.
OpenCV is needed by the ``video`` and ``keyframes`` sources only.
"""

from __future__ import annotations

import io
import os
from typing import Any, List, Optional

import numpy as np

from antmmf_torch.utils.lmdb_lite import open_lmdb
from antmmf_torch.utils.video_utils import VideoReader, sample_clip_indices

try:
    import cv2
except Exception:  # pragma: no cover
    cv2 = None

_IMG_EXTS = (".jpg", ".jpeg", ".png")
_VID_EXTS = (".mp4", ".avi", ".mkv", ".mov", ".webm")


class VideoClipsDatabase:
    """Resolve a clip name to sparse-sampled frames.

    ``get(name, n_clips, frames_per_clip, ...)`` → uint8
    [n_clips, frames_per_clip, H, W, 3]; supports time windows (start/end secs).
    """

    def __init__(self, video_root: str, strategy: str = "uniform",
                 seed: Optional[int] = None):
        self.video_root = video_root
        self.strategy = strategy
        self.rng = np.random.default_rng(seed)

    def resolve(self, name: str) -> str:
        path = name if os.path.isabs(name) else os.path.join(self.video_root, name)
        if os.path.exists(path):
            return path
        base, ext = os.path.splitext(path)
        if not ext:
            for e in _VID_EXTS:
                if os.path.exists(base + e):
                    return base + e
        raise FileNotFoundError(f"Video not found: {name!r} under {self.video_root!r}")

    def get(
        self,
        name: str,
        n_clips: int = 1,
        frames_per_clip: int = 8,
        start: Optional[float] = None,
        end: Optional[float] = None,
        is_training: bool = False,
    ) -> np.ndarray:
        strategy = "random" if is_training else self.strategy
        with VideoReader(self.resolve(name)) as vr:
            lo = 0 if start is None else int(max(0.0, start) * vr.fps)
            hi = vr.num_frames if end is None else min(vr.num_frames, int(end * vr.fps) + 1)
            hi = max(hi, lo + 1)
            idx = lo + sample_clip_indices(hi - lo, n_clips, frames_per_clip,
                                           strategy, self.rng)
            flat = vr.read_frames(idx.reshape(-1))
        return flat.reshape(n_clips, frames_per_clip, *flat.shape[1:])


class KeyFramesDatabase:
    """Pre-extracted keyframes: a directory of ordered frame images per clip."""

    def __init__(self, frames_root: str, seed: Optional[int] = None):
        self.frames_root = frames_root
        self.rng = np.random.default_rng(seed)

    def list_frames(self, name: str) -> List[str]:
        d = os.path.join(self.frames_root, name)
        if not os.path.isdir(d):
            raise FileNotFoundError(f"Keyframe dir not found: {d!r}")
        files = sorted(
            f for f in os.listdir(d) if f.lower().endswith(_IMG_EXTS)
        )
        return [os.path.join(d, f) for f in files]

    def get(self, name: str, n_clips: int = 1, frames_per_clip: int = 8,
            is_training: bool = False, **_: Any) -> np.ndarray:
        if cv2 is None:
            raise RuntimeError("the keyframes source needs cv2 to read its images")
        files = self.list_frames(name)
        idx = sample_clip_indices(
            len(files), n_clips, frames_per_clip,
            "random" if is_training else "uniform", self.rng
        )
        frames = []
        for i in idx.reshape(-1):
            bgr = cv2.imread(files[int(i)], cv2.IMREAD_COLOR)
            frames.append(bgr[:, :, ::-1].copy())
        flat = np.stack(frames)
        return flat.reshape(n_clips, frames_per_clip, *flat.shape[1:])


class LmdbVideoDatabase:
    """Packed-frames LMDB source. Keys are clip names without their
    extension; values are npy-encoded uint8 frame stacks [F, H, W, 3].
    Reads through ``utils.lmdb_lite.open_lmdb`` (real lmdb when installed,
    the pure-Python reader otherwise); needs no image or video decoder."""

    def __init__(self, db_path: str, seed: Optional[int] = None, **_: Any):
        self.env = open_lmdb(db_path)
        self.rng = np.random.default_rng(seed)

    def get(self, name: str, n_clips: int = 1, frames_per_clip: int = 8,
            is_training: bool = False, **_: Any) -> np.ndarray:
        key = os.path.splitext(name)[0]
        buf = self.env.get(key.encode())
        if buf is None:
            raise KeyError(f"Clip {key!r} not in lmdb")
        frames = np.load(io.BytesIO(buf), allow_pickle=False)
        idx = sample_clip_indices(
            frames.shape[0], n_clips, frames_per_clip,
            "random" if is_training else "uniform", self.rng)
        flat = frames[idx.reshape(-1)]
        return flat.reshape(n_clips, frames_per_clip, *flat.shape[1:])


class MultiSourceLoader:
    """Dispatch clip loads across source kinds: video files, keyframe dirs or
    LMDB; ``auto`` takes a sibling ``<root>_keyframes`` tree when there is
    one, else the video files."""

    def __init__(self, root: str, source: str = "auto", **kwargs: Any):
        if source == "auto":
            kf_root = root.rstrip("/") + "_keyframes"
            source = "keyframes" if os.path.isdir(kf_root) else "video"
            if source == "keyframes":
                root = kf_root
        self.source = source
        if source == "video":
            self.db: Any = VideoClipsDatabase(root, **kwargs)
        elif source == "keyframes":
            self.db = KeyFramesDatabase(root, **kwargs)
        elif source == "lmdb":
            self.db = LmdbVideoDatabase(root, **kwargs)
        else:
            raise ValueError(f"Unknown video source {source!r}")

    def get(self, name: str, **kwargs: Any) -> np.ndarray:
        return self.db.get(name, **kwargs)
