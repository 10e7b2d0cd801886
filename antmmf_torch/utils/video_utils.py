"""Host-side video decode and temporal sampling.

Own copy of ``antmmf_tpu/utils/video_utils.py``: ``sample_frame_indices``
and ``sample_clip_indices`` (ClipBERT sparse sampling) make the same numpy
``Generator`` draws, so the same seed picks the same frames; ``VideoReader``
decodes with OpenCV when it is installed (the ``lmdb`` source of packed
frames needs no decoder). Frames come back RGB uint8 HWC.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

try:
    import cv2
except Exception:  # pragma: no cover
    cv2 = None


def sample_frame_indices(
    num_available: int,
    num_frames: int,
    strategy: str = "uniform",
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """Pick ``num_frames`` indices from ``[0, num_available)``.

    uniform    — evenly spaced (eval default)
    random     — one uniform draw inside each of num_frames equal bins (train)
    fix_start  — consecutive run from 0
    """
    if num_available <= 0:
        return np.zeros((num_frames,), dtype=np.int64)
    if strategy == "uniform":
        idx = np.linspace(0, num_available - 1, num_frames)
        return np.round(idx).astype(np.int64)
    if strategy == "random":
        rng = rng or np.random.default_rng()
        edges = np.linspace(0, num_available, num_frames + 1)
        idx = [
            int(rng.integers(int(edges[i]), max(int(edges[i]) + 1, int(edges[i + 1]))))
            for i in range(num_frames)
        ]
        return np.clip(np.asarray(idx, dtype=np.int64), 0, num_available - 1)
    if strategy == "fix_start":
        return np.clip(np.arange(num_frames, dtype=np.int64), 0, num_available - 1)
    raise ValueError(f"Unknown sampling strategy {strategy!r}")


def sample_clip_indices(
    num_available: int,
    n_clips: int,
    frames_per_clip: int,
    strategy: str = "uniform",
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """ClipBERT sparse sampling: split the video into ``n_clips`` segments and draw
    ``frames_per_clip`` frames inside each. Returns int64[n_clips, frames_per_clip]."""
    edges = np.linspace(0, num_available, n_clips + 1)
    out = np.zeros((n_clips, frames_per_clip), dtype=np.int64)
    for c in range(n_clips):
        lo, hi = int(edges[c]), max(int(edges[c]) + 1, int(edges[c + 1]))
        out[c] = lo + sample_frame_indices(hi - lo, frames_per_clip, strategy, rng)
    return np.clip(out, 0, max(0, num_available - 1))


class VideoReader:
    """Decode selected frames from a video file.

    Usage::

        vr = VideoReader(path)
        frames = vr.read_frames(indices)              # uint8 [N, H, W, 3] RGB
        frames = vr.sample(num_frames=8)              # uniform over full video
        frames = vr.sample(8, start=1.0, end=3.5)     # time-windowed
    """

    def __init__(self, path: str):
        if cv2 is None:
            raise RuntimeError("cv2 is required for video decode")
        self.path = path
        cap = cv2.VideoCapture(path)
        if not cap.isOpened():
            raise FileNotFoundError(f"Cannot open video {path!r}")
        self.fps = cap.get(cv2.CAP_PROP_FPS) or 25.0
        self.num_frames = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
        self.height = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
        self.width = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
        self._cap = cap

    def close(self) -> None:
        if self._cap is not None:
            self._cap.release()
            self._cap = None

    def __enter__(self) -> "VideoReader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    @property
    def duration(self) -> float:
        return self.num_frames / max(self.fps, 1e-6)

    def read_frames(self, indices: Sequence[int]) -> np.ndarray:
        """Sequential-seek decode of the requested (sorted-unique) frame indices,
        then gather back to the requested order."""
        order = np.asarray(indices, dtype=np.int64).reshape(-1)
        uniq = np.unique(order)
        frames = {}
        cap = self._cap
        # Sequential scan with grab()/retrieve(): h264-class codecs force
        # decoding every frame in the span anyway (seeks restart from the
        # previous keyframe and are slower in practice), but grab() skips the
        # colour conversion for frames we don't keep. Very sparse requests on
        # long videos (avg gap > 300 frames) fall back to seeking.
        span = int(uniq[-1] - uniq[0]) if len(uniq) else 0
        avg_gap = span / max(len(uniq), 1)
        if len(uniq) and avg_gap <= 300:
            cap.set(cv2.CAP_PROP_POS_FRAMES, int(uniq[0]))
            pos = int(uniq[0])
            want = set(int(i) for i in uniq)
            last_ok = None
            while want and pos <= int(uniq[-1]):
                if pos in want:
                    ok, frame = cap.read()
                    if not ok:
                        break
                    last_ok = frame
                    frames[pos] = frame[:, :, ::-1].copy()
                    want.discard(pos)
                else:
                    if not cap.grab():
                        break
                pos += 1
            for miss in want:
                if last_ok is not None:
                    frames[miss] = last_ok[:, :, ::-1].copy()
        else:
            for i in uniq:
                cap.set(cv2.CAP_PROP_POS_FRAMES, int(i))
                ok, frame = cap.read()
                if ok:
                    frames[int(i)] = frame[:, :, ::-1].copy()
        if not frames:
            raise RuntimeError(f"Decoded zero frames from {self.path!r}")
        # fill any remaining gaps with nearest decoded frame
        keys = np.asarray(sorted(frames))
        out = []
        for i in order:
            j = int(keys[np.argmin(np.abs(keys - int(i)))])
            out.append(frames[j])
        return np.stack(out)

    def sample(
        self,
        num_frames: int,
        start: Optional[float] = None,
        end: Optional[float] = None,
        strategy: str = "uniform",
        rng: Optional[np.random.Generator] = None,
    ) -> np.ndarray:
        lo = 0 if start is None else int(max(0.0, start) * self.fps)
        hi = self.num_frames if end is None else min(
            self.num_frames, int(end * self.fps) + 1
        )
        hi = max(hi, lo + 1)
        rel = sample_frame_indices(hi - lo, num_frames, strategy, rng)
        return self.read_frames(lo + rel)

    def sample_clips(
        self,
        n_clips: int,
        frames_per_clip: int,
        strategy: str = "uniform",
        rng: Optional[np.random.Generator] = None,
    ) -> np.ndarray:
        """uint8 [n_clips, frames_per_clip, H, W, 3]."""
        idx = sample_clip_indices(self.num_frames, n_clips, frames_per_clip, strategy, rng)
        flat = self.read_frames(idx.reshape(-1))
        return flat.reshape(n_clips, frames_per_clip, *flat.shape[1:])
