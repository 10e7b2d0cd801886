"""M2-omni unified preprocessing: the Bailing2 processor.

Own copy of ``antmmf_tpu/datasets/processors/m2omni_processing.py``:

- ``smart_resize`` and ``M2OmniImageProcessor``: dynamic-resolution images
  and videos → flatten patches [t·h·w, C·tps·ps·ps] in the spatial-merge
  order and ``grid_thw``; ``frames_from_patches`` is the exact inverse, the
  dense frames the Qwen2-ViT tower takes;
- in-place ``<image>``/``<video>``/``<audio>`` expansion into patch-token
  runs, the chat and system templates, special-token-aware tokenisation;
- conversation media: ``fetch_image``/``fetch_video``/``sample_frames``/
  ``process_vision_info`` and ``load_wav``.

``resize_bicubic`` is the port's own numpy code, the same on every machine:
Pillow's separable BICUBIC resample (a = −0.5, the support widened by the
scale when shrinking, coefficients normalised and rounded to 22-bit fixed
point, each pass rounded and clipped to 8 bits, the horizontal pass first),
where the JAX package calls Pillow (or OpenCV without it). Media given as a
path are decoded with OpenCV, and raise without it; arrays work everywhere.
"""

from __future__ import annotations

import math
import re
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np

from antmmf_torch.common.registry import registry
from antmmf_torch.datasets.processors.audio_processors import SANMAudioProcessor
from antmmf_torch.datasets.processors.processors import BaseProcessor
from antmmf_torch.datasets.processors.text_processors import MaskedTokenProcessor

try:
    import cv2
except ImportError:  # media paths then raise; arrays need no decoder
    cv2 = None

IMAGE_FACTOR = 28
MIN_PIXELS = 4 * 28 * 28
MAX_PIXELS = 16384 * 28 * 28
MAX_RATIO = 200

VIDEO_MIN_PIXELS = 128 * 28 * 28
VIDEO_MAX_PIXELS = 768 * 28 * 28
VIDEO_TOTAL_PIXELS = 7680 * 28 * 28
FRAME_FACTOR = 2
FPS = 2.0
FPS_MIN_FRAMES = 4
FPS_MAX_FRAMES = 120

DEFAULT_IMAGE_PATCH_TOKEN = "<imagePatch>"
DEFAULT_VIDEO_PATCH_TOKEN = "<videoPatch>"
DEFAULT_IM_START_TOKEN = "<image>"
DEFAULT_IM_END_TOKEN = "</image>"
DEFAULT_VID_START_TOKEN = "<video>"
DEFAULT_VID_END_TOKEN = "</video>"
DEFAULT_AUDIO_PATCH_TOKEN = "<audioPatch>"
DEFAULT_AU_START_TOKEN = "<audio>"
DEFAULT_AU_END_TOKEN = "</audio>"

OPENAI_CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
OPENAI_CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def round_by_factor(number: int, factor: int) -> int:
    return round(number / factor) * factor


def ceil_by_factor(number: int, factor: int) -> int:
    return math.ceil(number / factor) * factor


def floor_by_factor(number: int, factor: int) -> int:
    return math.floor(number / factor) * factor


def smart_resize(height: int, width: int, factor: int = 28, min_pixels: int = 56 * 56,
                 max_pixels: int = 14 * 14 * 4 * 1280) -> Tuple[int, int]:
    """Factor-divisible (height, width), the aspect ratio kept: rounded to
    the factor, then scaled down (floor) when above ``max_pixels`` or up
    (ceil) when below ``min_pixels`` — the up branch can land above
    ``max_pixels``, as the reference's does."""
    if height < factor or width < factor:
        raise ValueError(f"height:{height} or width:{width} must be larger than "
                         f"factor:{factor}")
    if max(height, width) / min(height, width) > MAX_RATIO:
        raise ValueError(f"absolute aspect ratio must be smaller than {MAX_RATIO}, got "
                         f"{max(height, width) / min(height, width)}")
    h_bar = round(height / factor) * factor
    w_bar = round(width / factor) * factor
    if h_bar * w_bar > max_pixels:
        beta = math.sqrt((height * width) / max_pixels)
        h_bar = math.floor(height / beta / factor) * factor
        w_bar = math.floor(width / beta / factor) * factor
    elif h_bar * w_bar < min_pixels:
        beta = math.sqrt(min_pixels / (height * width))
        h_bar = math.ceil(height * beta / factor) * factor
        w_bar = math.ceil(width * beta / factor) * factor
    return h_bar, w_bar


def _to_hwc_uint8(image: Any) -> np.ndarray:
    """An image array (HWC, CHW, grey, RGBA, float in [0, 1] or [0, 255]) →
    HWC uint8 RGB."""
    arr = np.asarray(image)
    if arr.ndim == 2:
        arr = np.stack([arr] * 3, axis=-1)
    if arr.ndim == 3 and arr.shape[0] in (1, 3) and arr.shape[-1] not in (1, 3, 4):
        arr = arr.transpose(1, 2, 0)
    if arr.shape[-1] == 1:
        arr = np.repeat(arr, 3, axis=-1)
    arr = arr[..., :3]
    if arr.dtype != np.uint8:
        if arr.max() <= 1.0:
            arr = (arr * 255.0).round()
        arr = np.clip(arr, 0, 255).astype(np.uint8)
    return arr


# Pillow's fixed-point resample (libImaging/Resample.c): 22 fraction bits
PRECISION_BITS = 32 - 8 - 2


def _bicubic_filter(x: np.ndarray) -> np.ndarray:
    a = -0.5
    x = np.abs(x)
    near = ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    far = (((x - 5) * x + 8) * x - 4) * a
    return np.where(x < 1.0, near, np.where(x < 2.0, far, 0.0))


def _resample_coeffs(in_size: int, out_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """(first source index int[out], fixed-point weights int64[out, ksize]) of
    the bicubic filter mapping ``in_size`` samples onto ``out_size``."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    first = np.zeros(out_size, np.int64)
    kk = np.zeros((out_size, ksize), np.float64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)  # int() truncates, as C's cast
        xmax = min(int(center + support + 0.5), in_size) - xmin
        w = _bicubic_filter((np.arange(xmax) + xmin - center + 0.5) * (1.0 / filterscale))
        total = 0.0
        for value in w:  # in order: numpy's pairwise sum rounds otherwise
            total += value
        kk[xx, :xmax] = w / total if total != 0.0 else w
        first[xx] = xmin
    scaled = kk * (1 << PRECISION_BITS)
    return first, np.trunc(np.where(kk < 0, scaled - 0.5, scaled + 0.5)).astype(np.int64)


def _resample_axis(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One pass along ``axis`` of a uint8 image, rounded and clipped to 8 bits."""
    in_size = img.shape[axis]
    first, kk = _resample_coeffs(in_size, out_size)
    idx = np.minimum(first[:, None] + np.arange(kk.shape[1])[None], in_size - 1)
    src = np.moveaxis(img, axis, 0).astype(np.int64)  # [in, ..., C]
    acc = np.full((out_size,) + src.shape[1:], 1 << (PRECISION_BITS - 1), np.int64)
    for j in range(kk.shape[1]):
        w = kk[:, j].reshape((out_size,) + (1,) * (src.ndim - 1))
        acc += src[idx[:, j]] * w
    out = np.clip(acc >> PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def resize_bicubic(image_hwc: np.ndarray, height: int, width: int) -> np.ndarray:
    """Pillow's ``Image.resize((width, height), BICUBIC)`` of a uint8 RGB
    image: the horizontal pass first, each pass skipped where the size is
    kept."""
    img = _to_hwc_uint8(image_hwc)
    if img.shape[1] != width:
        img = _resample_axis(img, width, 1)
    if img.shape[0] != height:
        img = _resample_axis(img, height, 0)
    return img


def patchify(frames_tchw: np.ndarray, patch_size: int = 14, temporal_patch_size: int = 2,
             merge_size: int = 2) -> Tuple[np.ndarray, Tuple[int, int, int]]:
    """[T, C, H, W] normalised frames → (flatten patches [t·h·w,
    C·tps·ps·ps], (grid_t, grid_h, grid_w)): token order (t, h/m, w/m, m, m),
    patch vector order (C, tps, ps, ps); an odd frame count repeats the last
    frame."""
    patches = np.asarray(frames_tchw)
    if patches.shape[0] % temporal_patch_size:
        pad = temporal_patch_size - patches.shape[0] % temporal_patch_size
        patches = np.concatenate([patches, np.repeat(patches[-1:], pad, axis=0)], axis=0)
    T, channel, H, W = patches.shape
    ps, tps, m = patch_size, temporal_patch_size, merge_size
    grid_t, grid_h, grid_w = T // tps, H // ps, W // ps
    patches = patches.reshape(grid_t, tps, channel, grid_h // m, m, ps, grid_w // m, m, ps)
    patches = patches.transpose(0, 3, 6, 4, 7, 2, 1, 5, 8)
    return (patches.reshape(grid_t * grid_h * grid_w, channel * tps * ps * ps),
            (grid_t, grid_h, grid_w))


def frames_from_patches(flat: np.ndarray, grid_thw: Sequence[int], patch_size: int = 14,
                        temporal_patch_size: int = 2, merge_size: int = 2) -> np.ndarray:
    """The exact inverse of ``patchify``: flatten patches → dense [T, H, W,
    C] frames, which the tower permutes back into the same patches."""
    grid_t, grid_h, grid_w = (int(g) for g in grid_thw)
    ps, tps, m = patch_size, temporal_patch_size, merge_size
    channel = flat.shape[-1] // (tps * ps * ps)
    x = flat.reshape(grid_t, grid_h // m, grid_w // m, m, m, channel, tps, ps, ps)
    x = x.transpose(0, 6, 5, 1, 3, 7, 2, 4, 8)
    x = x.reshape(grid_t * tps, channel, grid_h * ps, grid_w * ps)
    return x.transpose(0, 2, 3, 1)


class M2OmniImageProcessor:
    """Dynamic-resolution flatten-patch processor (Bailing2ImageProcessor)."""

    def __init__(self, do_resize: bool = True, do_rescale: bool = True,
                 rescale_factor: float = 1.0 / 255.0, do_normalize: bool = True,
                 image_mean: Sequence[float] = OPENAI_CLIP_MEAN,
                 image_std: Sequence[float] = OPENAI_CLIP_STD, min_pixels: int = 56 * 56,
                 max_pixels: int = 28 * 28 * 1280, patch_size: int = 14,
                 temporal_patch_size: int = 2, merge_size: int = 2):
        self.do_resize = do_resize
        self.do_rescale = do_rescale
        self.rescale_factor = rescale_factor
        self.do_normalize = do_normalize
        self.image_mean = np.asarray(image_mean, np.float32)
        self.image_std = np.asarray(image_std, np.float32)
        self.min_pixels = min_pixels
        self.max_pixels = max_pixels
        self.patch_size = patch_size
        self.temporal_patch_size = temporal_patch_size
        self.merge_size = merge_size

    def _preprocess(self, images: Union[Any, Sequence[Any]], do_resize: Optional[bool] = None
                    ) -> Tuple[np.ndarray, Tuple[int, int, int]]:
        """One image or one video's frames → (flatten patches fp32, grid_thw);
        the resize target comes from the first frame."""
        do_resize = self.do_resize if do_resize is None else do_resize
        if isinstance(images, np.ndarray) and images.ndim == 4:
            images = list(images)
        elif not isinstance(images, (list, tuple)):
            images = [images]
        frames = [_to_hwc_uint8(im) for im in images]
        height, width = frames[0].shape[:2]
        if do_resize:
            rh, rw = smart_resize(height, width, factor=self.patch_size * self.merge_size,
                                  min_pixels=self.min_pixels, max_pixels=self.max_pixels)
            frames = [resize_bicubic(f, rh, rw) for f in frames]
        out = []
        for f in frames:
            x = f.astype(np.float32)
            if self.do_rescale:
                x = x * self.rescale_factor
            if self.do_normalize:
                x = (x - self.image_mean) / self.image_std
            out.append(x.transpose(2, 0, 1))
        stack = np.stack(out, axis=0)
        if stack.shape[0] == 1:
            stack = np.tile(stack, (self.temporal_patch_size, 1, 1, 1))
        return patchify(stack, self.patch_size, self.temporal_patch_size, self.merge_size)

    def preprocess(self, images: Any = None, videos: Any = None,
                   do_resize: Optional[bool] = None) -> Dict[str, np.ndarray]:
        """Images → ``{pixel_values, image_grid_thw}``; videos (each a [T, H,
        W, C] array or a frame list) → ``{pixel_values_videos,
        video_grid_thw}``."""
        data: Dict[str, np.ndarray] = {}
        if images is not None:
            if not isinstance(images, (list, tuple)) or (
                    images and isinstance(images[0], (int, float))):
                images = [images]
            pix, grids = zip(*(self._preprocess(im, do_resize) for im in images))
            data["pixel_values"] = np.concatenate(pix, axis=0)
            data["image_grid_thw"] = np.asarray(grids, np.int64)
        if videos is not None:
            if isinstance(videos, np.ndarray) and videos.ndim == 4:
                videos = [videos]
            pix, grids = zip(*(self._preprocess(vid, do_resize) for vid in videos))
            data["pixel_values_videos"] = np.concatenate(pix, axis=0)
            data["video_grid_thw"] = np.asarray(grids, np.int64)
        return data


def sample_frames(num_frames: int, total_frames: int, sample: str = "random",
                  rng: Optional[np.random.Generator] = None) -> List[int]:
    """Frame indices: ``sequence`` = linspace, ``uniform`` = interval
    midpoints, ``random`` = one per interval."""
    if sample == "sequence":
        return list(np.linspace(0, total_frames - 1, num_frames, dtype=int))
    intervals = np.linspace(start=0, stop=total_frames, num=num_frames + 1, dtype=int)
    ranges = [(intervals[i], intervals[i + 1] - 1) for i in range(num_frames)]
    if sample == "random":
        rng = rng or np.random.default_rng()
        try:
            idx = [int(rng.integers(lo, hi)) if hi > lo else int(lo) for lo, hi in ranges]
        except Exception:
            idx = sorted(rng.permutation(total_frames)[:num_frames].tolist())
        if len(idx) < num_frames:
            idx = idx + [idx[-1]] * (num_frames - len(idx))
        return idx
    if sample == "uniform":
        idx = [int((lo + hi) // 2) for lo, hi in ranges]
        if len(idx) < num_frames:
            idx = [idx[int((num_frames - 1) * i / (num_frames - 1) + 0.5)]
                   for i in range(num_frames)]
        return idx
    raise NotImplementedError(sample)


def get_frames(ele: Mapping[str, Any], total_frames: int) -> int:
    """The number of model-input frames of a video."""
    min_frames = ceil_by_factor(FPS_MIN_FRAMES, FRAME_FACTOR)
    max_frames = floor_by_factor(FPS_MAX_FRAMES, FRAME_FACTOR)
    if "nframes" in ele:
        num_frames = min(total_frames, int(ele["nframes"]), max_frames)
    else:
        num_frames = min(total_frames, max_frames)
    return round_by_factor(max(num_frames, min_frames), FRAME_FACTOR)


def _need_cv2(what: str) -> None:
    if cv2 is None:
        raise RuntimeError(f"{what} needs OpenCV (cv2), which is not installed; pass the "
                           f"pixels as an array instead")


def fetch_image(ele: Mapping[str, Any], size_factor: int = IMAGE_FACTOR) -> np.ndarray:
    """Load (a local path or ``file://``, decoded with OpenCV; or an array)
    and smart-resize one image → HWC uint8."""
    image = ele.get("image", ele.get("image_url"))
    if isinstance(image, str):
        _need_cv2(f"reading the image {image!r}")
        path = image[7:] if image.startswith("file://") else image
        bgr = cv2.imread(path, cv2.IMREAD_COLOR)
        if bgr is None:
            raise FileNotFoundError(f"cannot read image {path!r}")
        arr = bgr[:, :, ::-1]
    else:
        arr = _to_hwc_uint8(image)
    if "resized_height" in ele and "resized_width" in ele:
        rh, rw = smart_resize(int(ele["resized_height"]), int(ele["resized_width"]),
                              factor=size_factor)
    else:
        h, w = arr.shape[:2]
        rh, rw = smart_resize(h, w, factor=size_factor,
                              min_pixels=int(ele.get("min_pixels", MIN_PIXELS)),
                              max_pixels=int(ele.get("max_pixels", MAX_PIXELS)))
    return resize_bicubic(arr, rh, rw)


def _read_video_cv2(path: str, ele: Mapping[str, Any]) -> np.ndarray:
    """Decode a video with OpenCV and keep uniformly sampled frames → [T, H,
    W, C] uint8 RGB."""
    _need_cv2(f"reading the video {path!r}")
    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise IOError(f"cannot open video {path}")
    total = int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) or 0
    num_frames = get_frames(ele, max(total, 1))
    want = set(sample_frames(num_frames, max(total, 1), sample="uniform"))
    frames, i = {}, 0
    while cap.grab():
        if i in want:
            ok, frame = cap.retrieve()
            if ok:
                frames[i] = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
        i += 1
    cap.release()
    if not frames:
        raise IOError(f"no frames decoded from {path}")
    last, out = None, []
    for k in sorted(want):
        if k in frames:
            last = frames[k]
        out.append(last if last is not None else next(iter(frames.values())))
    return np.stack(out, axis=0)


def fetch_video(ele: Mapping[str, Any], image_factor: int = IMAGE_FACTOR
                ) -> Union[np.ndarray, List[np.ndarray]]:
    """A video path → resized float frames [T, H, W, C], the per-frame pixel
    budget shrinking with the frame count; a frame list → the fetched
    images, padded to a multiple of FRAME_FACTOR."""
    video = ele["video"]
    if isinstance(video, str):
        path = video[7:] if video.startswith("file://") else video
        frames = _read_video_cv2(path, ele)
        if "resized_height" in ele and "resized_width" in ele:
            rh, rw = smart_resize(int(ele["resized_height"]), int(ele["resized_width"]),
                                  factor=image_factor)
        else:
            nf, h, w = frames.shape[:3]
            max_pixels = max(min(VIDEO_MAX_PIXELS, VIDEO_TOTAL_PIXELS * FRAME_FACTOR // nf),
                             int(VIDEO_MIN_PIXELS * 1.05))
            rh, rw = smart_resize(h, w, factor=28, min_pixels=VIDEO_MIN_PIXELS,
                                  max_pixels=max_pixels)
        return np.stack([resize_bicubic(f, rh, rw) for f in frames], axis=0).astype(np.float32)
    if not isinstance(video, (list, tuple)):
        raise TypeError(f"a video is a path or a list of frames, got {type(video).__name__}")
    info = {k: v for k, v in ele.items() if k not in ("type", "video")}
    images = [fetch_image({"image": v, **info}, size_factor=image_factor) for v in video]
    nframes = ceil_by_factor(len(images), FRAME_FACTOR)
    if len(images) < nframes:
        images.extend([images[-1]] * (nframes - len(images)))
    return images


def load_wav(path: str, sample_rate: int = 16000) -> np.ndarray:
    """PCM wav → float32 mono waveform at ``sample_rate`` (linear resample)."""
    import wave

    with wave.open(path, "rb") as w:
        sr, n, ch, width = w.getframerate(), w.getnframes(), w.getnchannels(), w.getsampwidth()
        raw = w.readframes(n)
    if width == 2:
        data = np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0
    elif width == 4:
        data = np.frombuffer(raw, np.int32).astype(np.float32) / 2147483648.0
    elif width == 1:
        data = (np.frombuffer(raw, np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported wav sample width {width}")
    if ch > 1:
        data = data.reshape(-1, ch).mean(axis=1)
    if sr != sample_rate:
        t_out = np.linspace(0.0, len(data) - 1, int(len(data) * sample_rate / sr))
        data = np.interp(t_out, np.arange(len(data)), data).astype(np.float32)
    return data


def fetch_audio(ele: Mapping[str, Any]) -> np.ndarray:
    """An audio path (a wav) or array → float32 waveform."""
    audio = ele.get("audio", ele.get("audio_url"))
    if isinstance(audio, str):
        path = audio[7:] if audio.startswith("file://") else audio
        return load_wav(path, sample_rate=int(ele.get("sample_rate", 16000)))
    return np.asarray(audio, np.float32)


def extract_vision_info(conversations: Sequence[Any]) -> List[Dict[str, Any]]:
    """The image, video and audio entries of the conversations' contents."""
    infos: List[Dict[str, Any]] = []
    if conversations and isinstance(conversations[0], dict):
        conversations = [conversations]
    for conversation in conversations:
        for message in conversation:
            if isinstance(message.get("content"), list):
                for ele in message["content"]:
                    if ("image" in ele or "image_url" in ele or "video" in ele
                            or ele.get("type") in ("image", "image_url", "video")):
                        infos.append(ele)
                    elif "audio" in ele or "audio_url" in ele:
                        infos.append(ele)
    return infos


def process_vision_info(conversations: Sequence[Any], size_factor: int = IMAGE_FACTOR,
                        min_pixels: Optional[int] = None, max_pixels: Optional[int] = None
                        ) -> Tuple[Optional[List[np.ndarray]], Optional[List[Any]],
                                   Optional[List[np.ndarray]]]:
    """Conversation → (images, videos, audios), each None when empty; the
    pixel bounds default to the reference's."""
    image_inputs: List[np.ndarray] = []
    video_inputs: List[Any] = []
    audio_inputs: List[np.ndarray] = []
    bounds = {}
    if min_pixels is not None:
        bounds["min_pixels"] = int(min_pixels)
    if max_pixels is not None:
        bounds["max_pixels"] = int(max_pixels)
    for info in extract_vision_info(conversations):
        if "image" in info or "image_url" in info:
            img = info.get("image", info.get("image_url"))
            if isinstance(img, (tuple, list)):
                for one in img:
                    image_inputs.append(fetch_image({"type": "image", "image": one, **bounds},
                                                    size_factor=size_factor))
            else:
                image_inputs.append(fetch_image({**bounds, **info}, size_factor=size_factor))
        elif "video" in info or "video_url" in info:
            video_inputs.append(fetch_video(info, image_factor=size_factor))
        elif "audio" in info or "audio_url" in info:
            aud = info.get("audio", info.get("audio_url"))
            if isinstance(aud, (tuple, list)):
                for one in aud:
                    audio_inputs.append(fetch_audio({"type": "audio", "audio": one}))
            else:
                audio_inputs.append(fetch_audio(info))
        else:
            raise ValueError("image, image_url, video, video_url, audio or audio_url "
                             "should in content.")
    return (image_inputs or None, video_inputs or None, audio_inputs or None)


def expand_image_tokens(text: List[str], image_grid_thw: np.ndarray,
                        special_token: str = "<image>", merge_size: int = 2) -> List[str]:
    """Each ``<image>`` in order → ``<image>`` + n × ``<imagePatch>`` +
    ``</image>``, n = prod(grid) / merge²."""
    grids = np.asarray(image_grid_thw).reshape(-1, 3)
    num_query_token = grids.prod(axis=1) // (merge_size * merge_size)
    out, image_index = [], 0
    for sample in text:
        num_images = sample.count(special_token)
        for i in range(image_index, num_images + image_index):
            sample = sample.replace(special_token, DEFAULT_IM_START_TOKEN + int(
                num_query_token[i]) * DEFAULT_IMAGE_PATCH_TOKEN + DEFAULT_IM_END_TOKEN, 1)
        image_index += num_images
        out.append(sample)
    return out


def expand_video_tokens(text: List[str], video_grid_thw: np.ndarray,
                        special_token: str = "<video>", merge_size: int = 2) -> List[str]:
    """``expand_image_tokens`` for ``<video>`` and ``<videoPatch>``."""
    grids = np.asarray(video_grid_thw).reshape(-1, 3)
    num_query_token = grids.prod(axis=1) // (merge_size * merge_size)
    out, video_index = [], 0
    for sample in text:
        num_videos = sample.count(special_token)
        for i in range(video_index, num_videos + video_index):
            sample = sample.replace(special_token, DEFAULT_VID_START_TOKEN + int(
                num_query_token[i]) * DEFAULT_VIDEO_PATCH_TOKEN + DEFAULT_VID_END_TOKEN, 1)
        video_index += num_videos
        out.append(sample)
    return out


def expand_audio_tokens(text: List[str], num_audio_tokens: int = 256,
                        special_token: str = "<audio>") -> List[str]:
    """Every ``<audio>`` → ``<audio>`` + n × ``<audioPatch>`` + ``</audio>``,
    or that run and a newline appended to a text with no marker."""
    audio_text = (DEFAULT_AU_START_TOKEN + num_audio_tokens * DEFAULT_AUDIO_PATCH_TOKEN
                  + DEFAULT_AU_END_TOKEN)
    return [sample.replace(special_token, audio_text) if special_token in sample
            else sample + audio_text + "\n" for sample in text]


def apply_system_template(text: str) -> str:
    """The English or, when the text holds a CJK character, the Chinese
    system prompt in its header."""
    if all(not 0x4E00 <= ord(c) <= 0x9FFF for c in text):
        sys_template = (
            "You are a helpful language, vision and audio assistant. You are "
            "able to understand the visual and audio content that the user "
            "provides, and assist the user with a variety of tasks using "
            "natural language.")
    else:
        sys_template = ("你是一个有帮助的语言,视觉和音频助手。你能理解用户提供的视觉与音"
                        "频内容，并用自然语言帮助用户完成各种任务。")
    return f"<|start_header_id|>system<|end_header_id|>\n\n{sys_template} <|eot_id|>"


def apply_chat_template(conversation: Sequence[Mapping[str, Any]], bos_token: str = "<s>",
                        add_generation_prompt: bool = False) -> str:
    """The reference's ``use_system`` chat template: llama3-style headers,
    ``<image>``/``<video>``/``<audio>`` placeholders inserted for content
    entries the text did not mark, the system prompt in front."""
    text = ""
    for message in conversation:
        text += "<|start_header_id|>" + message["role"] + "<|end_header_id|>\n\n"
        image_counts = str(message["content"]).count("<image>")
        video_counts = str(message["content"]).count("<video>")
        audio_counts = str(message["content"]).count("<audio>")
        for cid, content in enumerate(message["content"]):
            if cid > 0:
                text += "\n"
            if content["type"] == "image":
                img = content["image"]
                num_images = 1 if isinstance(img, (str, np.ndarray)) or \
                    not isinstance(img, (list, tuple)) else len(img)
                if image_counts < num_images:
                    text += ("<image>\n" * (num_images - image_counts)).rstrip("\n")
            elif content["type"] == "video":
                if video_counts > 1:
                    raise ValueError("Video count must be at most 1!")
                if video_counts == 0:
                    text += "<video>"
            elif content["type"] == "audio":
                aud = content["audio"]
                num_audios = 1 if isinstance(aud, str) or \
                    not isinstance(aud, (list, tuple)) else len(aud)
                if audio_counts < num_audios:
                    text += ("<audio>\n" * (num_audios - audio_counts)).rstrip("\n")
            elif content["type"] == "text":
                text += content["text"]
        text += "<|eot_id|>"
    if add_generation_prompt:
        text += "<|start_header_id|>assistant<|end_header_id|>\n\n"
    return bos_token + apply_system_template(text) + text


def encode_with_special_tokens(text: str, tokenize_fn,
                               special_token_ids: Mapping[str, int]) -> List[int]:
    """Split ``text`` on the special-token strings (longest first, so
    ``</image>`` wins over ``<image>``), map those to their ids and tokenise
    the plain segments that are not blank."""
    if not special_token_ids:
        return list(tokenize_fn(text))
    pattern = "|".join(re.escape(t) for t in sorted(special_token_ids, key=len, reverse=True))
    ids: List[int] = []
    pos = 0
    for mobj in re.finditer(pattern, text):
        seg = text[pos:mobj.start()]
        if seg.strip():
            ids.extend(tokenize_fn(seg))
        ids.append(int(special_token_ids[mobj.group(0)]))
        pos = mobj.end()
    if text[pos:].strip():
        ids.extend(tokenize_fn(text[pos:]))
    return ids


# start/end markers beside the patch ids so that a tiny test vocabulary
# works; serving configs set the model's own ids
DEFAULT_SPECIAL_IDS = {
    DEFAULT_IMAGE_PATCH_TOKEN: 1,
    DEFAULT_AUDIO_PATCH_TOKEN: 2,
    DEFAULT_VIDEO_PATCH_TOKEN: 3,
    DEFAULT_IM_START_TOKEN: 4,
    DEFAULT_IM_END_TOKEN: 5,
    DEFAULT_AU_START_TOKEN: 6,
    DEFAULT_AU_END_TOKEN: 7,
    DEFAULT_VID_START_TOKEN: 8,
    DEFAULT_VID_END_TOKEN: 9,
}


@registry.register_processor("m2_omni_processor")
class M2OmniUnifiedProcessor(BaseProcessor):
    """A conversation (role/content list) or a text with ``<image>``/
    ``<video>``/``<audio>`` markers, with ``images``/``image``, ``video`` and
    ``waveform``/``audio`` → ``input_ids``/``input_mask`` padded to the text
    config's ``max_seq_length`` with the patch-token runs in place,
    ``pixel_values`` + ``image_grid_thw`` and ``image_data`` (dense frames a
    image), the video's analogues, and the fbank (``num_audio_tokens``
    placeholders a waveform)."""

    def __init__(self, config: Optional[Mapping[str, Any]] = None, *a, **k):
        super().__init__(config)
        cfg = self.config
        self.text_processor = MaskedTokenProcessor(
            {**dict(cfg.get("text", {})), "mask_probability": 0.0})
        self.max_seq_length = int(dict(cfg.get("text", {})).get("max_seq_length", 128))
        img_cfg = dict(cfg.get("image", {}))
        vid_cfg = dict(cfg.get("video", {}))
        self.image_processor = M2OmniImageProcessor(
            min_pixels=int(img_cfg.get("min_pixels", 78400)),
            max_pixels=int(img_cfg.get("max_pixels", 2007040)),
            patch_size=int(img_cfg.get("patch_size", 14)),
            temporal_patch_size=int(img_cfg.get("temporal_patch_size", 2)),
            merge_size=int(img_cfg.get("merge_size", 2)))
        self.video_processor = M2OmniImageProcessor(
            min_pixels=int(vid_cfg.get("min_pixels", 100352)),
            max_pixels=int(vid_cfg.get("max_pixels", 602112)),
            patch_size=self.image_processor.patch_size,
            temporal_patch_size=self.image_processor.temporal_patch_size,
            merge_size=self.image_processor.merge_size)
        self.audio_processor = SANMAudioProcessor(cfg.get("audio", {}))
        self.num_audio_tokens = int(cfg.get("num_audio_tokens", 256))
        self.special_token_ids = dict(DEFAULT_SPECIAL_IDS)
        self.special_token_ids.update(
            {str(t): int(i) for t, i in dict(cfg.get("special_token_ids", {})).items()})
        self.bos_token = str(cfg.get("bos_token", "<s>"))

    def _tokenize_ids(self, text: str) -> List[int]:
        tok = self.text_processor.tokenizer
        return encode_with_special_tokens(
            text, lambda seg: tok.convert_tokens_to_ids(tok.tokenize(seg)),
            self.special_token_ids)

    def _dense(self, proc: M2OmniImageProcessor, pixels: np.ndarray, grids: np.ndarray):
        return [frames_from_patches(p, g, proc.patch_size, proc.temporal_patch_size,
                                    proc.merge_size) for p, g in _split_by_grid(pixels, grids)]

    def __call__(self, item: Mapping[str, Any], *a, **k) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        if "conversation" in item:
            text = apply_chat_template(item["conversation"], bos_token=self.bos_token,
                                       add_generation_prompt=bool(
                                           item.get("add_generation_prompt", True)))
            ip = self.image_processor
            images, videos, audios = process_vision_info(
                [item["conversation"]], size_factor=ip.patch_size * ip.merge_size,
                min_pixels=ip.min_pixels, max_pixels=ip.max_pixels)
        else:
            text = str(item.get("text", ""))
            images = item.get("images")
            if images is None and item.get("image") is not None:
                images = [item["image"]]
            videos = [item["video"]] if item.get("video") is not None else None
            wav = item.get("waveform", item.get("audio"))
            audios = [np.asarray(wav, np.float32)] if wav is not None else None

        texts = [text]
        m = self.image_processor.merge_size
        if images:
            pix = self.image_processor.preprocess(images=list(images))
            out["pixel_values"] = pix["pixel_values"]
            out["image_grid_thw"] = pix["image_grid_thw"]
            texts = expand_image_tokens(texts, pix["image_grid_thw"], merge_size=m)
            out["image_data"] = self._dense(self.image_processor, pix["pixel_values"],
                                            pix["image_grid_thw"])
        if videos:
            vids = [fetch_video({"video": v}) if isinstance(v, str) else v for v in videos]
            pixv = self.video_processor.preprocess(videos=vids)
            out["pixel_values_videos"] = pixv["pixel_values_videos"]
            out["video_grid_thw"] = pixv["video_grid_thw"]
            texts = expand_video_tokens(texts, pixv["video_grid_thw"], merge_size=m)
            out["video_data"] = self._dense(self.video_processor, pixv["pixel_values_videos"],
                                            pixv["video_grid_thw"])
        if audios:
            texts = expand_audio_tokens(texts, self.num_audio_tokens)
            out.update(self.audio_processor({"waveform": audios[0], "sampling_rate":
                                             item.get("sampling_rate", 16000)}))

        ids = self._tokenize_ids(texts[0])
        L = self.max_seq_length
        n = min(len(ids), L)
        arr = np.zeros(L, np.int64)
        arr[:n] = np.asarray(ids[:n], np.int64)
        mask = np.zeros(L, np.int64)
        mask[:n] = 1
        out["input_ids"] = arr
        out["input_mask"] = mask
        out["text"] = texts[0]
        return out


def _split_by_grid(pixel_values: np.ndarray, grids: np.ndarray):
    """Yield (one item's flatten patches, its grid) from the concatenated rows."""
    off = 0
    for g in np.asarray(grids).reshape(-1, 3):
        n = int(np.prod(g))
        yield pixel_values[off:off + n], g
        off += n
