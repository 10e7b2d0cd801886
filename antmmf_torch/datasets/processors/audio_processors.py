"""Audio processors: waveform → SANM-style log-mel fbank + LFR + CMVN.

Own copy of ``antmmf_tpu/datasets/processors/audio_processors.py`` (pure
numpy): a 16 kHz waveform → 80-bin log-mel filterbank with Kaldi semantics
(25 ms Hamming window, 10 ms hop, DC removal, pre-emphasis 0.97, power
spectrum, log with a float-eps floor, on the ×32768 waveform) → low frame
rate stacking (7 frames, stride 6) → per-utterance CMVN or, given a
``mean_std_file``, the Bailing inverse normalisation → padded to
``max_frames`` with a validity mask. ``m2_omni_simple`` is the simplified
processor that prefixes fixed-count placeholder ids to the text.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np

from antmmf_torch.common.registry import registry
from antmmf_torch.datasets.processors.processors import BaseProcessor


def hz_to_mel(f):
    """Kaldi mel scale: 1127 · ln(1 + f/700)."""
    return 1127.0 * np.log(1.0 + np.asarray(f, np.float64) / 700.0)


def mel_to_hz(m):
    return 700.0 * (np.exp(np.asarray(m, np.float64) / 1127.0) - 1.0)


def mel_filterbank(n_mels: int, n_fft: int, sr: int, fmin: float = 20.0,
                   fmax: Optional[float] = None) -> np.ndarray:
    """[n_mels, n_fft//2+1] Kaldi triangular filters, weighted in mel space at
    each FFT bin's centre frequency (no rounding to bins, no area
    normalisation)."""
    fmax = fmax or sr / 2.0
    mel_pts = np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2)
    bin_mels = hz_to_mel(np.arange(n_fft // 2 + 1) * (sr / n_fft))
    left, center, right = (mel_pts[:-2][:, None], mel_pts[1:-1][:, None],
                           mel_pts[2:][:, None])
    up = (bin_mels[None] - left) / (center - left)
    down = (right - bin_mels[None]) / (right - center)
    return np.maximum(0.0, np.minimum(up, down)).astype(np.float32)


def log_mel_fbank(waveform: np.ndarray, sr: int = 16000, n_mels: int = 80,
                  win_ms: float = 25.0, hop_ms: float = 10.0, preemphasis: float = 0.97,
                  remove_dc: bool = True, up_sample: bool = False) -> np.ndarray:
    """[T] float waveform → [frames, n_mels] log-mel features, Kaldi's
    ``fbank`` with snip_edges, a Hamming window, no dither."""
    waveform = np.asarray(waveform, np.float64)
    if up_sample:
        waveform = waveform * 32768.0
    win = int(sr * win_ms / 1000)
    hop = int(sr * hop_ms / 1000)
    n_fft = 1 << (win - 1).bit_length()
    if len(waveform) < win:
        waveform = np.pad(waveform, (0, win - len(waveform)))
    n_frames = 1 + (len(waveform) - win) // hop
    frames = waveform[np.arange(win)[None, :] + hop * np.arange(n_frames)[:, None]]
    if remove_dc:
        frames = frames - frames.mean(axis=1, keepdims=True)
    if preemphasis:
        frames = frames - preemphasis * np.concatenate([frames[:, :1], frames[:, :-1]], axis=1)
    frames = frames * np.hamming(win)[None, :]
    spec = np.abs(np.fft.rfft(frames, n_fft, axis=-1)) ** 2
    mel = spec @ mel_filterbank(n_mels, n_fft, sr).T
    return np.log(np.maximum(mel, np.finfo(np.float32).eps)).astype(np.float32)


def apply_lfr(feats: np.ndarray, m: int = 7, n: int = 6) -> np.ndarray:
    """Low frame rate: m consecutive frames concatenated, stride n, the first
    frame repeated (m − 1) // 2 times in front, the tail padded with the
    last frame."""
    T, _ = feats.shape
    x = np.concatenate([np.repeat(feats[:1], (m - 1) // 2, axis=0), feats], axis=0)
    rows = []
    for i in range(int(np.ceil(T / n))):
        chunk = x[i * n: i * n + m]
        if len(chunk) < m:
            chunk = np.concatenate([chunk, np.repeat(chunk[-1:], m - len(chunk), axis=0)])
        rows.append(chunk.reshape(-1))
    return np.stack(rows).astype(np.float32)


def apply_cmvn(feats: np.ndarray) -> np.ndarray:
    """Per-utterance cepstral mean and variance normalisation."""
    mu = feats.mean(axis=0, keepdims=True)
    sd = feats.std(axis=0, keepdims=True)
    return ((feats - mu) / np.maximum(sd, 1e-6)).astype(np.float32)


def de_normalize(feats: np.ndarray, mean: np.ndarray, std: np.ndarray) -> np.ndarray:
    """The inverse global CMVN ``(x + mean) · std`` of the Bailing checkpoints."""
    dim = feats.shape[-1]
    mean = np.asarray(mean, np.float32)[:dim]
    std = np.asarray(std, np.float32)[:dim]
    return ((feats + mean) * std).astype(np.float32)


@registry.register_processor("sanm_audio")
@registry.register_processor("audio_fbank")
class SANMAudioProcessor(BaseProcessor):
    """{'waveform': float[T] (+'sampling_rate')} → {'fbank': f32[max_frames,
    n_mels·lfr_m], 'fbank_mask': int64[max_frames], 'num_frames'}."""

    def __init__(self, config: Optional[Mapping[str, Any]] = None, *a, **k):
        super().__init__(config)
        cfg = self.config
        self.sr = int(cfg.get("sampling_rate", 16000))
        self.n_mels = int(cfg.get("n_mels", 80))
        self.lfr_m = int(cfg.get("lfr_m", 7))
        self.lfr_n = int(cfg.get("lfr_n", 6))
        self.max_frames = int(cfg.get("max_frames", 256))
        self.cmvn = bool(cfg.get("cmvn", True))
        self.up_sample = bool(cfg.get("up_sample", True))
        self.mean_std = None
        path = cfg.get("mean_std_file")
        if path:
            data = np.load(path)
            self.mean_std = (np.asarray(data["mean"], np.float32),
                             np.asarray(data["std"], np.float32))

    def __call__(self, item: Mapping[str, Any], *a, **k) -> Dict[str, Any]:
        wav = np.asarray(item["waveform"], np.float32).reshape(-1)
        feats = log_mel_fbank(wav, int(item.get("sampling_rate", self.sr)), self.n_mels,
                              up_sample=self.up_sample)
        feats = apply_lfr(feats, self.lfr_m, self.lfr_n)
        if self.mean_std is not None:
            feats = de_normalize(feats, *self.mean_std)
        elif self.cmvn:
            feats = apply_cmvn(feats)
        T, D = feats.shape
        out = np.zeros((self.max_frames, D), np.float32)
        n = min(T, self.max_frames)
        out[:n] = feats[:n]
        mask = np.zeros((self.max_frames,), np.int64)
        mask[:n] = 1
        return {"fbank": out, "fbank_mask": mask, "num_frames": np.int64(n)}


@registry.register_processor("m2_omni_simple")
class M2OmniProcessor(BaseProcessor):
    """The simplified M2-omni processor: a text with ``<image>``/``<audio>``
    markers and the image/waveform → ``num_image_tokens`` /
    ``num_audio_tokens`` placeholder ids prefixed to the tokenised text
    (markers removed), the normalised image and the fbank."""

    IMAGE_TOKEN = "<image>"
    AUDIO_TOKEN = "<audio>"

    def __init__(self, config: Optional[Mapping[str, Any]] = None, *a, **k):
        super().__init__(config)
        from antmmf_torch.datasets.processors.image_processors import NormalizedImageProcessor
        from antmmf_torch.datasets.processors.text_processors import MaskedTokenProcessor

        cfg = self.config
        self.image_processor = NormalizedImageProcessor(cfg.get("image", {"size": 224}))
        self.audio_processor = SANMAudioProcessor(cfg.get("audio", {}))
        self.text_processor = MaskedTokenProcessor(
            {**dict(cfg.get("text", {})), "mask_probability": 0.0})
        self.num_image_tokens = int(cfg.get("num_image_tokens", 49))
        self.num_audio_tokens = int(cfg.get("num_audio_tokens", 64))
        self.image_token_id = int(cfg.get("image_token_id", 1))
        self.audio_token_id = int(cfg.get("audio_token_id", 2))

    def __call__(self, item: Mapping[str, Any], *a, **k) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        text = str(item.get("text", ""))
        has_image = self.IMAGE_TOKEN in text and "image" in item
        has_audio = self.AUDIO_TOKEN in text and "waveform" in item
        clean = text.replace(self.IMAGE_TOKEN, " ").replace(self.AUDIO_TOKEN, " ")
        enc = self.text_processor({"text": clean}, probability=0.0)
        ids = enc["input_ids"]
        prefix = []
        if has_image:
            prefix += [self.image_token_id] * self.num_image_tokens
        if has_audio:
            prefix += [self.audio_token_id] * self.num_audio_tokens
        full = np.concatenate([np.asarray(prefix, np.int64), ids])[: len(ids) + len(prefix)]
        out["input_ids"] = full
        mask = np.concatenate([np.ones(len(prefix), np.int64), enc["input_mask"]])
        out["input_mask"] = mask[: len(full)]
        out["text"] = text
        if has_image:
            out["image_data"] = self.image_processor.transform_array(np.asarray(item["image"]))
        if has_audio:
            out.update(self.audio_processor(item))
        return out
