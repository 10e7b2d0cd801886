"""Online-serving predictors.

Port of ``antmmf_tpu/predictors/base_predictor.py:27-167``: ``load()`` builds
the model with seeded random weights (seed 0; drawn on the CPU, or on the
model's device with ``predictor_parameters.init_on_device``, which takes a
fraction of the time at billions of parameters) and, given a ``model_dir``,
loads its weights (a ``config.yaml`` there replaces the config): a
trainer's ``save_dir`` in the JAX predictor's order (``*_final``, then
``models/best``, then the newest ``models/model_<n>``), or a ``params.npz``
of flax parameter paths (``utils/weights.py``); ``common.checkpoint.
find_weights`` and ``load_weights``.
``predict`` runs processors → Sample → batch → forward → formatted result;
``BatchPredictor.predict_batch`` answers many requests with one forward.
The model runs on ``predictor_parameters.device`` (default ``cuda``; without
CUDA that raises, the CPU is used only when asked for).
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Mapping

import numpy as np

from antmmf_torch.common.configuration import Configuration, convert_to_config
from antmmf_torch.common.registry import registry
from antmmf_torch.datasets.processors.processors import build_processors
from antmmf_torch.structures.sample import Sample, SampleList


@registry.register_predictor("base_predictor")
class BasePredictor:
    def __init__(self, config: Mapping):
        self.config = convert_to_config(config)
        self.pp = self.config.get("predictor_parameters", None) or {}
        self.shell = None
        self.processors: Dict[str, Any] = {}

    # -------------------------------------------------------------------- load
    def load(self, with_ckpt: bool = True) -> "BasePredictor":
        from antmmf_torch.common.checkpoint import find_weights, load_weights
        from antmmf_torch.models.base_model import build_model

        model_dir = self.pp.get("model_dir")
        cfg = self.config
        if model_dir and os.path.exists(os.path.join(model_dir, "config.yaml")):
            cfg = Configuration.from_file(os.path.join(model_dir, "config.yaml"))
        self.model_config = cfg
        self.shell = build_model(cfg, device=self.pp.get("device", "cuda"))
        # a checkpoint overwrites every parameter: its init is drawn on the
        # device, as it is when predictor_parameters.init_on_device asks
        self.shell.init(on_device=bool(with_ckpt and model_dir)
                        or bool(self.pp.get("init_on_device", False)))
        if with_ckpt and model_dir:
            load_weights(self.shell.module, find_weights(model_dir))
        self.processors = build_processors(self.pp.get("processors", (
            cfg.get("predictor_parameters", None) or {}).get("processors", {})))
        return self

    # ----------------------------------------------------------------- predict
    def build_sample(self, data: Mapping[str, Any]) -> SampleList:
        """data → processors → Sample → single-element batch."""
        sample = Sample()
        if "image_data" in data:
            sample["image_data"] = np.asarray(data["image_data"], np.float32)
            sample["video_mask"] = np.ones((sample["image_data"].shape[0],), np.int64)
        for name, proc in self.processors.items():
            field = name.replace("_processor", "")
            if field in data or "text" in data or "caption" in data:
                src = data.get(field, data.get("caption", data.get("text")))
                out = proc({"text": src} if isinstance(src, str) else src)
                if isinstance(out, Mapping):
                    prefix = "caption_" if field in ("caption", "text") else ""
                    for k, v in out.items():
                        if isinstance(v, np.ndarray):
                            sample[f"{prefix}{k}"] = v
        if "caption_input_ids" not in sample and ("caption" in data or "text" in data):
            if not hasattr(self, "_fallback_text_proc"):
                from antmmf_torch.datasets.processors.text_processors import (
                    DEFAULT_VOCAB, MaskedTokenProcessor)

                self._fallback_text_proc = MaskedTokenProcessor(
                    {"vocab_file": DEFAULT_VOCAB, "max_seq_length": 30})
            out = self._fallback_text_proc(
                {"text": data.get("caption", data.get("text"))}, probability=0.0)
            for k in ("input_ids", "input_mask", "segment_ids"):
                sample[f"caption_{k}"] = out[k]
        return SampleList.from_samples([sample])

    def forward(self, arrays: Mapping[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """One forward on the model's device; outputs back on the host."""
        out = self.shell.apply(arrays)
        return {k: v.float().cpu().numpy() for k, v in out.items()}

    def predict(self, data: Mapping[str, Any]) -> Dict[str, Any]:
        return self.format_result(self.forward(self.build_sample(data).arrays()))

    def format_result(self, output: Mapping[str, Any]) -> Dict[str, Any]:
        result = {}
        for key in ("logits", "sim", "text_embed", "visual_embed", "scores"):
            if key in output:
                result[key] = np.asarray(output[key]).tolist()
        return result or {k: np.asarray(v).tolist() for k, v in output.items()}


@registry.register_predictor("batch_predictor")
class BatchPredictor(BasePredictor):
    """Batches many requests into one forward."""

    def predict_batch(self, datas: List[Mapping[str, Any]]) -> List[Dict[str, Any]]:
        samples = [self.build_sample(d) for d in datas]
        merged = SampleList.from_samples([
            Sample({k: v[0] for k, v in s.items()}) for s in samples])
        out = self.forward(merged.arrays())
        results = []
        for i in range(len(datas)):
            results.append({k: v[i].tolist() if v.ndim >= 1 and v.shape[0] == len(datas)
                            else v.tolist() for k, v in out.items()})
        return results
