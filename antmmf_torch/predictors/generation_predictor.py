"""Generation predictor: online text generation for the LLM family.

Port of ``antmmf_tpu/predictors/generation_predictor.py``. The plain branch
renders the conversation prompt, tokenises to ``max_prompt_len``,
normalises the image at the model's ``image_size`` (the ViT or the EVA
tower), runs the model's greedy KV-cache ``generate`` and detokenises. The
``unified_processor`` branch (M2-omni's reference user flow) takes a
request with a ``conversation``, ``images``, a ``video``, a ``waveform`` or
a text with ``<image>``/``<video>``/``<audio>`` markers through the port's
``M2OmniUnifiedProcessor``: the chat template, the dynamic-resolution
resize and the in-place patch-token runs, whose ids (``<imagePatch>``,
``<videoPatch>``, ``<audioPatch>``) are the model's ``image_token_id`` and
``audio_token_id``, so processor and model agree by construction; one image
or one video a request, the video served as ``image_data``; the fbank as
``audio`` and its mask as ``audio_mask``.

The model comes from ``model_dir`` as ``BasePredictor`` loads it: a
trainer's ``save_dir`` or a ``params.npz``, a ``scan_layers`` decoder's
layers stacked or not, or, without one, seeded random weights
(``predictor_parameters.init_on_device`` draws them on the model's
device); the cache stays a list of per-layer tensors (JAX stacks the same
values under ``scan_layers``). ``predictor_parameters.decode_quant: int4 |
int8`` quantises the loaded weights on the model's device
(``quantize_module_for_decode``, the records of ``quantize_for_decode``
byte for byte): int4 records are served by the int4 GEMV kernel, int8
records dequantised at each call (``QuantDense``), for a model whose class
lists the mode in ``DECODE_QUANT`` (Pink and M2-omni list both).

The decoding options are the JAX predictor's: ``num_beams``,
``speculative`` (prompt-lookup draft tokens a step), ``do_sample`` with
``top_p`` and ``temperature``; ``seed`` (an integer, default 0) keys the
port's sampling draw.

``predict({"text": "...", "image": HxWx3?}) →
{"generated_text": str, "generated_ids": int[B, Lp+max_new]}``.

``tensor_parallel`` raises until it is ported.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np

from antmmf_torch.common.registry import registry
from antmmf_torch.datasets.processors.image_processors import NormalizedImageProcessor
from antmmf_torch.datasets.processors.m2omni_processing import M2OmniUnifiedProcessor
from antmmf_torch.datasets.processors.text_processors import DEFAULT_VOCAB, _resolve_vocab_path
from antmmf_torch.predictors.base_predictor import BasePredictor
from antmmf_torch.predictors.caption_predictor import ids_to_caption
from antmmf_torch.predictors.quantization import quantize_module_for_decode
from antmmf_torch.structures.sample import Sample, SampleList
from antmmf_torch.utils.conversation import build_prompt
from antmmf_torch.utils.tokenization import BertTokenizer

DECODE_BITS = {"int8": 8, "int4": 4}


@registry.register_predictor("generation_predictor")
class GenerationPredictor(BasePredictor):
    """Serves a model exposing ``generate(batch, ...)``: Pink over a [vision;
    text] prompt, M2-omni over the unified processor's spliced prompt."""

    NOT_PORTED = {"tensor_parallel": 0}
    UNIFIED_KEYS = ("conversation", "images", "video", "waveform")

    def example_data(self) -> Dict[str, Any]:
        """A request the loaded predictor serves: an image at the unified
        processor's smallest size, or at the model's ``image_size``."""
        if self.unified is not None:
            side = max(int(round(self.unified.image_processor.min_pixels ** 0.5)), 56)
            return {"text": "describe <image>", "images": [np.zeros((side, side, 3), np.uint8)]}
        return {"text": "example", "image": np.zeros((self.image_size, self.image_size, 3),
                                                     np.float32)}

    @staticmethod
    def _model_attributes(config):
        """(the model's name in ``model_attributes``, its attributes)."""
        mc = dict(config.get("model_attributes", None) or {})
        return (list(mc)[0], dict(mc[list(mc)[0]])) if mc else ("", {})

    def _unified_processor(self, cfg: Mapping[str, Any]) -> M2OmniUnifiedProcessor:
        """The processor of the ``unified_processor`` block, with the model's
        splice ids as the patch tokens' ids (a video's patches are spliced at
        the image id)."""
        cfg = dict(cfg)
        model = self._model_attributes(self.config)[1]
        special = dict(cfg.get("special_token_ids", None) or {})
        if model.get("image_token_id") is not None:
            special.setdefault("<imagePatch>", int(model["image_token_id"]))
            special.setdefault("<videoPatch>", int(model["image_token_id"]))
        if model.get("audio_token_id") is not None:
            special.setdefault("<audioPatch>", int(model["audio_token_id"]))
        cfg["special_token_ids"] = special
        return M2OmniUnifiedProcessor(cfg)

    def load(self, with_ckpt: bool = True) -> "GenerationPredictor":
        for key, only in self.NOT_PORTED.items():
            if (self.pp.get(key, only) or only) != only:
                raise NotImplementedError(f"predictor_parameters.{key}={self.pp.get(key)!r} "
                                          f"is not ported yet")
        dq = self.pp.get("decode_quant")
        if dq:
            if str(dq) not in DECODE_BITS:
                raise ValueError(f"decode_quant must be int8|int4, got {dq!r}")
            import antmmf_torch.models  # noqa: F401  (registers the models)

            name, model = self._model_attributes(self.config)
            cls = registry.get_model_class(model.get("model_class", name))
            served = getattr(cls, "DECODE_QUANT", ())
            if str(dq) not in served:
                raise NotImplementedError(
                    f"decode_quant {dq!r} is not ported yet for {cls.__name__}; it serves "
                    f"{', '.join(served) or 'none'}")
        up_cfg = self.pp.get("unified_processor")
        self.unified = self._unified_processor(up_cfg) if up_cfg is not None else None
        self.tokenizer = BertTokenizer(_resolve_vocab_path(
            self.pp.get("vocab_file", DEFAULT_VOCAB)))
        self.template = self.pp.get("template", "vicuna_v1")
        self.max_new_tokens = int(self.pp.get("max_new_tokens", 24))
        self.max_prompt_len = int(self.pp.get("max_prompt_len", 64))
        self.eos_id = int(self.pp.get("eos_id", 102))
        self.decode_options = dict(
            num_beams=int(self.pp.get("num_beams", 1)),
            speculative=int(self.pp.get("speculative", 0)),
            do_sample=bool(self.pp.get("do_sample", False)),
            top_p=float(self.pp.get("top_p", 0.9)),
            temperature=float(self.pp.get("temperature", 1.0)),
            seed=int(self.pp.get("seed", 0)))
        super().load(with_ckpt=with_ckpt)
        module = self.shell.module
        if not hasattr(module, "generate"):
            raise NotImplementedError(f"{type(module).__name__} has no generate()")
        self.image_size = int(self._model_attributes(self.model_config)[1].get("image_size", 224))
        self.image_processor = NormalizedImageProcessor({"size": self.image_size})
        if dq:
            quantize_module_for_decode(module, bits=DECODE_BITS[str(dq)],
                                       min_size=int(self.pp.get("decode_quant_min_size", 65536)))
        return self

    def _build_unified_sample(self, data: Mapping[str, Any]) -> SampleList:
        out = self.unified(dict(data))
        sample = Sample()
        sample["input_ids"] = out["input_ids"]
        sample["input_mask"] = out["input_mask"]
        for key in ("image_data", "video_data"):
            frames = out.get(key)
            if frames:
                if len(frames) != 1:
                    raise ValueError(f"generation_predictor serves one image or video a "
                                     f"request; got {len(frames)} in {key}")
                sample["image_data"] = np.asarray(frames[0], np.float32)
                break
        if "fbank" in out:
            sample["audio"] = np.asarray(out["fbank"], np.float32)
            sample["audio_mask"] = np.asarray(out["fbank_mask"], np.int32)
        return SampleList.from_samples([sample])

    def build_sample(self, data: Mapping[str, Any]) -> SampleList:
        if self.unified is not None and (
                any(k in data for k in self.UNIFIED_KEYS)
                or any(t in str(data.get("text", "")) for t in ("<image>", "<video>", "<audio>"))):
            return self._build_unified_sample(data)
        prompt = build_prompt(str(data.get("text", data.get("caption", ""))), self.template)
        tokens = ["[CLS]"] + self.tokenizer.tokenize(prompt)
        ids = self.tokenizer.convert_tokens_to_ids(tokens[: self.max_prompt_len])
        input_ids = np.zeros((self.max_prompt_len,), np.int64)
        mask = np.zeros((self.max_prompt_len,), np.int64)
        input_ids[: len(ids)] = ids
        mask[: len(ids)] = 1
        sample = Sample()
        sample["input_ids"] = input_ids
        sample["input_mask"] = mask
        img = data.get("image", data.get("image_data"))
        if img is not None:
            sample["image_data"] = self.image_processor.transform_array(
                np.asarray(img, np.float32))
        return SampleList.from_samples([sample])

    def predict(self, data: Mapping[str, Any]) -> Dict[str, Any]:
        batch = self.shell.to_device(self.build_sample(data).arrays())
        tokens, lens = self.shell.module.generate(
            batch, eos_id=self.eos_id, max_length=self.max_new_tokens, **self.decode_options)
        tokens, lens = tokens.cpu().numpy(), lens.cpu().numpy()
        outs = [ids_to_caption(self.tokenizer, tokens[b, lens[b]: lens[b] + self.max_new_tokens])
                for b in range(tokens.shape[0])]
        return {"generated_text": outs[0] if len(outs) == 1 else outs, "generated_ids": tokens}
