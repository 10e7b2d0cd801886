"""Generation predictor: online text generation for the LLM family.

Port of ``antmmf_tpu/predictors/generation_predictor.py`` on its plain
branch: render the conversation prompt, tokenise to ``max_prompt_len``,
normalise the image at the model's ``image_size`` (the ViT or the EVA
tower), run the model's greedy KV-cache ``generate`` and detokenise. The
model comes from ``model_dir`` as ``BasePredictor`` loads it: a trainer's
``save_dir`` or a ``params.npz``, a ``scan_layers`` decoder's layers stacked
or not; the cache stays a list of per-layer tensors (JAX stacks the same
values under ``scan_layers``). ``predictor_parameters.decode_quant: int4`` quantises the loaded
weights with ``quantize_for_decode(bits=4)`` and serves them through the
int4 GEMV kernel (``QuantDense`` packed buffers).

``predict({"text": "...", "image": HxWx3?}) →
{"generated_text": str, "generated_ids": int[B, Lp+max_new]}``.

Beams, sampling, speculative decoding, ``decode_quant: int8``,
``tensor_parallel`` and the ``unified_processor`` branch raise until they are
ported.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np

from antmmf_torch.common.registry import registry
from antmmf_torch.datasets.processors.image_processors import NormalizedImageProcessor
from antmmf_torch.datasets.processors.text_processors import DEFAULT_VOCAB, _resolve_vocab_path
from antmmf_torch.predictors.base_predictor import BasePredictor
from antmmf_torch.predictors.caption_predictor import ids_to_caption
from antmmf_torch.predictors.quantization import load_decode_records, quantize_for_decode
from antmmf_torch.structures.sample import Sample, SampleList
from antmmf_torch.utils.conversation import build_prompt
from antmmf_torch.utils.tokenization import BertTokenizer
from antmmf_torch.utils.weights import export_flax_params


@registry.register_predictor("generation_predictor")
class GenerationPredictor(BasePredictor):
    """Serves a model exposing ``generate(batch, ...)`` over a [vision; text]
    prompt: Pink."""

    NOT_PORTED = {"num_beams": 1, "speculative": 0, "do_sample": False, "tensor_parallel": 0,
                  "unified_processor": None}

    def load(self, with_ckpt: bool = True) -> "GenerationPredictor":
        for key, only in self.NOT_PORTED.items():
            if (self.pp.get(key, only) or only) != only:
                raise NotImplementedError(f"predictor_parameters.{key}={self.pp.get(key)!r} "
                                          f"is not ported yet")
        dq = self.pp.get("decode_quant")
        if dq and str(dq) != "int4":
            raise NotImplementedError(f"decode_quant {dq!r} is not ported yet; only int4 is")
        self.tokenizer = BertTokenizer(_resolve_vocab_path(
            self.pp.get("vocab_file", DEFAULT_VOCAB)))
        self.template = self.pp.get("template", "vicuna_v1")
        self.max_new_tokens = int(self.pp.get("max_new_tokens", 24))
        self.max_prompt_len = int(self.pp.get("max_prompt_len", 64))
        self.eos_id = int(self.pp.get("eos_id", 102))
        super().load(with_ckpt=with_ckpt)
        module = self.shell.module
        if not hasattr(module, "generate"):
            raise NotImplementedError(f"{type(module).__name__} has no generate()")
        mc = dict(self.model_config.get("model_attributes", None) or {})
        size = int(dict(mc[list(mc)[0]]).get("image_size", 224)) if mc else 224
        self.image_processor = NormalizedImageProcessor({"size": size})
        if dq:
            records = quantize_for_decode(
                {"params": export_flax_params(module, stacked=False)}, bits=4,
                min_size=int(self.pp.get("decode_quant_min_size", 65536)))
            load_decode_records(module, records, module.dtype)
        return self

    def build_sample(self, data: Mapping[str, Any]) -> SampleList:
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
            batch, eos_id=self.eos_id, max_length=self.max_new_tokens)
        tokens, lens = tokens.cpu().numpy(), lens.cpu().numpy()
        outs = [ids_to_caption(self.tokenizer, tokens[b, lens[b]: lens[b] + self.max_new_tokens])
                for b in range(tokens.shape[0])]
        return {"generated_text": outs[0] if len(outs) == 1 else outs, "generated_ids": tokens}
