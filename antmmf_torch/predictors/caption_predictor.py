"""Caption predictor: online caption generation by beam search.

Port of ``antmmf_tpu/predictors/caption_predictor.py``: serves a
``univl_caption`` model, frames in ({"image_data": float[F, H, W, 3]},
normalised as the model takes them) → ``generate`` with the KV caches
(``predictor_parameters.num_beams``, default 4; ``max_length``, default the
model's ``max_caption_len``) → {"caption": str, "generated_ids": int[B, T],
"scores": f32[B]}. ``ids_to_caption`` stops at [SEP] or [PAD], drops [CLS]
and joins wordpieces (the reference's ``convert_id2text``).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

from antmmf_torch.common.registry import registry
from antmmf_torch.datasets.processors.text_processors import DEFAULT_VOCAB, _resolve_vocab_path
from antmmf_torch.predictors.base_predictor import BasePredictor
from antmmf_torch.utils.tokenization import BertTokenizer


def ids_to_caption(tokenizer, ids) -> str:
    """[SEP]-terminated wordpiece ids → text."""
    tokens = tokenizer.convert_ids_to_tokens([int(t) for t in ids])
    for stop in ("[SEP]", "[PAD]"):
        if stop in tokens:
            tokens = tokens[: tokens.index(stop)]
    tokens = [t for t in tokens if t != "[CLS]"]
    return " ".join(tokens).replace(" ##", "").strip("##").strip()


@registry.register_predictor("caption_predictor")
class CaptionPredictor(BasePredictor):
    """predict({"image_data": ...}) → {"caption", "generated_ids", "scores"}."""

    def load(self, with_ckpt: bool = True) -> "CaptionPredictor":
        super().load(with_ckpt=with_ckpt)
        if not hasattr(self.shell.module, "generate"):
            raise NotImplementedError(
                f"{type(self.shell.module).__name__} has no generate(); caption serving "
                "needs a generation-capable model (univl_caption)")
        self.tokenizer = BertTokenizer(_resolve_vocab_path(self.pp.get("vocab_file",
                                                                       DEFAULT_VOCAB)))
        self.num_beams = int(self.pp.get("num_beams", 4))
        self.max_length = self.pp.get("max_length")
        return self

    def predict(self, data: Mapping[str, Any]) -> Dict[str, Any]:
        batch = self.shell.to_device(self.build_sample(data).arrays())
        ids, scores = self.shell.module.generate(batch, num_beams=self.num_beams,
                                                 max_length=self.max_length)
        ids = ids.cpu().numpy()
        captions = [ids_to_caption(self.tokenizer, row) for row in ids]
        return {"generated_ids": ids,
                "caption": captions[0] if len(captions) == 1 else captions,
                "scores": scores.float().cpu().numpy()}
