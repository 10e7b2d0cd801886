"""Text processors: BERT tokenization into fixed-length id arrays.

Own copy of the unmasked path of ``antmmf_tpu/datasets/processors/
text_processors.py``'s ``MaskedTokenProcessor``: ``input_ids`` int64[L] =
[CLS] a [SEP] (b [SEP]) padded with 0, ``input_mask`` 1 on real tokens,
``segment_ids`` 0/1, ``lm_label_ids`` -1 everywhere (no token is a
masked-LM target). Masked-LM target synthesis is not ported: a positive
masking probability raises.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Mapping, Optional

import numpy as np

from antmmf_torch.common.registry import registry
from antmmf_torch.datasets.processors.processors import BaseProcessor
from antmmf_torch.utils.tokenization import CLS_TOKEN, SEP_TOKEN, BertTokenizer

DEFAULT_VOCAB = "tests/data/vocabs/bert-base-uncased_30522_vocab.txt"
LM_IGNORE_INDEX = -1


def _resolve_vocab_path(path: str) -> str:
    """``path`` as given, else under the working directory or the repository
    root (and their ``tests/data``)."""
    if os.path.exists(path):
        return path
    repo_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    for root in (os.getcwd(), os.path.join(os.getcwd(), "tests", "data"),
                 repo_root, os.path.join(repo_root, "tests", "data")):
        cand = os.path.join(root, path)
        if os.path.exists(cand):
            return cand
    raise FileNotFoundError(f"Vocab file not found: {path!r}")


@registry.register_processor("masked_token")
@registry.register_processor("masked_bert_tokenizer")
class MaskedTokenProcessor(BaseProcessor):
    """Tokenize (a, optional b) into BERT input arrays. Only the unmasked
    path is ported: a call whose masking probability (``probability``, else
    the ``mask_probability`` config, default 0.15) is positive raises."""

    def __init__(self, config: Optional[Mapping[str, Any]] = None):
        super().__init__(config)
        cfg = self.config
        self.tokenizer = BertTokenizer(_resolve_vocab_path(cfg.get("vocab_file", DEFAULT_VOCAB)),
                                       do_lower_case=bool(cfg.get("do_lower_case", True)))
        self.max_seq_length = int(cfg.get("max_seq_length", 128))
        self.mask_probability = float(cfg.get("mask_probability", 0.15))

    def __call__(self, item: Mapping[str, Any],
                 probability: Optional[float] = None) -> Dict[str, Any]:
        if (self.mask_probability if probability is None else probability) > 0:
            raise NotImplementedError("masked-LM token masking is not ported yet")
        text_a = item.get("text", item.get("text_a", ""))
        text_b = item.get("text_b", None)
        tokens_a = self.tokenizer.tokenize(text_a)
        tokens_b = self.tokenizer.tokenize(text_b) if text_b else None
        self._truncate(tokens_a, tokens_b)

        tokens = [CLS_TOKEN] + tokens_a + [SEP_TOKEN]
        segment_ids = [0] * len(tokens)
        if tokens_b:
            tokens += tokens_b + [SEP_TOKEN]
            segment_ids += [1] * (len(tokens_b) + 1)
        ids = self.tokenizer.convert_tokens_to_ids(tokens)
        L = self.max_seq_length
        pad = L - len(ids)
        return {
            "input_ids": np.asarray(ids + [0] * pad, dtype=np.int64)[:L],
            "input_mask": np.asarray([1] * len(ids) + [0] * pad, dtype=np.int64)[:L],
            "segment_ids": np.asarray(segment_ids + [0] * pad, dtype=np.int64)[:L],
            "lm_label_ids": np.full((L,), LM_IGNORE_INDEX, dtype=np.int64),
        }

    def _truncate(self, tokens_a: List[str], tokens_b: Optional[List[str]]) -> None:
        """Reserve [CLS] a [SEP] (+ b [SEP]) within ``max_seq_length``."""
        if tokens_b is None:
            del tokens_a[self.max_seq_length - 2:]
            return
        while len(tokens_a) + len(tokens_b) > self.max_seq_length - 3:
            longer = tokens_a if len(tokens_a) >= len(tokens_b) else tokens_b
            longer.pop()
